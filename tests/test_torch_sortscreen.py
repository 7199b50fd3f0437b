"""The port's sort screen (ops/sortscreen.py) against JAX's, exactly.

Same codes into both packages (the reference's K3 in interpret mode):
the two run histograms, the packed class words (the reference's d = 0
pre-rolled copy is the flat word table), and the screen scores at every
position, scored or not, with the counted total.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmer_spans_tpu.ops import sortscreen as ref
from kmer_spans_tpu_torch.ops import sortscreen
from kmer_spans_tpu_torch.ops.blocked import blocked_codes, blocked_scored
from kmer_spans_tpu_torch.ops.pmscreen import sorted_runs

from conftest import random_seq

BLOCK = 512
THR_Q = 3071  # screen_thr_q(0.75)


def _plant(seq, spans):
    s = list(seq)
    for beg, unit, reps in spans:
        s[beg:beg + len(unit) * reps] = unit * reps
    return "".join(s)


def _codes(seq, k):
    """(codes int32 [n], kmer_valid, scored) of seq padded with N."""
    raw = np.frombuffer(seq.encode(), np.uint8)
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACTG"):  # the reference's 2-bit order
        lut[c] = i
    n = -(-raw.size // BLOCK) * BLOCK
    arr = np.full(n, 4, np.uint8)
    arr[:raw.size] = lut[raw]
    t = torch.from_numpy(arr)
    b2 = (t & 3).reshape(-1, BLOCK)
    v2 = (t < 4).reshape(-1, BLOCK)
    codes, kv = blocked_codes(b2, v2, k)
    scored = blocked_scored(v2, kv)
    return codes.reshape(-1), kv.reshape(-1), scored.reshape(-1)


def _cases():
    rng = np.random.default_rng(5)
    planted = _plant(random_seq(rng, 30_000, n_prob=0.003),
                     [(4000, "AG", 300), (12000, "CCTGA", 130),
                      (21000, "T", 700)])
    return {
        "planted": planted,
        "all_invalid": "N" * 4000,
        "one_kmer": "A" * 6000,
    }


CASES = _cases()


def _ref_inputs(codes, kv, k):
    skey, spos, head, v, real = sorted_runs(codes, kv, k)
    hb = (skey >> (2 * k - 8)) & 255
    return v, hb, head, real


@pytest.mark.parametrize("case,k,vmax", [
    ("planted", 10, ref.VMAX), ("planted", 11, ref.VMAX),
    ("planted", 12, ref.VMAX), ("planted", 14, ref.VMAX),
    ("planted", 10, 64), ("all_invalid", 12, ref.VMAX),
    ("one_kmer", 12, ref.VMAX), ("one_kmer", 11, 64),
])
def test_sort_screen_matches_jax(case, k, vmax):
    codes, kv, scored = _codes(CASES[case], k)
    v2 = min(ref.V2, vmax)
    v, hb, head, real = _ref_inputs(codes, kv, k)
    mask = head & real
    # the two run histograms (K3 twice)
    got_h = sortscreen.rank_ub_histograms(v, hb, mask, vmax, v2)
    want_h = ref.rank_ub_histograms(jnp.asarray(v.numpy()),
                                    jnp.asarray(hb.numpy()),
                                    jnp.asarray(mask.numpy()), vmax, v2)
    for g, w in zip(got_h, want_h):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the class words: the reference's d = 0 pre-rolled copy
    total = kv.sum(dtype=torch.int32)
    words = sortscreen.rank_ub_tables(*got_h, total, vmax, v2)
    tabR = ref.rank_ub_tables(*want_h, jnp.int32(int(total)), vmax, v2)
    assert words.dtype == torch.int32
    assert words.numel() == vmax // 8 + v2 * 32
    assert np.array_equal(
        words.numpy(), np.asarray(tabR[0]).reshape(-1)[:words.numel()])
    # the scores at every position, and the total
    thr_q = torch.tensor(THR_Q, dtype=torch.int32)
    s_int, tot = sortscreen.sort_screen_scores(codes, kv, scored, k, thr_q,
                                               vmax=vmax)
    want_s, want_t = ref.sort_screen_scores(
        jnp.asarray(codes.numpy()), jnp.asarray(kv.numpy()),
        jnp.asarray(scored.numpy()), k, jnp.int32(THR_Q), vmax=vmax)
    assert s_int.dtype == torch.int32 and tot.dtype == torch.int32
    assert np.array_equal(s_int.numpy(), np.asarray(want_s))
    assert int(tot) == int(want_t) == int(kv.sum())


def test_sort_screen_rejects_bad_arguments():
    codes, kv, scored = _codes(CASES["planted"][:2048], 10)
    thr_q = torch.tensor(THR_Q, dtype=torch.int32)
    for k in (3, 16):
        with pytest.raises(ValueError):
            sortscreen.sort_screen_scores(codes, kv, scored, k, thr_q)
    with pytest.raises(ValueError):
        sortscreen.sort_screen_scores(codes, kv, scored, 10, thr_q, vmax=60)


@pytest.mark.parametrize("vmax", [64, ref.VMAX])
def test_sort_screen_sound_upper_bound(vmax):
    """s_int >= 4096 * (rank - thr) at every scored position, with the
    exact f64 rank chain of the codes' own spectrum; at vmax = 64 the
    repeat islands' runs fall in the clipped bucket."""
    from kmer_spans_tpu_torch.spans.finish import host_rank_chain

    k, thr = 10, 0.6
    seq = _plant(CASES["planted"], [(2000, "A", 2000), (9000, "AG", 500)])
    codes, kv, scored = _codes(seq, k)
    thr_q = torch.floor(torch.tensor(thr, dtype=torch.float32) * 4096).to(
        torch.int32) - 1
    s_int, total = sortscreen.sort_screen_scores(codes, kv, scored, k, thr_q,
                                                 vmax=vmax)
    c = codes.numpy().astype(np.int64)
    counts = np.bincount(c[kv.numpy()], minlength=1 << (2 * k))
    ranks = host_rank_chain(counts, int(total))
    sc = scored.numpy()
    assert np.all(s_int.numpy()[sc] >= 4096 * (ranks[c[sc]] - thr))
