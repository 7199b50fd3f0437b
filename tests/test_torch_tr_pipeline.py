"""The port's transition-score pipeline against the JAX package's.

spans/tr_pipeline.py on the CPU against kmer_spans_tpu/spans/tr_pipeline.py
(JAX on the CPU) and the sequential oracle, on the same seeded inputs.

The block summaries are held to this rule.  The reference scans a block
with jax.lax.associative_scan of a combine whose a-part is floored at
SCREEN_NEG; that combine is not associative, so an a-part after a reset
(a seed or an N) is whatever the scan's tree made it, and the port
computes the prefix in a closed form instead.  So:
  * tB and maxB must equal the reference's exactly;
  * tA and maxA must equal it exactly where the reference's value exceeds
    SCREEN_NEG // 2, and both must be at or below SCREEN_NEG // 2
    elsewhere;
  * runstats' (lead, maxrun, tail), the candidate mask and every region
    with its f64 score must equal exactly (positivity of max(x + A, B)
    cannot see the floored values, since x <= 2^27).
At min_length == 0 the port is held against the oracle, not against the
reference's device path, which leaves out the oracle's end-of-sequence
abandon.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_spans_tpu.oracle import find_tr_regions as ref_find_tr_regions
from kmer_spans_tpu.spans import tr_pipeline as ref_tr
from kmer_spans_tpu.spans.pipeline import compose_summaries_exact
from kmer_spans_tpu_torch.encoding import kmer_to_code, pack
from kmer_spans_tpu_torch.ops.blocked import SCREEN_NEG
from kmer_spans_tpu_torch.oracle import find_tr_regions
from kmer_spans_tpu_torch.spans import tr_pipeline as tr
from kmer_spans_tpu_torch.utils import native

from conftest import random_seq

SENT = SCREEN_NEG // 2


def _tables(k, cpg_seed=2.0, cpg_trans=2.0, other_seed=-1.0,
            other_trans=-0.5):
    size = 1 << (2 * k)
    ks = np.full(size, other_seed)
    ts = np.full(size, other_trans)
    ks[kmer_to_code("CG")] = cpg_seed
    ts[kmer_to_code("CG")] = cpg_trans
    return ks, ts


def _arr(seq, block):
    p = pack(seq)
    npad = -(-p.n // block) * block
    arr = np.full(npad, 4, np.uint8)
    arr[: p.n] = np.where(p.valid, p.bases, 4)
    return p, arr


def _run(seq, k, ks, ts, min_len, block=512, cand=32, seq_len=None):
    p, arr = _arr(seq, block)
    ks_q, ts_q, _ = tr.quantize_tr_tables(ks, ts, block)
    pipe = tr.make_tr_pipeline(k, block=block, cand_blocks=cand,
                               device="cpu")
    nb = torch.from_numpy(arr)
    out = pipe.summaries(nb, ks_q, ts_q)
    return tr.finish_tr_spans(out, arr.size, min_len, ks, ts, block=block,
                              seq_id=1, pipe=pipe, nbases_dev=nb,
                              ks_q_dev=ks_q, ts_q_dev=ts_q, seq_len=seq_len)


def _ref_run(seq, k, ks, ts, min_len, block=512, cand=32):
    p, arr = _arr(seq, block)
    ks_q, ts_q, _ = ref_tr.quantize_tr_tables(ks, ts, block)
    pipe = ref_tr.make_tr_pipeline(k, block=block, cand_blocks=cand)
    dev = jnp.asarray(arr)
    kq, tq = jnp.asarray(ks_q), jnp.asarray(ts_q)
    out = pipe.summaries(dev, kq, tq)
    return ref_tr.finish_tr_spans(out, arr.size, min_len, ks, ts,
                                  block=block, seq_id=1, pipe=pipe,
                                  nbases_dev=dev, ks_q_dev=kq, ts_q_dev=tq,
                                  cand_blocks=cand)


def _islands(seed, n=20_000, at=(400, 3900, 8100, 15000)):
    rng = np.random.default_rng(seed)
    s = list(random_seq(rng, n, n_prob=0.01))
    for pos in at:
        s[pos: pos + 120] = "CG" * 60
    return "".join(s)


# ------------------------------------------------------------ the screen

@pytest.mark.parametrize("scale", [1e-3, 0.5, 2.0, 7e5])
def test_quantize_tr_tables_equal_jax(scale):
    rng = np.random.default_rng(int(scale * 1000) % 97)
    ks = rng.normal(0, scale, 256)
    ts = rng.normal(-0.1 * scale, scale, 256)
    for block in (512, 8192):
        got = tr.quantize_tr_tables(ks, ts, block)
        want = ref_tr.quantize_tr_tables(ks, ts, block)
        assert got[2] == want[2]
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype == np.int32 and np.array_equal(g, w)
    zeros = tr.quantize_tr_tables(np.zeros(16), np.zeros(16), 512)
    assert zeros[2] == 1.0 and (zeros[0] == 2).all()


def _summaries_case(seed, k, block=512, halo=None):
    rng = np.random.default_rng(seed)
    n = 24 * block
    arr = rng.integers(0, 4, n).astype(np.uint8)
    arr[12 * block:][rng.random(n - 12 * block) < 0.01] = 4
    arr[3 * block:4 * block] = 4           # a block of N
    arr[6 * block + 5:6 * block + 9] = 4   # seeds inside a block
    arr[9 * block:9 * block + 300] = 1     # a long extension stretch
    size = 1 << (2 * k)
    ks = rng.normal(0.2, 1.0, size)
    ts = rng.normal(-0.1, 1.0, size)
    ks_q, ts_q, _ = tr.quantize_tr_tables(ks, ts, block)
    pipe = tr.make_tr_pipeline(k, block=block, device="cpu")
    ref = ref_tr.make_tr_pipeline(k, block=block)
    h = None if halo is None else np.asarray(halo, np.uint8)
    got = pipe.summaries(torch.from_numpy(arr), ks_q, ts_q, h)
    want = ref.summaries(jnp.asarray(arr), jnp.asarray(ks_q),
                         jnp.asarray(ts_q),
                         None if h is None else jnp.asarray(h))
    got = {kk: v.numpy() for kk, v in got.items()}
    want = {kk: np.asarray(v) for kk, v in want.items()}
    return arr, ks_q, ts_q, pipe, ref, got, want


@pytest.mark.parametrize("k,halo", [(1, None), (2, None), (3, None),
                                    (3, [0, 4, 2])])
def test_summaries_equal_jax_under_the_neg_rule(k, halo):
    arr, ks_q, ts_q, pipe, ref, got, want = _summaries_case(k, k, halo=halo)
    for kk in ("tB", "maxB"):
        assert got[kk].dtype == np.int32
        assert np.array_equal(got[kk], want[kk]), kk
    for kk in ("tA", "maxA"):
        exact = want[kk] > SENT
        assert np.array_equal(got[kk][exact], want[kk][exact]), kk
        assert (got[kk][~exact] <= SENT).all(), kk
        assert exact.any() and (~exact).any()
    # the composed bounds are equal, hence runstats at the same states
    bl_got = compose_summaries_exact(got["tA"], got["tB"], got["maxA"],
                                     got["maxB"])[1]
    bl_want = compose_summaries_exact(want["tA"], want["tB"], want["maxA"],
                                      want["maxB"])[1]
    assert np.array_equal(bl_got, bl_want)
    x_in = np.concatenate([[0], bl_want[:-1]])
    x32 = np.clip(x_in, 0, 1 << 27).astype(np.int32)
    h = None if halo is None else np.asarray(halo, np.uint8)
    rs = pipe.runstats(torch.from_numpy(arr), ks_q, ts_q,
                       torch.from_numpy(x32), h)
    rs_want = ref.runstats(jnp.asarray(arr), jnp.asarray(ks_q),
                           jnp.asarray(ts_q), jnp.asarray(x32),
                           None if h is None else jnp.asarray(h))
    for g, w in zip(rs, rs_want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # pulled rows equal the reference's
    idx = np.array([0, 3, 6, 9, 23, 23], np.int32)
    for g, w in zip(pipe.pull(torch.from_numpy(arr), torch.from_numpy(idx), h),
                    ref.pull(jnp.asarray(arr), jnp.asarray(idx),
                             None if h is None else jnp.asarray(h))):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_runstats_at_large_states_equal_jax():
    """x up to the 2^27 clamp: every block positive, runs across blocks."""
    arr, ks_q, ts_q, pipe, ref, _, _ = _summaries_case(7, 2)
    rng = np.random.default_rng(7)
    x32 = rng.choice([0, 1, 5000, 1 << 20, 1 << 27], arr.size // 512)
    x32 = x32.astype(np.int32)
    got = pipe.runstats(torch.from_numpy(arr), ks_q, ts_q,
                        torch.from_numpy(x32))
    want = ref.runstats(jnp.asarray(arr), jnp.asarray(ks_q),
                        jnp.asarray(ts_q), jnp.asarray(x32))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_row_groups_equal_one_group(monkeypatch):
    arr, ks_q, ts_q, pipe, _, whole, _ = _summaries_case(9, 3)
    monkeypatch.setattr(tr, "_GROUP", 5 * 512)
    got = pipe.summaries(torch.from_numpy(arr), ks_q, ts_q)
    for kk in whole:
        assert np.array_equal(got[kk].numpy(), whole[kk]), kk


# ------------------------------------------------------------ the regions

def test_cpg_vector():
    seq = "ATATATATCGCGCGCGCGCGATATATATATATATATCGCGCG"
    ks, ts = _tables(2)
    res = _run(seq, 2, ks, ts, 4)
    assert not res.fallback
    assert res.regions == find_tr_regions(seq, 1, 2, ks, ts, 4)
    assert res.regions == _ref_run(seq, 2, ks, ts, 4).regions
    assert res.regions[0][1:] == (10, 20, 9.5)


@pytest.mark.parametrize("seed", range(4))
def test_random_equal_jax_and_oracle(seed):
    seq = _islands(30 + seed)
    ks, ts = _tables(2)
    res = _run(seq, 2, ks, ts, 20)
    want = _ref_run(seq, 2, ks, ts, 20)
    assert not res.fallback and not want.fallback
    assert res.regions == want.regions  # positions and f64 scores ==
    assert res.regions == find_tr_regions(seq, 1, 2, ks, ts, 20)
    assert len(res.regions) >= 4


def test_screen_sound_at_f32_knife_edge():
    """Transitions alternate -0.5 / +0.5 + 1e-9: an f32 screen rounds the
    1e-9 away and loses the region; the integer screen keeps it."""
    k = 2
    eps = 1e-9
    ks = np.full(16, -1.0)
    ts = np.full(16, -1.0)
    ks[kmer_to_code("CG")] = 0.5 + eps
    ts[kmer_to_code("CG")] = 0.5 + eps
    ts[kmer_to_code("GC")] = -0.5
    bg = random_seq(np.random.default_rng(99), 3000)
    seq = bg[:1500] + "CG" * 400 + bg[1500:]
    res = _run(seq, k, ks, ts, 100)
    expect = find_tr_regions(seq, 1, k, ks, ts, 100)
    assert len(expect) >= 1
    assert res.regions == expect == _ref_run(seq, k, ks, ts, 100).regions


@pytest.mark.parametrize("seed", range(3))
def test_stream_equals_oracle_oneshot_and_jax(seed):
    """Chunks with k-byte halos, one int64 composition, batched pulls:
    equal to the oracle, the one-shot path and the JAX stream, with
    islands across chunk edges."""
    rng = np.random.default_rng(60 + seed)
    s = list(random_seq(rng, 30_000, n_prob=0.008))
    for pos in (4060, 8150, 12270, 20470):
        s[pos: pos + 120] = "CG" * 60
    seq = "".join(s)
    ks, ts = _tables(2)
    p = pack(seq)
    nb = np.where(p.valid, p.bases, 4).astype(np.uint8)
    res = tr.stream_tr_regions(nb, 2, ks, ts, 20, seq_id=1, chunk=4096,
                               block=512, cand_blocks=4, device="cpu")
    assert not res.fallback and res.pull_batches >= 2
    assert sorted(res.regions) == sorted(find_tr_regions(seq, 1, 2, ks, ts,
                                                         20))
    assert sorted(res.regions) == sorted(_run(seq, 2, ks, ts, 20,
                                              cand=128).regions)
    want = ref_tr.stream_tr_regions(nb, 2, ks, ts, 20, seq_id=1, chunk=4096,
                                    block=512, cand_blocks=4)
    assert res.regions == want.regions
    assert len(res.regions) >= 4


def test_capacity_pulls_in_batches_where_jax_falls_back():
    seq = _islands(5, n=40_000, at=(400, 3900, 8100, 15000, 22000, 30500,
                                    37000))
    ks, ts = _tables(2)
    want = _ref_run(seq, 2, ks, ts, 20, cand=2)
    assert want.fallback and not want.regions
    res = _run(seq, 2, ks, ts, 20, cand=2)
    assert not res.fallback and res.pull_batches >= 3
    oracle = find_tr_regions(seq, 1, 2, ks, ts, 20)
    assert res.regions == oracle and len(oracle) >= 7
    assert res.regions == _ref_run(seq, 2, ks, ts, 20, cand=128).regions


def test_min_length_zero_equals_the_oracle():
    """A short last N-free stretch whose seed ends within 2 bytes of the
    sequence end: the oracle abandons it, the reference's device path
    emits a region there; the port, given the length, is the oracle."""
    k = 2
    ks = np.full(16, 1.0)
    ts = np.full(16, -0.5)
    rng = np.random.default_rng(12)
    for tail, departs in (("NCG", True), ("NCGA", True), ("NCGAT", False)):
        seq = random_seq(rng, 3000, n_prob=0.02) + tail
        want = find_tr_regions(seq, 1, k, ks, ts, 0)
        got = _run(seq, k, ks, ts, 0, seq_len=len(seq)).regions
        assert got == want, tail
        assert len(want) > 10
        # the reference's device path departs from the oracle where the
        # last seed ends within 2 bytes of the end; without the length,
        # the port's replay is that path
        jax_regions = _ref_run(seq, k, ks, ts, 0).regions
        assert (jax_regions != want) == departs, tail
        assert _run(seq, k, ks, ts, 0).regions == jax_regions


@pytest.mark.parametrize("seed", range(2))
def test_min_length_zero_random_equals_the_oracle(seed):
    rng = np.random.default_rng(40 + seed)
    seq = random_seq(rng, 8000, n_prob=0.03)
    ks = rng.normal(0.3, 1.0, 64)
    ts = rng.normal(-0.2, 1.0, 64)
    want = find_tr_regions(seq, 1, 3, ks, ts, 0)
    assert _run(seq, 3, ks, ts, 0, seq_len=len(seq)).regions == want
    p = pack(seq)
    nb = np.where(p.valid, p.bases, 4).astype(np.uint8)
    assert tr.stream_tr_regions(nb, 3, ks, ts, 0, chunk=2048, block=512,
                                device="cpu").regions == want


def _replay_inputs(seed):
    rng = np.random.default_rng(seed)
    seq = random_seq(rng, 4000, n_prob=0.02)
    s = list(seq)
    s[1000:1100] = "CG" * 50
    p = pack("".join(s))
    k = 2
    codes = np.zeros(p.n, np.int32)
    for j in range(k):
        codes[k - 1:] |= (p.bases[j:p.n - k + 1 + j].astype(np.int32)
                          << (2 * (k - 1 - j)))
    kv = np.zeros(p.n, bool)
    kv[k - 1:] = np.convolve(p.valid, np.ones(k), "valid") == k
    prev_k = np.zeros(p.n, bool)
    prev_k[k:] = p.valid[:-k]
    seed_m = kv & ~prev_k
    return p, codes, seed_m, kv & ~seed_m


@pytest.mark.parametrize("seed", range(3))
def test_replay_copies_equal(seed):
    """The host library's replay (replay_tr, the port's one) equals the
    reference's replay_tr_segment; given the sequence length (which the
    reference's replay does not take) it is the oracle, the reference's
    and the port's."""
    ks, ts = _tables(2)
    p, codes, seed_m, ext = _replay_inputs(seed)
    args = (ks[codes], ts[codes], seed_m, ext, 0, 10, 1)
    want = ref_tr.replay_tr_segment(*args)
    beg, end, sc = native.replay_tr(codes, seed_m, ext, ks, ts, 0, 10)
    assert [(1, int(b), int(e), float(v)) for b, e, v in
            zip(beg, end, sc)] == want and want
    seq = "".join("ACTGN"[b] if v else "N" for b, v in zip(p.bases, p.valid))
    want = find_tr_regions(seq, 1, 2, ks, ts, 0)
    assert want == ref_find_tr_regions(seq, 1, 2, ks, ts, 0)
    beg, end, sc = native.replay_tr(codes, seed_m, ext, ks, ts, 0, 0, p.n)
    assert [(1, int(b), int(e), float(v)) for b, e, v in
            zip(beg, end, sc)] == want


def test_regions_without_the_host_library(monkeypatch, tmp_path):
    """The replay needs the host library: where it does not build, the
    finish raises RuntimeError, after the device steps; with it, the
    regions are the oracle's."""
    seq = _islands(2)
    ks, ts = _tables(2)
    assert _run(seq, 2, ks, ts, 20).regions == \
        find_tr_regions(seq, 1, 2, ks, ts, 20)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="host library"):
        _run(seq, 2, ks, ts, 20)


@pytest.mark.parametrize("k", [2, 8])
def test_find_tr_regions_copy_equals_the_reference(k):
    seq = _islands(k, n=12_000)
    rng = np.random.default_rng(k)
    ks = rng.normal(-0.2, 1.0, 1 << (2 * k))
    ts = rng.normal(-0.1, 1.0, 1 << (2 * k))
    ks[kmer_to_code("CG" * (k // 2))] = 3.0
    ts[kmer_to_code("CG" * (k // 2))] = 2.0
    ts[kmer_to_code("GC" * (k // 2))] = 2.0
    for min_len in (0, 20):
        got = find_tr_regions(seq, 2, k, ks, ts, min_len)
        assert got == ref_find_tr_regions(seq, 2, k, ks, ts, min_len)
        assert got
