"""The port's k <= 8 span pipeline against JAX's make_span_pipeline and the
sequential oracle.

Device outputs (dict and packed) must equal the reference's element for
element on the same nbases: sizes are chosen so that every partial sum of
the reference's f32 block composition is an integer below 2^24
(asserted), where it equals the port's exact int64 one and both pick the
same top-C blocks.  Regions from
finish_spans must equal the oracle's rank chain exactly: positions and
f64 scores.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmer_spans_tpu.encoding import pack
from kmer_spans_tpu.oracle import count_spectrum, find_regions, weighted_ranks
from kmer_spans_tpu.spans.pipeline import make_span_pipeline as jax_pipeline
from kmer_spans_tpu_torch.ops.blocked import SCREEN_NEG
from kmer_spans_tpu_torch.spans.finish import finish_spans, unpack_outputs
from kmer_spans_tpu_torch.spans.pipeline import make_span_pipeline

from conftest import random_seq


def _nbases(seq, block):
    p = pack(seq)
    n = -(-p.n // block) * block
    arr = np.full(n, 4, np.uint8)
    arr[:p.n] = np.where(p.valid, p.bases, 4)
    return arr


def _chain_rank_regions(seq, k, thr, min_w, min_s):
    """The reference's sequential f64 rank chain (SURVEY A.2)."""
    counts, n = count_spectrum(seq, k)
    return find_regions(seq, 0, min_w, min_s, weighted_ranks(counts, float(n)),
                        k, thr)


def _run(seq, k, thr, min_w, min_s, block=1024, cand=32):
    arr = _nbases(seq, block)
    fn = make_span_pipeline(k, block=block, cand_blocks=cand, device="cpu")
    out = {key: v.numpy() for key, v in fn(arr, thr).items()}
    return finish_spans(out, arr.shape[0], thr, min_w, min_s, block=block)


def _f32_exact(out):
    sent = SCREEN_NEG // 2
    tA, tB, maxA, maxB = (np.asarray(out[key]).astype(np.int64)
                          for key in ("tA", "tB", "maxA", "maxB"))
    return (np.abs(tA).sum() + np.abs(tB[tB > sent]).max(initial=0)
            + np.abs(maxA).max() + np.abs(maxB[maxB > sent]).max(initial=0)
            ) < 1 << 24


@pytest.mark.parametrize("k,class_bits", [(4, 4), (6, 4), (8, 4), (8, 2)])
def test_outputs_match_jax(k, class_bits):
    rng = np.random.default_rng(99 + k)
    s = list(random_seq(rng, 12 * 1024, n_prob=0.002))
    s[3000:3500] = "AG" * 250
    s[7000:9100] = "TTAGGC" * 350  # across blocks
    arr = _nbases("".join(s), 1024)
    kw = dict(block=1024, cand_blocks=5, class_bits=class_bits)
    thr = 0.75
    want = {key: np.asarray(v) for key, v in jax_pipeline(k, **kw)(
        jnp.asarray(arr), jnp.float32(thr)).items()}
    assert _f32_exact(want)
    got = make_span_pipeline(k, device="cpu", **kw)(arr, thr)
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(got[key].numpy(), want[key]), key
    assert got["counts"].dtype == torch.int32
    fn_p = make_span_pipeline(k, packed=True, device="cpu", **kw)
    want_p = np.asarray(jax_pipeline(k, packed=True, **kw)(
        jnp.asarray(arr), jnp.float32(thr)))
    got_p = fn_p(torch.from_numpy(arr), torch.tensor(thr))
    assert got_p.dtype == torch.int32
    assert np.array_equal(got_p.numpy(), want_p)
    # the packed vector decodes to the dict outputs
    dec = unpack_outputs(got_p.numpy(), k, arr.shape[0], 1024, 5,
                         packed_bases=fn_p.packed_bases)
    for key in ("counts", "tA", "tB", "maxA", "maxB", "top_idx", "scored"):
        assert np.array_equal(dec[key], want[key]), key
    sc = want["scored"]
    assert np.array_equal(dec["codes"][sc], want["codes"][sc])


@pytest.mark.parametrize("seed", range(5))
def test_regions_match_oracle(seed):
    rng = np.random.default_rng(seed)
    s = list(random_seq(rng, 40_000, n_prob=0.005))
    s[5000:5400] = "AG" * 200
    s[22000:22600] = "CCT" * 200
    seq = "".join(s)
    k, thr, min_w, min_s = 4, 0.75, 30, 5.0
    res = _run(seq, k, thr, min_w, min_s)
    assert not res.fallback
    expect = _chain_rank_regions(seq, k, thr, min_w, min_s)
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]  # f64 scores bit-identical


def test_no_candidates():
    rng = np.random.default_rng(9)
    res = _run(random_seq(rng, 8_000), 4, 0.75, 100, 1000.0)
    assert res.regions == [] and not res.fallback


def test_overflow_flags_fallback():
    # many candidate blocks, capacity 2
    seq = ("AG" * 600 + "ACGTTACG" * 100) * 12
    res = _run(seq, 4, 0.3, 5, 0.5, cand=2)
    assert res.fallback and res.regions == []


@pytest.mark.parametrize("k", [4, 6, 8])
def test_island_across_blocks(k):
    rng = np.random.default_rng(11)
    s = list(random_seq(rng, 16_000))
    s[3000:5100] = "TTAGGC" * 350  # spans several 1024-blocks
    seq = "".join(s)
    res = _run(seq, k, 0.75, 50, 5.0)
    assert not res.fallback and len(res.regions) >= 1
    expect = _chain_rank_regions(seq, k, 0.75, 50, 5.0)
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]


def test_unported_branches_raise():
    for kw in (dict(k=9), dict(k=3), dict(k=12), dict(k=8, block=512),
               dict(k=8, screen="sort"), dict(k=8, screen="fine")):
        with pytest.raises(NotImplementedError):
            make_span_pipeline(device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        make_span_pipeline(8, block=1100, device="cpu")


def test_bad_inputs_raise():
    fn = make_span_pipeline(4, block=1024, device="cpu")
    with pytest.raises(ValueError):
        fn(np.zeros(1500, np.uint8), 0.75)
    with pytest.raises(TypeError):
        fn(np.zeros(1024, np.int32), 0.75)
