"""The port's host finishers against their originals and the oracle.

kmer_spans_tpu_torch/spans/finish.py copies the host code of
kmer_spans_tpu/spans/pipeline.py (which cannot be imported without JAX),
folding every candidate stretch in the port's host library
(kmer_spans_tpu_torch/utils/native.py).  Every copy gets the same inputs
as its original and must give the same result; the rank chain and the
finished regions are held to the port's sequential oracle too.
"""

import numpy as np
import pytest

from kmer_spans_tpu.spans import pipeline as ref
from kmer_spans_tpu_torch import oracle
from kmer_spans_tpu_torch.spans import extract, finish
from kmer_spans_tpu_torch.spans.pipeline import make_span_pipeline

from conftest import random_seq


@pytest.fixture(params=["jax", "oracle"])
def reference(request):
    """What the port's answer is held to: the JAX package's copy, or the
    port's sequential oracle."""
    return request.param


def _nbases(seq, block):
    from kmer_spans_tpu.encoding import pack

    p = pack(seq)
    n = -(-p.n // block) * block
    arr = np.full(n, 4, np.uint8)
    arr[:p.n] = np.where(p.valid, p.bases, 4)
    return arr


def _genome(seed):
    rng = np.random.default_rng(seed)
    s = list(random_seq(rng, 30_000, n_prob=0.003))
    s[6000:6700] = "AG" * 350
    s[15000:15090] = "N" * 90
    s[15100:15700] = "CCT" * 200
    return "".join(s)


def _packed_vector(k, seed, block=1024, cand=16):
    arr = _nbases(_genome(seed), block)
    fn = make_span_pipeline(k, block=block, cand_blocks=cand, packed=True,
                            device="cpu")
    return fn(arr, 0.72).numpy(), arr.shape[0], block, cand


def test_host_rank_mass():
    """The reference's host_rank_mass is the port's cumulative_mass."""
    from kmer_spans_tpu_torch.stats.ranks import cumulative_mass

    rng = np.random.default_rng(0)
    counts = rng.integers(0, 9, 4096)
    assert np.array_equal(cumulative_mass(counts),
                          ref.host_rank_mass(counts))


@pytest.mark.parametrize("size,hi", [(4096, 40), (4096, 70000),
                                     (1 << 16, 5), (1 << 20, 300)])
def test_host_rank_chain(size, hi, reference):
    """The numpy chain below 2^20 entries, the library's from 2^20."""
    rng = np.random.default_rng(size + hi)
    counts = rng.integers(0, hi, size).astype(np.int64)
    counts[rng.integers(0, size, 17)] = 0
    total = int(counts.sum())
    got = finish.host_rank_chain(counts, total)
    want = (ref.host_rank_chain(counts, total) if reference == "jax"
            else oracle.weighted_ranks(counts, total))
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("x0", [0, 5000])
def test_compose_summaries_exact(x0):
    rng = np.random.default_rng(x0)
    nb = 300
    tA = rng.integers(-2_000_000, 500_000, nb).astype(np.int32)
    tB = rng.integers(0, 3_000_000, nb).astype(np.int32)
    maxA = rng.integers(-100_000, 3_000_000, nb).astype(np.int32)
    maxB = rng.integers(0, 3_000_000, nb).astype(np.int32)
    none = rng.random(nb) < 0.1  # blocks with no scored position
    tB[none] = tA[none] - (1 << 30)
    maxB[none] = maxA[none] - (1 << 30)
    for g, w in zip(finish.compose_summaries_exact(tA, tB, maxA, maxB, x0),
                    ref.compose_summaries_exact(tA, tB, maxA, maxB, x0)):
        assert g.dtype == np.int64 and np.array_equal(g, w)


@pytest.mark.parametrize("k", [4, 8])
def test_rebuild_codes(k):
    rng = np.random.default_rng(k)
    block = 1024
    cw = rng.integers(0, 1 << 32, (5, 1 + block // 16), dtype=np.uint64)
    cw = cw.astype(np.uint32)
    assert np.array_equal(finish.rebuild_codes(cw, k, block),
                          ref.rebuild_codes(cw, k, block))


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("k", [4, 8])
def test_unpack_outputs(k, lazy):
    vec, n, block, cand = _packed_vector(k, seed=k)
    got = finish.unpack_outputs(vec, k, n, block, cand, packed_bases=True,
                                lazy_codes=lazy)
    want = ref.unpack_outputs(vec, k, n, block, cand, packed_bases=True,
                              lazy_codes=lazy)
    assert got.keys() == want.keys()
    for key in want:
        if want[key] is None:
            assert got[key] is None, key
        else:
            assert np.array_equal(np.asarray(got[key]),
                                  np.asarray(want[key])), key


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("k", [4, 6, 8])
def test_finish_spans(k, lazy, reference):
    """Codes rebuilt on the host (lazy=False) fold through
    extract_spans; packed bases (lazy=True) through the library's packed
    replay."""
    vec, n, block, cand = _packed_vector(k, seed=10 + k)
    out = ref.unpack_outputs(vec, k, n, block, cand, packed_bases=True,
                             lazy_codes=lazy)
    got = finish.finish_spans(out, n, 0.72, 30, 5.0, block=block)
    if reference == "jax":
        want = ref.finish_spans(out, n, 0.72, 30, 5.0, block=block).regions
    else:
        seq = _genome(10 + k)
        counts, total = oracle.count_spectrum(seq, k)
        assert np.array_equal(out["counts"], counts)
        want = oracle.find_regions(seq, 0, 30, 5.0,
                                   oracle.weighted_ranks(counts, total), k,
                                   0.72)
    assert got.regions == want
    assert len(got.regions) >= 2 and not got.fallback
    # overflow: a capacity too small for the candidate runs
    small = dict(out, top_idx=out["top_idx"][:1])
    got = finish.finish_spans(small, n, 0.72, 30, 5.0, block=block)
    want = ref.finish_spans(small, n, 0.72, 30, 5.0, block=block)
    assert got.fallback and want.fallback and got.regions == want.regions


def test_replay_stretch():
    """One assembled stretch folded at its place in the sequence:
    extract_spans with base_pos, the original's _replay_stretch."""
    rng = np.random.default_rng(4)
    s = rng.normal(-0.05, 0.3, 20_000)
    s[3000:3800] += 0.4
    scored = rng.random(20_000) < 0.97
    got = extract.extract_spans(s, scored, 30, 5.0, seq_id=2,
                                base_pos=4096)
    assert got == ref._replay_stretch(s, scored, 4096, 30, 5.0, 2)
    assert got and all(r[0] == 2 for r in got)
