"""The port's wide codes (16 <= k <= 23) against the JAX package and the
sparse oracle: int64 codes against JAX's (hi, lo) pairs, the wide pm and
sort screens, both packed vectors, the host finishers, the sparse
spectrum counted on the device, and the regions against the sequential
oracle with a SparseRanks lookup (positions and f64 scores ==).

JAX's K3 and K4 run in interpret mode on the CPU; the port's wrappers run
their plain versions here.  Every comparison is exact.  Where JAX's f32
block composition is exact (asserted) the whole packed vector must be
equal, its top C included.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmer_spans_tpu.ops import pmscreen as ref_pmscreen
from kmer_spans_tpu.ops import sortscreen as ref_sortscreen
from kmer_spans_tpu.ops.blocked import blocked_codes_wide as jax_codes_wide
from kmer_spans_tpu.oracle import count_spectrum_sparse, find_regions
from kmer_spans_tpu.spans import pipeline as ref_pipeline
from kmer_spans_tpu.spans import pm_pipeline as ref_pm
from kmer_spans_tpu.stats.ranks import SparseRanks
from kmer_spans_tpu_torch.ops import pmscreen, sortscreen
from kmer_spans_tpu_torch.ops.blocked import (
    WIDE_MAX_K,
    blocked_codes_wide,
)
from kmer_spans_tpu_torch.parallel.device import device_sparse_spectrum
from kmer_spans_tpu_torch.spans import finish, pm_finish
from kmer_spans_tpu_torch.spans.pipeline import make_wide_span_pipeline
from kmer_spans_tpu_torch.spans.pm_pipeline import make_wide_pm_pipeline

from conftest import random_seq
from test_pm_pipeline import _arr, _plant
from test_torch_span_pipeline import _f32_exact

BLOCK = 1024
THR_Q = 3071  # screen_thr_q(0.75)
WIDE_KS = [16, 17, 23]


def _genome(seed, n=60_000):
    rng = np.random.default_rng(seed)
    return _plant(random_seq(rng, n, n_prob=0.003),
                  [(9000, "AG", 400), (30000, "GATTACA", 160),
                   (47000, "T", 600)])


def _small(seed):
    """12 blocks: JAX's f32 block composition stays exact (asserted)."""
    rng = np.random.default_rng(seed)
    return _plant(random_seq(rng, 12_000, n_prob=0.003),
                  [(2000, "AG", 300), (7000, "CCTGA", 130)])


def _codes(arr, k):
    """(port int64 codes, port kmer_valid, JAX hi, lo, kmer_valid), flat."""
    b2 = arr.reshape(-1, BLOCK)
    codes, kv = blocked_codes_wide(torch.from_numpy(b2 & 3),
                                   torch.from_numpy(b2 < 4), k)
    hi, lo, jkv = jax_codes_wide(jnp.asarray(b2 & 3).astype(jnp.int32),
                                 jnp.asarray(b2 < 4), k)
    return (codes.reshape(-1), kv.reshape(-1), hi.reshape(-1),
            lo.reshape(-1), jkv.reshape(-1))


# ------------------------------------------------------- codes

@pytest.mark.parametrize("k", WIDE_KS)
def test_codes_equal_the_pair_codes(k):
    """(hi << 16) | lo at every position, the junk of invalid ones too,
    and with a halo seeded before row 0."""
    arr, _ = _arr(_genome(k, 20_000), BLOCK)
    codes, kv, hi, lo, jkv = _codes(arr, k)
    pair = (np.asarray(hi, np.int64) << 16) | np.asarray(lo, np.int64)
    assert codes.dtype == torch.int64
    assert np.array_equal(codes.numpy(), pair)
    assert np.array_equal(kv.numpy(), np.asarray(jkv))
    assert (~kv).any() and (codes[~kv] != 0).any()  # junk compared too
    rng = np.random.default_rng(k)
    fb = rng.integers(0, 4, k - 1).astype(np.int32)
    fv = rng.random(k - 1) < 0.9
    b2 = arr.reshape(-1, BLOCK)
    got, gkv = blocked_codes_wide(torch.from_numpy(b2 & 3),
                                  torch.from_numpy(b2 < 4), k,
                                  first_bases=torch.from_numpy(fb),
                                  first_valid=torch.from_numpy(fv))
    hi, lo, jkv = jax_codes_wide(jnp.asarray(b2 & 3).astype(jnp.int32),
                                 jnp.asarray(b2 < 4), k,
                                 first_bases=jnp.asarray(fb),
                                 first_valid=jnp.asarray(fv))
    pair = (np.asarray(hi, np.int64) << 16) | np.asarray(lo, np.int64)
    assert np.array_equal(got.numpy(), pair)
    assert np.array_equal(gkv.numpy(), np.asarray(jkv))


def test_codes_refuse_narrow_and_too_wide_k():
    x = torch.zeros((2, 64), dtype=torch.uint8)
    for k in (15, WIDE_MAX_K + 1):
        with pytest.raises(ValueError):
            blocked_codes_wide(x, x < 4, k)
    assert WIDE_MAX_K == 23


@pytest.mark.parametrize("k", WIDE_KS)
def test_device_sparse_spectrum_equals_the_oracle(k):
    seq = _genome(k)
    arr, _ = _arr(seq, BLOCK)
    ucodes, ucounts, n_words = device_sparse_spectrum(arr, k, device="cpu")
    want = count_spectrum_sparse(seq, k)
    assert n_words == want[2]
    assert ucodes.dtype == ucounts.dtype == np.int64
    assert np.array_equal(ucodes, want[0])
    assert np.array_equal(ucounts, want[1])
    empty = device_sparse_spectrum(np.full(4096, 4, np.uint8), k, "cpu")
    assert empty[0].size == empty[1].size == empty[2] == 0


# ------------------------------------------------------- the screens

@pytest.mark.parametrize("list_cap", [None, 3])
@pytest.mark.parametrize("k", WIDE_KS)
def test_pm_screen_wide_equals_jax(k, list_cap):
    arr, _ = _arr(_genome(100 + k), BLOCK)
    codes, kv, hi, lo, jkv = _codes(arr, k)
    got = pmscreen.pm_sort_screen_wide(codes, kv, k, list_cap=list_cap)
    want = ref_pmscreen.pm_sort_screen_wide(hi, lo, jkv, k,
                                            list_cap=list_cap)
    assert list(got) == list(want)
    assert got["t_list"] == want["t_list"] == 4
    for key in want:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
        if key != "t_list":
            assert got[key].dtype == torch.int32, key
    assert int(got["list_count"]) > 0  # the planted repeats are listed
    if list_cap:
        assert int(got["list_count"]) > list_cap


@pytest.mark.parametrize("vmax", [sortscreen.VMAX, 64])
@pytest.mark.parametrize("k", WIDE_KS)
def test_sort_screen_wide_equals_jax(k, vmax):
    """Scores at every position, scored or not, and the total."""
    arr, _ = _arr(_genome(200 + k), BLOCK)
    codes, kv, hi, lo, jkv = _codes(arr, k)
    s, total = sortscreen.sort_screen_scores_wide(
        codes, kv, k, torch.tensor(THR_Q, dtype=torch.int32), vmax=vmax)
    ws, wtotal = ref_sortscreen.sort_screen_scores_wide(
        hi, lo, jkv, k, jnp.int32(THR_Q), vmax=vmax)
    assert s.dtype == torch.int32
    assert np.array_equal(s.numpy(), np.asarray(ws))
    assert int(total) == int(wtotal) == int(kv.sum())


def test_screens_refuse_narrow_k():
    x = torch.zeros(64, dtype=torch.int64)
    with pytest.raises(ValueError):
        pmscreen.pm_sort_screen_wide(x, x == 0, 15)
    with pytest.raises(ValueError):
        sortscreen.sort_screen_scores_wide(x, x == 0, 15,
                                           torch.tensor(THR_Q))


# ------------------------------------------------------- packed vectors

@pytest.mark.parametrize("k", WIDE_KS)
def test_pm_vector_equals_jax(k):
    arr, n = _arr(_small(300 + k), BLOCK)
    fn, meta = make_wide_pm_pipeline(k, block=BLOCK, cand_blocks=5,
                                     device="cpu")
    vec = fn(arr, 0.75)
    jfn, jmeta = ref_pm.make_wide_pm_pipeline(k, block=BLOCK, cand_blocks=5)
    want = np.asarray(jfn(jnp.asarray(arr), jnp.float32(0.75)))
    assert meta == jmeta
    assert _f32_exact(ref_pm.unpack_pm_outputs(want, n, jmeta))
    assert vec.dtype == torch.int32
    assert np.array_equal(vec.numpy(), want)


@pytest.mark.parametrize("k", WIDE_KS)
def test_sort_vector_equals_jax(k):
    arr, n = _arr(_small(400 + k), BLOCK)
    vec = make_wide_span_pipeline(k, block=BLOCK, cand_blocks=5,
                                  device="cpu")(arr, 0.75)
    want = np.asarray(ref_pipeline.make_wide_span_pipeline(
        k, block=BLOCK, cand_blocks=5)(jnp.asarray(arr), jnp.float32(0.75)))
    assert _f32_exact(ref_pipeline.unpack_wide_outputs(want, n, BLOCK, 5))
    assert vec.dtype == torch.int32
    assert np.array_equal(vec.numpy(), want)


def test_pipelines_refuse_bad_arguments():
    for make in (make_wide_pm_pipeline, make_wide_span_pipeline):
        for kw in (dict(k=15), dict(k=24), dict(k=17, block=1000)):
            with pytest.raises(ValueError):
                make(device="cpu", **kw)
    fn, _ = make_wide_pm_pipeline(17, block=BLOCK, device="cpu")
    with pytest.raises(ValueError):
        fn(np.zeros(1500, np.uint8), 0.75)
    with pytest.raises(TypeError):
        fn(np.zeros(BLOCK, np.int32), 0.75)


# ------------------------------------------------------- host finishers

def test_rebuild_codes_wide_equals_reference():
    rng = np.random.default_rng(5)
    for k in WIDE_KS:
        cw = rng.integers(0, 2 ** 32, (4, 2 + BLOCK // 16),
                          dtype=np.uint64).astype(np.uint32)
        cw[:, 0] >>= 2  # a seed's high word holds at most 30 bits
        cw[:, 1] &= 0xFFFF
        assert np.array_equal(finish.rebuild_codes_wide(cw, k, BLOCK),
                              ref_pipeline.rebuild_codes_wide(cw, k, BLOCK))


@pytest.mark.parametrize("k", [16, 23])
def test_pm_finishers_equal_reference(k):
    seq = _genome(500 + k)
    arr, n = _arr(seq, BLOCK)
    fn, meta = make_wide_pm_pipeline(k, block=BLOCK, cand_blocks=32,
                                     device="cpu")
    v = fn(arr, 0.75).numpy()
    got = pm_finish.unpack_pm_outputs(v, n, meta)
    want = ref_pm.unpack_pm_outputs(v, n, meta)
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
    assert (got["list_codes"][:int(got["list_count"])] > 1 << 30).any()
    for g, w in zip(pm_finish._pm_host_tables(got, got["t_list"]),
                    ref_pm._pm_host_tables(want, want["t_list"])):
        assert np.array_equal(g, w)
    for cand in (None, 1):  # all candidates pulled; a missed candidate
        o = got if cand is None else dict(got, top_idx=got["top_idx"][:1])
        g = pm_finish.finish_pm_spans(o, n, meta, 0.75, 30, 5.0)
        w = ref_pm.finish_pm_spans(o, n, meta, 0.75, 30, 5.0)
        assert (g.regions, g.fallback) == (w.regions, w.fallback)
        assert g.fallback == (cand == 1)
        assert cand == 1 or len(g.regions) >= 3


@pytest.mark.parametrize("k", [17, 23])
def test_sort_finishers_equal_reference(k):
    seq = _genome(600 + k)
    arr, n = _arr(seq, BLOCK)
    v = make_wide_span_pipeline(k, block=BLOCK, cand_blocks=32,
                                device="cpu")(arr, 0.75).numpy()
    got = finish.unpack_wide_outputs(v, n, BLOCK, 32)
    want = ref_pipeline.unpack_wide_outputs(v, n, BLOCK, 32)
    assert got.keys() == want.keys()
    for key in want:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
    spectrum = count_spectrum_sparse(seq, k)
    for cand in (None, 1):
        o = got if cand is None else dict(got, top_idx=got["top_idx"][:1])
        g = finish.finish_wide_spans(o, n, k, 0.75, 30, 5.0, spectrum,
                                     block=BLOCK)
        w = ref_pipeline.finish_wide_spans(o, n, k, 0.75, 30, 5.0, spectrum,
                                           block=BLOCK)
        assert (g.regions, g.fallback) == (w.regions, w.fallback)
        assert g.fallback == (cand == 1)


# ------------------------------------------------------- against the oracle

@pytest.mark.parametrize("k", WIDE_KS)
def test_both_routes_equal_the_oracle(k):
    """The pm route and the sort route with the device's sparse spectrum:
    positions and f64 scores equal to the sequential oracle's with a
    SparseRanks lookup."""
    seq = _genome(700 + k)
    arr, n = _arr(seq, BLOCK)
    ucodes, ucounts, nw = count_spectrum_sparse(seq, k)
    expect = find_regions(seq, 0, 30, 5.0, SparseRanks(ucodes, ucounts), k,
                          0.75)
    assert len(expect) >= 3
    fn, meta = make_wide_pm_pipeline(k, block=BLOCK, cand_blocks=64,
                                     device="cpu")
    out = pm_finish.unpack_pm_outputs(fn(arr, 0.75).numpy(), n, meta)
    pm_res = pm_finish.finish_pm_spans(out, n, meta, 0.75, 30, 5.0)
    sort = finish.unpack_wide_outputs(
        make_wide_span_pipeline(k, block=BLOCK, cand_blocks=64,
                                device="cpu")(arr, 0.75).numpy(),
        n, BLOCK, 64)
    spectrum = device_sparse_spectrum(arr, k, device="cpu")
    assert out["total"] == sort["total"] == spectrum[2] == nw
    sort_res = finish.finish_wide_spans(sort, n, k, 0.75, 30, 5.0, spectrum,
                                        block=BLOCK)
    assert not pm_res.fallback and not sort_res.fallback
    assert pm_res.regions == sort_res.regions
    assert [r[1:] for r in pm_res.regions] == [e[1:] for e in expect]
