"""The port's span pipeline against JAX's make_span_pipeline and the
sequential oracle: the fused and non-fused class screens, the sort screen
and the fine screen.

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


def _run(seq, k, thr, min_w, min_s, block=1024, cand=32, screen="auto"):
    arr = _nbases(seq, block)
    fn = make_span_pipeline(k, block=block, cand_blocks=cand, screen=screen,
                            device="cpu")
    out = {key: None if v is None else v.numpy()
           for key, v in fn(arr, thr).items()}
    counts = None if out["counts"] is not None else count_spectrum(seq, k)[0]
    return finish_spans(out, arr.shape[0], thr, min_w, min_s, block=block,
                        counts=counts)


def _plant(seq, spans):
    s = list(seq)
    for beg, unit, reps in spans:
        s[beg:beg + len(unit) * reps] = unit * reps
    return "".join(s)


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
    # what now runs: the screen each k resolves to
    for k, screen in ((2, "class"), (3, "class"), (9, "class"),
                      (10, "sort"), (15, "sort")):
        fn = make_span_pipeline(k, packed=True, device="cpu")
        assert fn.screen == screen
        assert fn.packed_counts == (screen != "sort")
    assert make_span_pipeline(8, block=512, device="cpu").screen == "class"
    assert make_span_pipeline(8, screen="fine", device="cpu").screen == "fine"
    # what still raises: the fused kernel's block rule, and what the
    # reference cannot run either
    with pytest.raises(NotImplementedError):
        make_span_pipeline(8, block=1100, device="cpu")
    for kw in (dict(k=1), dict(k=10, screen="class"), dict(k=3, screen="sort"),
               dict(k=16), dict(k=0, screen="fine"), dict(k=8, screen="x"),
               dict(k=14, screen="fine", packed=True),
               dict(k=8, block=1000, packed=True)):
        with pytest.raises(ValueError):
            make_span_pipeline(device="cpu", **kw)


def test_bad_inputs_raise():
    fn = make_span_pipeline(4, block=1024, device="cpu")
    with pytest.raises(ValueError):
        fn(np.zeros(1500, np.uint8), 0.75)
    with pytest.raises(TypeError):
        fn(np.zeros(1024, np.int32), 0.75)


def _match_jax(arr, k, thr=0.75, **kw):
    """Dict and packed outputs of both packages on arr, element for
    element; returns the reference's dict."""
    want = {key: None if v is None else np.asarray(v)
            for key, v in jax_pipeline(k, **kw)(
                jnp.asarray(arr), jnp.float32(thr)).items()}
    assert _f32_exact(want)
    got = make_span_pipeline(k, device="cpu", **kw)(arr, thr)
    assert got.keys() == want.keys()
    for key in want:
        if want[key] is None:
            assert got[key] is None, key
        else:
            assert np.array_equal(got[key].numpy(), want[key]), key
    if kw.get("block", 8192) % 32 == 0:
        fn_j = jax_pipeline(k, packed=True, **kw)
        want_p = np.asarray(fn_j(jnp.asarray(arr), jnp.float32(thr)))
        fn_p = make_span_pipeline(k, packed=True, device="cpu", **kw)
        got_p = fn_p(arr, thr)
        assert got_p.dtype == torch.int32
        assert np.array_equal(got_p.numpy(), want_p)
        assert (fn_p.packed_bases, fn_p.packed_counts, fn_p.screen) == (
            fn_j.packed_bases, fn_j.packed_counts, fn_j.screen)
    return want


def _island_arr(k, block, n=12 * 1024, seed=0):
    rng = np.random.default_rng(seed + 31 * k + block)
    s = list(random_seq(rng, n, n_prob=0.002))
    s[2000:2500] = "AG" * 250
    s[6000:8100] = "TTAGGC" * 350  # across blocks
    return _nbases("".join(s), block)


@pytest.mark.parametrize("k,block", [(2, 1024), (2, 256), (3, 1024),
                                     (3, 256), (9, 1024), (9, 256),
                                     (8, 512)])
def test_class_screen_outputs_match_jax(k, block):
    arr = _island_arr(k, block)
    want = _match_jax(arr, k, block=block, cand_blocks=5)
    assert want["counts"].shape == (1 << (2 * k),)


@pytest.mark.parametrize("k", [10, 12])
def test_sort_screen_outputs_match_jax(k):
    # thr 0.5 centres the scores, which keeps the reference's f32
    # composition exact
    arr = _island_arr(k, 1024, n=8 * 1024)
    want = _match_jax(arr, k, thr=0.5, block=1024, cand_blocks=5)
    assert want["counts"] is None


@pytest.mark.parametrize("k", [8, 10])
def test_fine_screen_outputs_match_jax(k):
    arr = _island_arr(k, 1024, n=8 * 1024)
    _match_jax(arr, k, thr=0.5, block=1024, cand_blocks=5, screen="fine")


def test_non_16_aligned_block_layout():
    """block % 16 != 0: the candidate rows of the dict equal the
    reference's; its packed vector cannot be built there (the scored flags
    go 32 a word), so the port refuses it and the reference fails too."""
    arr = _island_arr(4, 1000, n=10_000)
    _match_jax(arr, 4, block=1000, cand_blocks=3)
    with pytest.raises(TypeError):
        jax_pipeline(4, block=1000, cand_blocks=3, packed=True)(
            jnp.asarray(arr), jnp.float32(0.75))
    with pytest.raises(ValueError):
        make_span_pipeline(4, block=1000, cand_blocks=3, packed=True,
                           device="cpu")


@pytest.mark.parametrize("k,block", [(2, 1024), (3, 256), (9, 1024),
                                     (9, 512), (8, 512)])
def test_class_screen_regions_match_oracle(k, block):
    rng = np.random.default_rng(60 + k)
    seq = _plant(random_seq(rng, 30_000, n_prob=0.003),
                 [(5000, "AG", 250), (17000, "CCTGA", 130)])
    thr = 0.75 if k > 3 else 0.8
    res = _run(seq, k, thr, 30, 5.0, block=block)
    assert not res.fallback
    expect = _chain_rank_regions(seq, k, thr, 30, 5.0)
    assert len(expect) >= 1
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]  # f64 scores bit-identical


@pytest.mark.parametrize("k,screen", [(10, "sort"), (11, "sort"),
                                      (12, "sort"), (8, "fine"),
                                      (10, "fine")])
def test_sort_and_fine_regions_match_oracle(k, screen):
    rng = np.random.default_rng(100 + k)
    seq = _plant(random_seq(rng, 50_000, n_prob=0.003),
                 [(6000, "AG", 300), (20000, "CCTGA", 130),
                  (41000, "T", 500)])
    res = _run(seq, k, 0.75, 30, 5.0, screen=screen)
    assert not res.fallback
    expect = _chain_rank_regions(seq, k, 0.75, 30, 5.0)
    assert len(expect) >= 2
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]


def test_sort_screen_auto_selected():
    """"auto" resolves to the sort screen at k >= 10 (counts is None) and
    still matches the oracle through the host-recount finisher."""
    rng = np.random.default_rng(17)
    seq = _plant(random_seq(rng, 30_000), [(5000, "A", 4000)])
    assert make_span_pipeline(10, device="cpu").screen == "sort"
    res = _run(seq, 10, 0.75, 30, 5.0, cand=24)
    assert not res.fallback
    expect = _chain_rank_regions(seq, 10, 0.75, 30, 5.0)
    assert len(expect) >= 1
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]


def test_sort_screen_packed_payload():
    """packed=True at k >= 10: no spectrum in the vector (packed_counts
    forced off); the finisher replays from the host recount."""
    k = 10
    rng = np.random.default_rng(7)
    seq = _plant(random_seq(rng, 40_000, n_prob=0.002),
                 [(9000, "AG", 350), (25000, "GATTA", 140)])
    arr = _nbases(seq, 1024)
    n = arr.shape[0]
    fn = make_span_pipeline(k, block=1024, cand_blocks=24, packed=True,
                            packed_counts=True, device="cpu")
    assert not fn.packed_counts
    got = unpack_outputs(fn(arr, 0.72).numpy(), k, n, 1024, 24,
                         packed_bases=fn.packed_bases,
                         packed_counts=fn.packed_counts, lazy_codes=True)
    assert got["counts"] is None
    counts, _ = count_spectrum(seq, k)
    res = finish_spans(got, n, 0.72, 30, 5.0, block=1024, counts=counts)
    assert not res.fallback
    expect = _chain_rank_regions(seq, k, 0.72, 30, 5.0)
    assert len(expect) >= 2
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]


def test_sort_screen_k14_big_rank_path():
    """k = 14: sort screen, native host recount, and the candidate-only
    native rank path of finish_spans (no 4^14 f64 chain table)."""
    from kmer_spans_tpu_torch.spans.finish import host_rank_chain
    from kmer_spans_tpu_torch.utils import native

    if not native.available():
        pytest.skip("native library unavailable")
    k = 14
    rng = np.random.default_rng(41)
    seq = _plant(random_seq(rng, 60_000, n_prob=0.002),
                 [(8000, "AG", 400), (30000, "CCTGA", 180)])
    arr = _nbases(seq, 1024)
    n = arr.shape[0]
    fn = make_span_pipeline(k, block=1024, cand_blocks=24, packed=True,
                            device="cpu")
    got = unpack_outputs(fn(arr, 0.75).numpy(), k, n, 1024, 24,
                         packed_bases=fn.packed_bases,
                         packed_counts=fn.packed_counts, lazy_codes=True)
    counts, nk = native.host_spectrum(arr, k)
    res = finish_spans(got, n, 0.75, 30, 5.0, block=1024, counts=counts)
    assert not res.fallback
    expect = find_regions(seq, 0, 30, 5.0,
                          host_rank_chain(counts, int(nk)), k, 0.75)
    assert len(expect) >= 2
    assert [(r[1], r[2], r[3]) for r in res.regions] == \
        [(e[1], e[2], e[3]) for e in expect]
