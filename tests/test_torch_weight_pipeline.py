"""The port's arbitrary-weight span pipeline against the JAX package's.

quantize_weight_table, make_weight_span_pipeline (its dict and its pull)
and finish_weight_spans, on the same seeded inputs through both packages
(the JAX one's K3 in interpret mode on the CPU).  Integers must be equal
and f64 region scores == (no tolerance anywhere: both replay the same f64
weights in the same order).  Where the reference fails (a -inf weight, a
second candidate stretch after a pull) the port is held against the
sequential oracle instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_spans_tpu.encoding import pack
from kmer_spans_tpu.oracle import find_regions
from kmer_spans_tpu.spans import pipeline as ref_pipeline
from kmer_spans_tpu_torch.ops.blocked import block_rows_codes, blocked_codes
from kmer_spans_tpu_torch.spans.finish import finish_weight_spans
from kmer_spans_tpu_torch.spans.pipeline import (
    make_weight_span_pipeline,
    quantize_weight_table,
)

from conftest import random_seq

_KEYS = ("tA", "tB", "maxA", "maxB", "top_idx", "codes", "scored",
         "scan_hist")


def _nbases(seq, block):
    p = pack(seq)
    n = -(-p.n // block) * block
    arr = np.full(n, 4, np.uint8)
    arr[:p.n] = np.where(p.valid, p.bases, 4)
    return arr


def _genome(seed, n=40_000, islands=((3000, "CG", 300), (21000, "AG", 300))):
    rng = np.random.default_rng(seed)
    s = list(random_seq(rng, n, n_prob=0.002))
    for beg, unit, reps in islands:
        s[beg:beg + len(unit) * reps] = unit * reps
    return "".join(s)


def _motif_table(k, motif, hit=1.5, miss=-0.4):
    """CpG-style weights: hit for the k-mers holding ``motif``, miss for
    every other k-mer."""
    from kmer_spans_tpu_torch.encoding import all_kmers

    return np.array([hit if motif in km else miss for km in all_kmers(k)])


# --------------------------------------------------- quantize_weight_table

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("block", [1024, 4096])
def test_quantize_equals_jax_on_finite_tables(seed, block):
    rng = np.random.default_rng(seed)
    scale_of = [1e-9, 0.3, 1.0, 2e4][seed]  # both clamps of the exponent
    w = rng.normal(0.1, 1.0, 1 << (2 * (seed + 2))) * scale_of
    thr = [0.0, 0.75, -0.2, 3.0][seed]
    got_q, got_s = quantize_weight_table(w, thr, block)
    want_q, want_s = ref_pipeline.quantize_weight_table(w, thr, block)
    assert got_q.dtype == want_q.dtype == np.int32
    assert np.array_equal(got_q, want_q) and got_s == want_s


def test_quantize_equals_jax_on_a_flat_table():
    w = np.full(256, 0.75)
    got = quantize_weight_table(w, 0.75, 4096)
    want = ref_pipeline.quantize_weight_table(w, 0.75, 4096)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1] == 1.0


@pytest.mark.parametrize("block", [1024, 4096])
def test_quantize_neg_inf_is_sound(block):
    """-inf takes -(2^26 // block); the finite entries and the scale are
    the reference's for the table without them; every block sum stays in
    int32.  The reference itself fails on such a table."""
    rng = np.random.default_rng(block)
    w = rng.normal(0.0, 2.0, 1 << 12)
    w[rng.random(w.size) < 0.3] = -np.inf
    w_q, scale = quantize_weight_table(w, 0.5, block)
    inf = np.isneginf(w)
    assert (w_q[inf] == -((1 << 26) // block)).all()
    finite_only = np.where(inf, 0.5, w)  # s = 0 there: no effect on max|s|
    want_q, want_s = ref_pipeline.quantize_weight_table(finite_only, 0.5,
                                                        block)
    assert scale == want_s and np.array_equal(w_q[~inf], want_q[~inf])
    assert (w_q[~inf] / scale >= w[~inf] - 0.5).all()  # an upper bound
    # the clamp sits below every finite score: it resets the screen too
    assert w_q[inf][0] / scale < (w[~inf] - 0.5).min()
    lo, hi = int(w_q.min()) * block, int(w_q.max()) * block
    assert -(1 << 31) < lo and hi < (1 << 31)
    with pytest.raises(OverflowError):
        ref_pipeline.quantize_weight_table(w, 0.5, block)


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_quantize_refuses_what_has_no_bound(bad):
    w = np.zeros(16)
    w[3] = bad
    with pytest.raises(ValueError):
        quantize_weight_table(w, 0.0, 1024)


# ------------------------------------------------ the pipeline's outputs

@pytest.mark.parametrize("k", [2, 4, 8])
def test_weight_pipeline_dict_equals_jax(k):
    """Block summaries, run-aware top-C, candidate rows and the scan
    histogram (K3, at every k here; the reference's K3 at 4 <= k <= 8 and
    a scatter at k = 2): equal element for element."""
    block, cand = 1024, 8
    seq = _genome(k, n=60_000)
    arr = _nbases(seq, block)
    rng = np.random.default_rng(k)
    w = rng.normal(-0.3, 1.0, 1 << (2 * k))
    w[np.isin(np.arange(w.size), rng.integers(0, w.size, 5))] = 2.0
    w_q, _ = quantize_weight_table(w, 0.0, block)
    got = make_weight_span_pipeline(k, block=block, cand_blocks=cand,
                                    with_scan_counts=True, device="cpu")(
        arr, w_q)
    want = ref_pipeline.make_weight_span_pipeline(
        k, block=block, cand_blocks=cand, with_scan_counts=True)(
        jnp.asarray(arr), jnp.asarray(w_q))
    assert set(got) == set(want) == set(_KEYS)
    for key in _KEYS:
        g, r = got[key].numpy(), np.asarray(want[key])
        assert g.shape == r.shape and np.array_equal(g, r), key
    assert int(got["scan_hist"].sum()) > 0


@pytest.mark.parametrize("k", [2, 5, 8])
def test_pull_equals_the_main_rows_and_jax(k):
    block = 1024
    arr = _nbases(_genome(10 + k, n=20_000), block)
    nb = arr.size // block
    idx = np.array([0, 3, nb - 1, 7, 7])
    fn = make_weight_span_pipeline(k, block=block, device="cpu")
    codes, scored = fn.pull(arr, idx)
    want_c, want_s = ref_pipeline.make_weight_span_pipeline(
        k, block=block).pull(jnp.asarray(arr), jnp.asarray(idx, jnp.int32))
    assert np.array_equal(codes.numpy(), np.asarray(want_c))
    assert np.array_equal(scored.numpy(), np.asarray(want_s))
    # and the rows of the whole genome's blocked codes
    t = torch.from_numpy(arr).reshape(nb, block)
    all_c, kv = blocked_codes(t & 3, t < 4, k)
    rows_c, _ = block_rows_codes(torch.from_numpy(arr), torch.tensor(idx),
                                 k, block)
    assert torch.equal(rows_c, torch.where(kv, all_c, 0)[idx])


# --------------------------------------------------- finish_weight_spans

def _both(seq, k, w, min_w, min_s, block, cand, thr=0.0):
    """(port result, port scan counts, reference result, its counts)."""
    arr = _nbases(seq, block)
    n = arr.size
    w_q, scale = quantize_weight_table(w, thr, block)
    fn = make_weight_span_pipeline(k, block=block, cand_blocks=cand,
                                   with_scan_counts=True, device="cpu")
    out = {key: v.numpy() for key, v in fn(arr, w_q).items()}
    sc = np.zeros(w.size, np.int64)
    got = finish_weight_spans(out, n, w, thr, min_w, min_s, scale,
                              block=block, scan_counts=sc, pull_fn=fn.pull,
                              nbases_dev=torch.from_numpy(arr))
    rfn = ref_pipeline.make_weight_span_pipeline(
        k, block=block, cand_blocks=cand, with_scan_counts=True)
    dev = jnp.asarray(arr)
    rout = rfn(dev, jnp.asarray(w_q))
    rsc = np.zeros(w.size, np.int64)
    want = ref_pipeline.finish_weight_spans(
        rout, n, w, thr, min_w, min_s, scale, block=block, scan_counts=rsc,
        pull_fn=rfn.pull, nbases_dev=dev)
    return got, sc + out["scan_hist"], want, rsc + np.asarray(
        rout["scan_hist"])


@pytest.mark.parametrize("k,min_s", [(2, 20.0), (4, 20.0), (8, 20.0),
                                     (2, -5.0), (4, 0.0)])
def test_finish_equals_jax(k, min_s):
    """Candidates in one stretch, all of them in the top C or pulled;
    min_score <= 0 makes the score gate vacuous."""
    seq = _genome(20 + k, n=30_000, islands=((9000, "CG", 200),))
    w = _motif_table(k, "CG")
    got, sc, want, rsc = _both(seq, k, w, 40, min_s, 1024, 4)
    assert not got.fallback and not want.fallback
    assert got.regions == want.regions and got.regions
    assert np.array_equal(sc, rsc)
    oracle_sc = np.zeros(w.size, np.int64)
    assert got.regions == find_regions(seq, 0, 40, min_s, w, k, 0.0,
                                       scan_counts=oracle_sc)
    assert np.array_equal(sc, oracle_sc)


def test_finish_second_stretch_after_a_pull():
    """Four islands, a top C of 2: the other candidate blocks are pulled.
    The reference's finisher reuses the name of its pulled blocks for the
    rescan counts and fails on the next stretch; the port equals the
    oracle, regions and scan counts."""
    seq = list(_genome(7, n=40_000, islands=()))
    for beg in (3000, 9000, 21000, 33000):
        seq[beg:beg + 600] = "CG" * 300
    seq = "".join(seq)
    w = _motif_table(2, "CG")
    arr = _nbases(seq, 1024)
    w_q, scale = quantize_weight_table(w, 0.0, 1024)
    fn = make_weight_span_pipeline(2, block=1024, cand_blocks=2,
                                   with_scan_counts=True, device="cpu")
    out = {key: v.numpy() for key, v in fn(arr, w_q).items()}
    sc = np.zeros(16, np.int64)
    calls = []

    def pull(nbases, idx):
        calls.append(len(idx))
        return fn.pull(nbases, idx)

    got = finish_weight_spans(out, arr.size, w, 0.0, 40, 20.0, scale,
                              block=1024, scan_counts=sc, pull_fn=pull,
                              nbases_dev=torch.from_numpy(arr))
    assert calls and set(calls) == {2}  # batches of C blocks
    oracle_sc = np.zeros(16, np.int64)
    want = find_regions(seq, 0, 40, 20.0, w, 2, 0.0, scan_counts=oracle_sc)
    assert got.regions == want and len(want) == 4
    assert np.array_equal(sc + out["scan_hist"], oracle_sc)
    with pytest.raises(KeyError):
        _both(seq, 2, w, 40, 20.0, 1024, 2)


def test_finish_without_pull_flags_a_miss():
    seq = _genome(3, n=30_000, islands=((4000, "CG", 300),
                                        (20000, "CG", 300)))
    w = _motif_table(2, "CG")
    arr = _nbases(seq, 1024)
    w_q, scale = quantize_weight_table(w, 0.0, 1024)
    out = {key: v.numpy() for key, v in make_weight_span_pipeline(
        2, block=1024, cand_blocks=1, device="cpu")(arr, w_q).items()}
    res = finish_weight_spans(out, arr.size, w, 0.0, 40, 20.0, scale,
                              block=1024)
    assert res.fallback and not res.regions


def test_neg_inf_weights_reset_the_replay():
    """A -inf weight resets the running score to 0, as in the sequential
    oracle: regions on both sides of it, equal to the oracle's."""
    seq = _genome(11, n=20_000, islands=((2000, "CG", 300),
                                         (2700, "AAAAAAA", 1),
                                         (2707, "CG", 300)))
    w = _motif_table(3, "CG", hit=2.0, miss=-0.3)
    w[0] = -np.inf  # AAA
    arr = _nbases(seq, 1024)
    w_q, scale = quantize_weight_table(w, 0.0, 1024)
    fn = make_weight_span_pipeline(3, block=1024, cand_blocks=4,
                                   with_scan_counts=True, device="cpu")
    out = {key: v.numpy() for key, v in fn(arr, w_q).items()}
    sc = np.zeros(w.size, np.int64)
    got = finish_weight_spans(out, arr.size, w, 0.0, 40, 20.0, scale,
                              block=1024, scan_counts=sc, pull_fn=fn.pull,
                              nbases_dev=torch.from_numpy(arr))
    oracle_sc = np.zeros(w.size, np.int64)
    want = find_regions(seq, 0, 40, 20.0, w, 3, 0.0, scan_counts=oracle_sc)
    assert got.regions == want and len(want) >= 2
    assert np.array_equal(sc + out["scan_hist"], oracle_sc)


# ------------------------------------------ the fold reads the weights

def _unit_table(rng, k, units=("CG", "AG"), lo=-0.6, hi=0.3):
    """A 4^k table of decimal weights in [lo, hi], 1.5 at the k-mers of
    the repeat units and -inf at the all-A k-mer."""
    from kmer_spans_tpu_torch.encoding import kmer_to_code

    w = np.round(rng.uniform(lo, hi, 1 << (2 * k)), 1)
    for unit in units:
        rep = unit * k
        for off in range(len(unit)):
            w[kmer_to_code(rep[off:off + k])] = 1.5
    w[0] = -np.inf
    return w


def test_finish_several_sequences_against_one_k12_table():
    """Three sequences, one 4^12 weights table handed to every finish as
    it is, a top C of 2: candidate blocks are pulled, and each sequence's
    regions equal the oracle's, f64 ==; the table is not written."""
    from kmer_spans_tpu_torch.spans import finish

    rng = np.random.default_rng(12)
    w = _unit_table(rng, 12)
    keep = w.copy()
    thr = 0.25
    seqs = [_genome(30 + i, n=n, islands=isl) for i, (n, isl) in enumerate((
        (30_000, ((3000, "CG", 300), (9000, "AG", 250),
                  (21000, "CG", 400))),
        (12_000, ((5000, "AG", 300),)),
        (26_000, ((1000, "CG", 200), (7000, "A", 40), (7040, "CG", 300),
                  (15000, "AG", 300), (24000, "CG", 300))),
    ))]
    w_q, scale = quantize_weight_table(w, thr, 1024)
    fn = make_weight_span_pipeline(12, block=1024, cand_blocks=2,
                                   device="cpu")
    pulled = finish.pulled_blocks
    for i, seq in enumerate(seqs):
        arr = _nbases(seq, 1024)
        out = {key: v.numpy() for key, v in fn(arr, w_q).items()}
        got = finish_weight_spans(out, arr.size, w, thr, 40, 20.0, scale,
                                  block=1024, seq_id=i, pull_fn=fn.pull,
                                  nbases_dev=torch.from_numpy(arr))
        want = find_regions(seq, i, 40, 20.0, w, 12, thr)
        assert not got.fallback and got.regions == want and want
    assert finish.pulled_blocks > pulled
    assert np.array_equal(w, keep)


@pytest.mark.parametrize("k", [2, 6])
def test_kmer_regions_scan_counts_equal_native(k):
    """kmer_regions on the CPU device path over several sequences: the
    scan counts, rescans of every emission included, and the regions
    equal the host library's caller (backend="native")."""
    from kmer_spans_tpu_torch import api

    rng = np.random.default_rng(40 + k)
    w = _unit_table(rng, k, ("CT", "TCT"), -0.5, 0.2)
    seqs = [_genome(50 + i, n=n, islands=isl) for i, (n, isl) in enumerate((
        (20_000, ((2000, "CT", 300), (12000, "TCT", 150))),
        (9_000, ((4000, "CT", 250),)),
        (15_000, ((500, "TC", 200), (8000, "CT", 300))),
    ))]
    got = api.kmer_regions(seqs, k, w, 40, 10.0, device="cpu")
    want = api.kmer_regions(seqs, k, w, 40, 10.0, backend="native")
    assert len(got.regions) >= 3
    assert np.array_equal(got.regions, want.regions)
    assert np.array_equal(got.counts, want.counts)
    # more scans than k-mers: the rescans count again
    assert got.counts.sum() > api.kmer_counts(seqs, k, device="cpu").n


@pytest.mark.parametrize("with_scan_counts", [False, True])
def test_finish_builds_no_table_sized_array(with_scan_counts):
    """One sequence's finish with a 4^12 table (134 MB of f64) allocates
    less than 16 MB beyond its inputs, with or without scan counts: no
    per-sequence copy of the table and no table-sized histogram."""
    import tracemalloc

    rng = np.random.default_rng(3)
    w = _unit_table(rng, 12)
    seq = _genome(8, n=40_000, islands=((5000, "CG", 300),
                                        (25000, "AG", 300)))
    arr = _nbases(seq, 1024)
    w_q, scale = quantize_weight_table(w, 0.25, 1024)
    fn = make_weight_span_pipeline(12, block=1024, cand_blocks=4,
                                   device="cpu")
    out = {key: v.numpy() for key, v in fn(arr, w_q).items()}
    sc = np.zeros(w.size, np.int64) if with_scan_counts else None
    nbases = torch.from_numpy(arr)
    tracemalloc.start()
    try:
        got = finish_weight_spans(out, arr.size, w, 0.25, 40, 20.0, scale,
                                  block=1024, scan_counts=sc,
                                  pull_fn=fn.pull, nbases_dev=nbases)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert len(got.regions) == 2
    assert peak < 16 << 20, peak
