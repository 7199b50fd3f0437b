"""The port's exact-mass screen (ops/pmscreen.py) and K3 (ops/histogram.py)
against the JAX package and the sparse oracle.

Same seeded inputs as tests/test_pm_pipeline.py.  JAX's K3,
pallas_histogram, runs in interpret mode on the CPU; the port's wrappers
run their plain versions here.  Every comparison is exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmer_spans_tpu.ops import pmscreen as ref
from kmer_spans_tpu.ops.blocked import blocked_codes as jax_blocked_codes
from kmer_spans_tpu.ops.pallas_kernels import (
    pallas_count_spectrum,
    pallas_histogram,
)
from kmer_spans_tpu.ops.sortscreen import _run_lengths as jax_run_lengths
from kmer_spans_tpu.oracle import count_spectrum_sparse
from kmer_spans_tpu.spans.pm_pipeline import _pm_host_tables as \
    jax_host_tables
from kmer_spans_tpu.stats.ranks import sparse_mass
from kmer_spans_tpu_torch.ops import histogram, pmscreen
from kmer_spans_tpu_torch.ops.blocked import blocked_codes
from kmer_spans_tpu_torch.ops.histogram import (
    count_spectrum,
    histogram_plain,
)
from kmer_spans_tpu_torch.spans.pm_finish import _pm_host_tables

from conftest import random_seq
from test_pm_pipeline import _arr, _plant


def _codes(seq, k, block=512):
    """(arr, torch codes, torch kmer_valid, jax codes, jax kmer_valid)."""
    arr, _ = _arr(seq, block)
    b2 = arr.reshape(-1, block)
    codes, kv = blocked_codes(torch.from_numpy(b2 & 3),
                              torch.from_numpy(b2 < 4), k)
    jc, jkv = jax_blocked_codes(jnp.asarray(b2 & 3).astype(jnp.int32),
                                jnp.asarray(b2 < 4), k)
    assert np.array_equal(codes.numpy(), np.asarray(jc))
    return (arr, codes.reshape(-1), kv.reshape(-1), jc.reshape(-1),
            jkv.reshape(-1))


def _same_screen(got, want):
    assert got.keys() == want.keys()
    assert got["t_list"] == want["t_list"]
    for key in want:
        assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), key
    for key in ("pm", "vh", "list_codes", "list_v"):
        assert got[key].dtype == torch.int32, key


def _host_out(scr, total):
    return {"total": total, "vh": scr["vh"].numpy(),
            "list_codes": scr["list_codes"].numpy().astype(np.int64),
            "list_v": scr["list_v"].numpy().astype(np.int64)}


# ------------------------------------------------------- parameters

@pytest.mark.parametrize("k", range(10, 16))
def test_params_equal_reference(k):
    ns = [1 << e for e in range(13, 32)] + [3 * 8192, 100_663_296,
                                           2_000_000_000, (1 << 31) - 1]
    for n in ns:
        assert pmscreen.choose_params(k, n) == ref.choose_params(k, n)
        assert pmscreen.choose_params(k, n, wide=True) == \
            ref.choose_params(k, n, wide=True)
        for strategy in (None, "packed", "smallv"):
            assert pmscreen.pm_params(k, strategy, n=n) == \
                ref.pm_params(k, strategy, n=n)
    for strategy in (None, "packed", "smallv"):
        assert pmscreen.pm_params(k, strategy) == ref.pm_params(k, strategy)
    assert pmscreen.pm_strategy(k) == ref.pm_strategy(k)
    assert pmscreen.pm_cap(k) == ref.pm_cap(k)
    for lam in (0.0, 0.25, 4.0, 16.0, 61.0):
        for t in (1, 4, 13):
            assert pmscreen._pois_tail(lam, t) == ref._pois_tail(lam, t)
    assert (pmscreen.SMALLV_T, pmscreen.PM_CAP_PACKED,
            pmscreen.PM_CAP_SMALLV) == (ref.SMALLV_T, ref.PM_CAP_PACKED,
                                        ref.PM_CAP_SMALLV)


def test_pm_strategy_rejects_wide_k():
    for k in (9, 16):
        with pytest.raises(ValueError):
            pmscreen.pm_strategy(k)


# ------------------------------------------------------------- K3

def _hist_case(rng, size, case, n=20_000):
    lo = 0 if size < 128 else -3  # the reference's scatter wraps negatives
    values = rng.integers(lo, size + 40, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    if case == "skew":  # run lengths at run heads: almost all on bins 1..3
        values = np.minimum(rng.geometric(0.7, n), size - 1).astype(np.int32)
        values[5000:9000] = 2  # one stretch of identical values
    elif case == "invalid":
        valid[:] = False
    return values, valid


@pytest.mark.parametrize("case", ["random", "skew", "invalid"])
@pytest.mark.parametrize("size", [100, 256, 4096, 65536])
def test_histogram_plain_matches_pallas(size, case):
    rng = np.random.default_rng(size + len(case))
    values, valid = _hist_case(rng, size, case)
    want = np.asarray(pallas_histogram(jnp.asarray(values),
                                       jnp.asarray(valid), size, tile=2048))
    got = histogram.histogram(torch.from_numpy(values),
                              torch.from_numpy(valid), size)
    assert got.dtype == torch.int32 and got.shape == (size,)
    assert np.array_equal(got.numpy(), want)
    if case == "invalid":
        assert not got.any()


@pytest.mark.parametrize("k", [4, 6])
def test_count_spectrum_matches_pallas(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 1 << (2 * k), 30_000).astype(np.int32)
    valid = rng.random(30_000) < 0.9
    want = np.asarray(pallas_count_spectrum(jnp.asarray(codes),
                                            jnp.asarray(valid), k))
    got = count_spectrum(torch.from_numpy(codes), torch.from_numpy(valid), k)
    assert np.array_equal(got.numpy(), want)


def test_histogram_cpu_takes_plain_version():
    rng = np.random.default_rng(1)
    values, valid = _hist_case(rng, 300, "random", n=5000)
    v, m = torch.from_numpy(values), torch.from_numpy(valid)
    before = histogram.histogram_launches
    assert torch.equal(histogram.histogram(v, m, 300),
                       histogram_plain(v, m, 300))
    assert histogram.histogram_launches == before  # no kernel ran


def test_histogram_rejects_bad_input():
    v = torch.zeros(64, dtype=torch.int32)
    m = torch.ones(64, dtype=torch.bool)
    with pytest.raises(ValueError):
        histogram.histogram(v, m, 0)
    with pytest.raises(TypeError):
        histogram.histogram(v.to(torch.int64), m, 10)
    with pytest.raises(TypeError):
        histogram.histogram(v, m.to(torch.int32), 10)
    with pytest.raises(ValueError):
        histogram.histogram(v, m[:32], 10)


@pytest.mark.parametrize("size,form", [
    (1, "sliced"), (256, "sliced"), (1 << 15, "sliced"),  # one CTA's
    ((1 << 15) + 1, "cluster"), (1 << 16, "cluster"),     # two slices
    ((1 << 16) + 1, "partitioned"), (1 << 18, "partitioned"),
    ((1 << 18) + 1, "partitioned"), (1 << 20, "partitioned"),
])
def test_histogram_form_rule(size, form):
    """The rule measured on the card for run lengths: the sort screen's
    run histograms (65536 bins) take the cluster form, larger sizes the
    partitioned form."""
    assert histogram.histogram_form(size, "runs") == form


def test_histogram_form_rule_at_the_main_paths_shapes():
    from kmer_spans_tpu_torch.ops import sortscreen

    form = histogram.histogram_form
    kind = sortscreen.runs_kind(1 << 28, 12)
    assert kind == "runs" and sortscreen.runs_kind(1 << 28, 17) == "repeats"
    assert form(sortscreen.VMAX, kind) == "cluster"
    assert form(sortscreen.V2 * 256, kind) == "cluster"
    assert form(sortscreen.VMAX, "repeats") == "cluster_merged"  # wide, k = 17
    assert form(1 << 16) == "sliced"         # the 4^8 spectrum
    assert form(1 << 18) == "partitioned"    # the k = 9 count
    assert form(1 << 18, n=1 << 25) == "sliced"  # a k = 9 stream chunk
    assert form(1 << 24, n=1 << 25) == "partitioned"  # a k = 12 one
    assert form(1 << 24) == "partitioned"    # the 4^12 spectrum
    assert form(1 << 26) == "partitioned"    # the k = 13 shard count
    assert form(256, kind) == "sliced"       # the pm value histogram
    assert form(3328, "repeats") == "sliced"  # a window chunk's counts
    assert form(-(-154 * 3232 // 128) * 128, "repeats") == "cluster_merged"


@pytest.mark.parametrize("size,form", [
    (1, "sliced"), (1 << 15, "sliced"),                    # one CTA's
    ((1 << 15) + 1, "sliced"), (1 << 16, "sliced"),        # dense: sliced
    ((1 << 16) + 1, "partitioned"), (1 << 18, "partitioned"),
    ((1 << 18) + 1, "partitioned"), (1 << 20, "partitioned"),
    (1 << 24, "partitioned"), (1 << 30, "global"),         # 4^15: global
])
def test_histogram_five_way_rule(size, form):
    """Where K3 takes each form for dense input (the spectra): sliced to
    two slices, partitioned to 4^14, global above, measured on the card."""
    assert histogram.histogram_form(size) == form
    assert histogram.histogram_form(size, "dense") == form


@pytest.mark.parametrize("kind,form", [("dense", "sliced"),
                                       ("runs", "cluster"),
                                       ("repeats", "cluster_merged")])
def test_histogram_kind_choices_at_65536_bins(kind, form):
    """At 65536 bins the best form depends on the input; the caller says
    what it counts, and the counts do not depend on it."""
    assert histogram.histogram_form(1 << 16, kind) == form
    rng = np.random.default_rng(len(kind))
    v = torch.from_numpy(rng.integers(-5, 1 << 16, 5000).astype(np.int32))
    m = torch.from_numpy(rng.random(5000) < 0.7)
    assert torch.equal(histogram.histogram(v, m, 1 << 16, kind),
                       histogram_plain(v, m, 1 << 16))
    with pytest.raises(ValueError, match="unknown kind"):
        histogram.histogram(v, m, 1 << 16, "sparse")


@pytest.mark.parametrize("size", [1, 1 << 15, (1 << 15) + 1, 1 << 16,
                                  1 << 18, 154 * 3232, 1 << 24, 1 << 26,
                                  1 << 30])
def test_partition_plan_puts_every_bin_in_one_part(size):
    """The parts of 2^15 bins tile [0, size): bin b lies in part b >> 15,
    and in no other."""
    plan = histogram.partition_plan(1 << 20, size, 132)
    lo = np.arange(plan.parts, dtype=np.int64) * histogram.SLICE_BINS
    hi = np.minimum(lo + histogram.SLICE_BINS, size)
    assert lo[0] == 0 and hi[-1] == size
    assert (hi > lo).all() and np.array_equal(lo[1:], hi[:-1])
    bins = np.array([0, size // 3, size - 1], np.int64)
    part = bins >> 15
    assert ((lo[part] <= bins) & (bins < hi[part])).all()


def _work_items(part_counts, item_len):
    """Pass C's work items as csrc/histogram.cu part_items_kernel maps
    them: (part, first, end) bucket ranges of at most item_len values,
    ceil(count / item_len) a part, the parts one after another."""
    items, first = [], 0
    for p, c in enumerate(int(c) for c in part_counts):
        for lo in range(first, first + c, item_len):
            items.append((p, lo, min(lo + item_len, first + c)))
        first += c
    return items


@pytest.mark.parametrize("case", ["random", "one part holds all",
                                  "empty parts", "nothing counted"])
def test_partition_work_items_cover_every_bucket(case):
    """Pass C's items cover each part's bucket exactly once, hold at most
    item_len values each, and stay within the plan's max_items; one part
    holding all n values spreads over many items."""
    rng = np.random.default_rng(len(case))
    n, size = 1 << 22, 1 << 24
    plan = histogram.partition_plan(n, size, 132)
    counts = rng.multinomial(n, np.full(plan.parts, 1 / plan.parts))
    if case == "one part holds all":
        counts = np.zeros(plan.parts, np.int64)
        counts[plan.parts // 3] = n
    elif case == "empty parts":
        counts[::3] = 0
    elif case == "nothing counted":
        counts[:] = 0
    items = _work_items(counts, plan.item_len)
    assert len(items) <= plan.max_items
    covered = np.zeros(int(counts.sum()), np.int32)
    first = np.concatenate([[0], np.cumsum(counts)])
    for p, lo, hi in items:
        assert first[p] <= lo < hi <= first[p + 1]
        assert hi - lo <= plan.item_len
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if case == "one part holds all":
        assert len(items) == -(-n // plan.item_len) >= 8


@pytest.mark.parametrize("n,size", [
    (1 << 28, 1 << 24),         # the 4^12 exact spectrum: one chunk
    (1 << 29, 1 << 26),         # the k = 13 shard count: 2^29 slots
    (1 << 29, 1 << 30),         # 4^15 bins
    ((1 << 29) + 5, 1 << 26),
    (1 << 25, 1 << 24),         # a stream chunk
])
def test_partition_plan_chunks_stay_under_the_cap(n, size, monkeypatch):
    plan = histogram.partition_plan(n, size, 132)
    pieces = -(-n // plan.chunk)
    assert plan.scratch_bytes <= histogram.PARTITION_SCRATCH_CAP
    assert plan.scratch_bytes >= 2 * plan.chunk  # a bucket slot a position
    assert plan.chunk <= 1 << 30
    if pieces > 1:
        assert plan.chunk % 16 == 0  # every chunk starts aligned alike
        assert (pieces - 1) * plan.chunk < n
    assert pieces == (1 if 2 * n < histogram.PARTITION_SCRATCH_CAP - (
        plan.scratch_bytes - 2 * plan.chunk) else 2)
    monkeypatch.setattr(histogram, "PARTITION_SCRATCH_CAP", 64 << 20)
    small = histogram.partition_plan(n, size, 132)
    assert small.scratch_bytes <= 64 << 20 and small.chunk < plan.chunk
    with pytest.raises(ValueError):
        histogram.partition_plan(n, (1 << 30) + 1, 132)


@pytest.mark.parametrize("bad", ["strided values", "strided valid",
                                 "size 2^31", "size -1", "devices differ"])
def test_histogram_refuses_what_the_kernel_does_not_take(bad):
    v = torch.zeros(64, dtype=torch.int32)
    m = torch.ones(64, dtype=torch.bool)
    size = 10
    if bad == "strided values":
        v = torch.zeros(128, dtype=torch.int32)[::2]
    elif bad == "strided valid":
        m = torch.ones(128, dtype=torch.bool)[::2]
    elif bad == "size 2^31":
        size = 1 << 31
    elif bad == "size -1":
        size = -1
    else:
        m = torch.ones(64, dtype=torch.bool, device="meta")
    before = histogram.histogram_launches
    for fn in (histogram.histogram, histogram_plain):
        with pytest.raises(ValueError):
            fn(v, m, size)
    with pytest.raises(ValueError):
        histogram.histogram_kernel(v, m, size, "cluster")
    assert histogram.histogram_launches == before


def test_histogram_kernel_refuses_cpu_tensors():
    """On the CPU the wrapper takes the plain version; the kernel itself
    runs only on CUDA tensors and raises for anything else."""
    v = torch.arange(64, dtype=torch.int32)
    m = torch.ones(64, dtype=torch.bool)
    for form in histogram.FORMS:
        with pytest.raises(ValueError, match="unsupported device"):
            histogram.histogram_kernel(v, m, 100, form)
    got = histogram.histogram(v.reshape(8, 8), m.reshape(8, 8), 100)
    assert torch.equal(got, histogram_plain(v, m, 100))


# ---------------------------------------------------- the pm screen

def test_run_lengths_match_jax():
    rng = np.random.default_rng(8)
    x = np.sort(rng.integers(0, 300, 5000)).astype(np.int32)
    head = np.concatenate([[True], x[1:] != x[:-1]])
    want = np.asarray(jax_run_lengths(jnp.asarray(head), head.shape[0]))
    got = pmscreen._run_lengths(torch.from_numpy(head))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,strategy", [
    (10, "packed"), (12, "packed"), (13, "packed"),
    (14, "packed"), (15, "smallv"), (12, "smallv"),
])
def test_pm_sort_screen_matches_jax(k, strategy):
    rng = np.random.default_rng(300 + k)
    seq = _plant(
        random_seq(rng, 30_000, n_prob=0.004),
        [(4000, "AG", 250), (15000, "CCTGA", 120), (24000, "T", 400)],
    )
    _, codes, kv, jc, jkv = _codes(seq, k)
    want = ref.pm_sort_screen(jc, jkv, k, strategy=strategy)
    got = pmscreen.pm_sort_screen(codes, kv, k, strategy=strategy)
    _same_screen(got, want)
    # a list capacity below the qualifying runs: truncated, count kept
    want = ref.pm_sort_screen(jc, jkv, k, strategy=strategy, list_cap=3)
    got = pmscreen.pm_sort_screen(codes, kv, k, strategy=strategy,
                                  list_cap=3)
    _same_screen(got, want)
    listed = int((got["list_codes"] >= 0).sum())
    assert listed == min(3, int(got["list_count"]))


def _check_against_sparse_oracle(seq, k, scr, codes, kv):
    """Every valid position's pm (device value, or list value for the -1
    sentinel) and the value histogram equal the sparse oracle's."""
    ucodes, ucounts, nk = count_spectrum_sparse(seq, k)
    assert int(scr["total"]) == nk
    v_vals, n_codes, lcodes, lpm = _pm_host_tables(
        _host_out(scr, nk), scr["t_list"])
    tv, tn = np.unique(ucounts, return_counts=True)
    assert np.array_equal(v_vals, tv) and np.array_equal(n_codes, tn)
    pm_u, _, _ = sparse_mass(ucodes, ucounts)
    kvn = kv.numpy()
    cn = codes.numpy()[kvn].astype(np.int64)
    want = pm_u[np.searchsorted(ucodes, cn)]
    pm = scr["pm"].numpy()[kvn].astype(np.int64)
    dev = pm >= 0
    assert np.array_equal(pm[dev], want[dev])
    qi = np.searchsorted(lcodes, cn[~dev])
    assert np.array_equal(lcodes[qi], cn[~dev])
    assert np.array_equal(lpm[qi], want[~dev])
    assert int(scr["list_count"]) == int((ucounts >= scr["t_list"]).sum())


@pytest.mark.parametrize("case", ["poly", "allN", "tiny", "alternating"])
def test_pm_screen_adversarial_inputs(case):
    k = 12
    seq = {"poly": "A" * 4096, "allN": "N" * 4096,
           "tiny": "ACGTACGTACGTA", "alternating": "AG" * 2048}[case]
    _, codes, kv, jc, jkv = _codes(seq, k, 512 if len(seq) >= 512 else 16)
    got = pmscreen.pm_sort_screen(codes, kv, k)
    _same_screen(got, ref.pm_sort_screen(jc, jkv, k))
    if case == "allN":
        assert int(got["total"]) == 0 and int(got["list_count"]) == 0
    else:
        _check_against_sparse_oracle(seq, k, got, codes, kv)


def test_extract_list_group_size_repair():
    """k = 15, packed strategy: t_list = 3 and stride 2 take the group-min
    compaction.  The two smallest codes (A^15 and A^14 C) both occur three
    times, so their run heads sit at sorted positions 0 and 3.  The
    reference's groups of 4 hold both heads and lose one record (its host
    tables then raise); the port's groups of 2 keep both."""
    k = 15
    rng = np.random.default_rng(15)
    seq = "N".join(["A" * 15 + "C"] * 3 + [random_seq(rng, 3000),
                                         "AG" * 200, random_seq(rng, 2000)])
    _, codes, kv, jc, jkv = _codes(seq, k)
    assert pmscreen.pm_params(k, "packed")[1:3] == (3, 2)
    scr = pmscreen.pm_sort_screen(codes, kv, k, strategy="packed")
    skey = torch.sort(torch.where(kv, codes, 1 << 30)).values
    assert skey[:6].tolist() == [0, 0, 0, 1, 1, 1]
    assert set(scr["list_codes"].tolist()) >= {0, 1}
    _check_against_sparse_oracle(seq, k, scr, codes, kv)
    want = ref.pm_sort_screen(jc, jkv, k, strategy="packed")
    assert 1 not in np.asarray(want["list_codes"]).tolist()
    with pytest.raises(AssertionError, match="mass mismatch"):
        jax_host_tables({
            "total": int(want["total"]), "vh": np.asarray(want["vh"]),
            "list_codes": np.asarray(want["list_codes"]).astype(np.int64),
            "list_v": np.asarray(want["list_v"]).astype(np.int64)},
            want["t_list"])


def test_pm_scores_int_matches_jax():
    rng = np.random.default_rng(4)
    for total in (0, 1, 7, 30_011, 123_456_789, (1 << 31) - 1):
        pm = rng.integers(-1, max(total, 1), 5000).astype(np.int32)
        pm[:3] = [-1, 0, max(total - 1, 0)]
        for thr in (0.6, 0.75, 0.93):
            thr_q = int(np.floor(np.float32(thr) * np.float32(4096))) - 1
            want = ref.pm_scores_int(jnp.asarray(pm), jnp.int32(total),
                                     jnp.int32(thr_q))
            got = pmscreen.pm_scores_int(
                torch.from_numpy(pm), torch.tensor(total, dtype=torch.int32),
                torch.tensor(thr_q, dtype=torch.int32))
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), np.asarray(want))
