"""The port's exact api path against the JAX package's device path.

kmer_counts, kmer_regions, kmer_low_comp_regions(mode="exact") (the
default), kmer_spans and the spectrum files, on seeded inputs through both
packages (JAX on the CPU, its K3 in interpret mode).  Integers must be
equal and f64 scores == (no tolerance: both replay the same f64 weights in
the same order).  log2_median is held against the reference's host
oracle, since the reference's device path fails on it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kmer_spans_tpu import api as ref_api
from kmer_spans_tpu import oracle as ref_oracle
from kmer_spans_tpu.io.fasta import write_fasta
from kmer_spans_tpu_torch import api
from kmer_spans_tpu_torch.utils import native

from conftest import random_seq


def _same(got, want, fields=("n", "counts", "regions", "w_rank")):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w), f


def _seqs(seed, k=8):
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(3):
        s = list(random_seq(rng, 5_000 + 2_500 * i, n_prob=0.003))
        s[1000:1600] = "CAG" * 200
        seqs.append("".join(s))
    seqs.insert(1, "ACG")  # shorter than most k: skipped, keeps its seq_id
    return seqs


# ------------------------------------------------------------ kmer_counts

@pytest.mark.parametrize("k", [1, 2, 3, 8, 9, 10])
def test_kmer_counts_equal_jax(k):
    seqs = _seqs(k)
    got = api.kmer_counts(seqs, k, device="cpu")
    want = ref_api.kmer_counts(seqs, k, backend="jax")
    assert got.n == want.n and got.k == want.k == k
    assert got.counts.dtype == want.counts.dtype == np.int64
    assert np.array_equal(got.counts, want.counts)
    assert np.array_equal(got.f, want.f)
    host = ref_api.kmer_counts(seqs, k, backend="host")
    assert got.n == host.n and np.array_equal(got.counts, host.counts)


def test_kmer_counts_result_and_edges(golden):
    assert [f.name for f in dataclasses.fields(api.KmerCountResult)] == \
        [f.name for f in dataclasses.fields(ref_api.KmerCountResult)]
    got = api.kmer_counts(golden, 8, device="cpu")
    assert got.n == 99_993
    none = api.kmer_counts(["AC", "NNNN"], 3, with_f=False, device="cpu")
    assert none.n == 0 and not none.counts.any() and none.f is None
    for k in (0, 16):
        with pytest.raises(ValueError):
            api.kmer_counts(golden, k, device="cpu")


# ----------------------------------------------------------- kmer_regions

def test_kmer_regions_cpg_weights_equal_jax():
    seq = "ATATATAT" + "CG" * 10 + "ATATATATATAT"
    scores = {km: (3.0 if km == "CG" else -1.0) for km in api.kmer_seq(2)}
    got = api.kmer_regions(seq, 2, scores, 4, 5.0, device="cpu")
    want = ref_api.kmer_regions(seq, 2, scores, 4, 5.0, backend="jax")
    _same(got, want, ("n", "counts", "regions"))
    assert len(got.regions) == 1 and got.n[0] == len(seq)


def test_kmer_regions_random_weights_equal_jax(rng):
    seqs = [random_seq(rng, 2000, n_prob=0.02) for _ in range(2)]
    w = dict(zip(api.kmer_seq(2), rng.normal(0.3, 1.0, size=16)))
    got = api.kmer_regions(seqs, 2, w, 2, 0.5, device="cpu")
    want = ref_api.kmer_regions(seqs, 2, w, 2, 0.5, backend="jax")
    _same(got, want, ("n", "counts", "regions"))
    host = ref_api.kmer_regions(seqs, 2, w, 2, 0.5, backend="host")
    _same(got, host, ("n", "counts", "regions"))
    assert len(got.regions) > 2


def test_kmer_regions_min_score_nonpositive_equal_jax():
    """min_score <= 0: every positive excursion is a candidate."""
    rng = np.random.default_rng(123)
    s = list("".join(rng.choice(list("ACGT"), 30_000)))
    s[9000:9400] = "CG" * 200
    seq = "".join(s)
    scores = {a + b: (1.5 if a + b == "CG" else -0.4)
              for a in "ACGT" for b in "ACGT"}
    got = api.kmer_regions([seq], 2, scores, 40, -5.0, device="cpu")
    want = ref_api.kmer_regions([seq], 2, scores, 40, -5.0, backend="jax")
    _same(got, want, ("n", "counts", "regions"))
    host = ref_api.kmer_regions([seq], 2, scores, 40, -5.0, backend="host")
    _same(got, host, ("n", "counts", "regions"))


def test_kmer_regions_array_table_and_validation():
    rng = np.random.default_rng(3)
    seq = random_seq(rng, 6000)
    table = rng.normal(-0.2, 1.0, 64)
    got = api.kmer_regions(seq, 3, table, 10, 2.0, device="cpu")
    want = ref_api.kmer_regions(seq, 3, table, 10, 2.0, backend="jax")
    _same(got, want, ("n", "counts", "regions"))
    with pytest.raises(ValueError):
        api.kmer_regions("ACGT", 2, {"AA": 1.0}, 1, 1.0, device="cpu")
    with pytest.raises(ValueError):
        api.kmer_regions("ACGT", 2, np.zeros(15), 1, 1.0, device="cpu")
    with pytest.raises(ValueError):
        api.kmer_regions("ACGT", 16, {}, 1, 1.0, device="cpu")


# ------------------------------------------- kmer_low_comp_regions, exact

def test_golden_exact_is_the_default_and_equals_jax(golden):
    got = api.kmer_low_comp_regions(golden, 8, 100, 20.0, device="cpu")
    regs = got.regions
    assert list(regs["beg"]) == [20008, 50008, 80007]
    assert list(regs["end"]) == [20600, 50900, 80400]
    assert [round(s, 6) for s in regs["score"]] == [
        137.923657, 214.364008, 96.947531]
    want = ref_api.kmer_low_comp_regions(golden, 8, 100, 20.0,
                                         backend="jax", mode="exact")
    _same(got, want)
    host = ref_api.kmer_low_comp_regions(golden, 8, 100, 20.0,
                                         backend="host")
    _same(got, host)


@pytest.mark.parametrize("k,thr", [(1, 0.5), (3, 0.8), (6, 0.7), (10, 0.75)])
def test_multi_sequence_exact_equals_jax(k, thr):
    seqs = _seqs(100 + k)
    got = api.kmer_low_comp_regions(seqs, k, 50, 8.0, thr=thr, device="cpu")
    want = ref_api.kmer_low_comp_regions(seqs, k, 50, 8.0, thr=thr,
                                         backend="jax")
    _same(got, want)
    if k > 1:
        assert len(got.regions) >= 3


def test_exact_mode_validation(golden):
    with pytest.raises(ValueError):
        api.kmer_low_comp_regions(golden, 8, 100, 20.0, thr=1.0,
                                  device="cpu")
    with pytest.raises(ValueError):
        api.kmer_low_comp_regions(golden, 8, 100, 20.0, mode="slow",
                                  device="cpu")


# ------------------------------------------------------------ kmer_spans

@pytest.mark.parametrize("scoring", ["rank", "threshold"])
def test_kmer_spans_equal_jax(golden, scoring):
    got = api.kmer_spans(golden, 8, scoring=scoring, device="cpu")
    want = ref_api.kmer_spans(golden, 8, scoring=scoring, backend="jax")
    _same(got, want)
    assert len(got.regions) >= 1


def test_kmer_spans_threshold_with_f_t_equals_jax(golden):
    got = api.kmer_spans(golden, 8, scoring="threshold", min_score=50.0,
                         f_t=10 / 99_993, device="cpu")
    want = ref_api.kmer_spans(golden, 8, scoring="threshold", min_score=50.0,
                              f_t=10 / 99_993, backend="jax")
    _same(got, want)
    assert list(got.regions["beg"]) == [20008, 50008, 80007]


@pytest.mark.parametrize("which", ["golden", "multi"])
def test_kmer_spans_log2_median_equals_the_oracle(golden, which):
    """Zero-count k-mers weigh -inf: the reference's device path raises
    (quantize_weight_table's int(log2(... / inf))); its host oracle and the
    port agree bit for bit."""
    seqs = golden if which == "golden" else _seqs(5)
    k = 8 if which == "golden" else 6
    got = api.kmer_spans(seqs, k, scoring="log2_median", min_width=30,
                         min_score=5.0, device="cpu")
    want = ref_api.kmer_spans(seqs, k, scoring="log2_median", min_width=30,
                              min_score=5.0, backend="host")
    _same(got, want)
    assert len(got.regions) >= 1
    with pytest.raises(OverflowError):
        ref_api.kmer_spans(seqs, k, scoring="log2_median", min_width=30,
                           min_score=5.0, backend="jax")


def test_kmer_spans_weights_and_unknown(golden):
    w = dict(zip(api.kmer_seq(2), np.linspace(-1.0, 0.5, 16)))
    got = api.kmer_spans(golden[:20_000], 2, scoring="weights",
                         kmer_scores=w, min_width=10, min_score=3.0,
                         device="cpu")
    want = ref_api.kmer_spans(golden[:20_000], 2, scoring="weights",
                              kmer_scores=w, min_width=10, min_score=3.0,
                              backend="jax")
    _same(got, want, ("n", "counts", "regions"))
    with pytest.raises(ValueError):
        api.kmer_spans(golden, 8, scoring="weights", device="cpu")
    with pytest.raises(ValueError):
        api.kmer_spans(golden, 8, scoring="entropy", device="cpu")


def test_kmer_seq_equals_jax():
    for k in (1, 3, 5):
        assert api.kmer_seq(k) == ref_api.kmer_seq(k)


# ---------------------------------------------- the RankScoring route

@pytest.mark.parametrize("path", ["native", "numpy"])
def test_rank_route_is_weighted_ranks_bit_for_bit(path, monkeypatch):
    """The port's RankScoring takes its weights from host_rank_chain; at
    4^10 entries (2^20, where the host library serves the chain) they
    are weighted_ranks bit for bit, and so are the host backend's, which
    take the oracle's numpy chain and must not load the library."""
    rng = np.random.default_rng(10)
    counts = rng.poisson(0.3, 1 << 20).astype(np.int64)
    counts[rng.integers(0, 1 << 20, 40)] = rng.integers(1000, 50_000, 40)
    total = float(counts.sum())
    if path == "numpy":
        def never():
            raise AssertionError("the host library was loaded")

        monkeypatch.setattr(native, "_load", never)
    else:
        assert native.available()
    if path == "native":
        got = api.RankScoring(counts, total, 0.75)
    else:
        got = api._rank_scoring(api.KmerCountResult(10, total, counts), 0.75,
                                "host")
    want = ref_api.RankScoring(counts, total, 0.75)
    assert got.threshold == want.threshold
    assert np.array_equal(got.weights.view(np.int64),
                          want.weights.view(np.int64))


# --------------------------------------------------------- spectrum files

def test_kmers_to_file_roundtrip(tmp_path, golden):
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", golden), ("short", golden[:500])])
    got = api.kmers_to_file(str(fa), str(tmp_path / "port_"), [2, 8],
                            min_l=1000, device="cpu")
    want = ref_api.kmers_to_file(str(fa), str(tmp_path / "ref_"), [2, 8],
                                 min_l=1000, backend="jax")
    assert got[2:] == want[2:] == (100_500, 100_000, 1)
    with open(got[1], "rb") as a, open(want[1], "rb") as b:
        assert a.read() == b.read()
    back = api.read_kmers(got[1])
    assert back["k"] == [2, 8]
    assert np.array_equal(back["counts"][1],
                          api.kmer_counts(golden, 8, device="cpu").counts)
    assert api.kmers_to_file(str(fa), str(tmp_path / "x_"), 3,
                             min_l=10 ** 6, device="cpu")[1] is None
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"\x00" * 16)
    assert api.read_kmers(str(bad)) is None


# --------------------------------------------------------------- devices

def test_exact_path_on_cuda_without_card_raises(golden):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: api.kmer_counts(golden, 8),
                 lambda: api.kmer_low_comp_regions(golden, 8, 100, 20.0),
                 lambda: api.kmer_spans(golden, 8),
                 lambda: api.kmer_regions(golden, 2, np.zeros(16), 4, 1.0)):
        with pytest.raises(RuntimeError):
            call()


def test_oracle_scan_counts_are_what_kmer_regions_counts():
    """kmer_regions' counts are the oracle's scan counts (rescans twice)."""
    rng = np.random.default_rng(8)
    seq = list(random_seq(rng, 8000))
    seq[2000:2400] = "CG" * 200
    seq = "".join(seq)
    w = rng.normal(-0.5, 1.0, 16)
    w[6] = 2.5
    got = api.kmer_regions(seq, 2, w, 10, 3.0, device="cpu")
    sc = np.zeros(16, np.int64)
    regs = ref_oracle.find_regions(seq, 0, 10, 3.0, w, 2, 0.0, scan_counts=sc)
    assert np.array_equal(got.counts, sc)
    assert [tuple(r)[:4] for r in got.regions] == regs
