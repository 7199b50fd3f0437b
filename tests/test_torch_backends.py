"""The port's api under backend="host" and "native" against the JAX api
under the same backend, and against the port's own device path with
device="cpu" (the kernels' plain versions): integer arrays exact, f64
scores ==.  The cases of tests/test_api.py, and the backend rules:
"jax" and unknown names raise ValueError, "native" without its library
raises RuntimeError (and runs nothing else), "auto" with device="cuda"
and no card raises, "host"/"native" never touch the card, the device
path raises RuntimeError where the host library does not build, and
"host" answers without loading it."""

import dataclasses

import numpy as np
import pytest
import torch

from kmer_spans_tpu import api as ref_api
from kmer_spans_tpu.io.fasta import write_fasta
from kmer_spans_tpu_torch import api, oracle
from kmer_spans_tpu_torch.encoding import kmer_to_code
from kmer_spans_tpu_torch.utils import native
from kmer_spans_tpu_torch.utils.testgen import spectrum_checksum

from conftest import random_seq

BACKENDS = ["host", "native"]
CHECKSUM8 = 6585132732039205817


def _same(got, want):
    """Every field of two api results equal (arrays exactly, f64 ==)."""
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if w is None or isinstance(w, (int, float, list)):
            if isinstance(w, list) and w and isinstance(w[0], np.ndarray):
                assert len(g) == len(w)
                assert all((a is None and b is None) or np.array_equal(a, b)
                           for a, b in zip(g, w))
            else:
                assert g == w, f.name
        else:
            assert g.dtype == w.dtype, f.name
            assert np.array_equal(g, w), f.name


def _same_regions(got, want):
    assert got.regions.dtype == want.regions.dtype
    assert np.array_equal(got.regions, want.regions)


@pytest.fixture(scope="module")
def seqs():
    rng = np.random.default_rng(11)
    out = []
    for i in range(3):
        s = list(random_seq(rng, 5_000 + 700 * i, n_prob=0.01))
        s[1200:1800] = "CAG" * 200
        out.append("".join(s))
    out.insert(1, "AC")  # shorter than k: skipped, keeps its seq_id
    return out


@pytest.fixture(scope="module")
def golden_low_comp_cpu(golden):
    return api.kmer_low_comp_regions(golden, 8, 100, 20.0, thr=0.75,
                                     device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_kmer_counts(golden, backend):
    got = api.kmer_counts(golden, 8, backend=backend)
    assert got.n == 99_993 and spectrum_checksum(got.counts) == CHECKSUM8
    _same(got, ref_api.kmer_counts(golden, 8, backend=backend))
    _same(got, api.kmer_counts(golden, 8, device="cpu"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_kmer_counts_skips_short_seqs(backend):
    r = api.kmer_counts(["ACGTACGT", "AC", "ACNGT"], 3, backend=backend)
    r2 = api.kmer_counts(["ACGTACGT"], 3, backend=backend)
    assert r.n == r2.n == 6 and np.array_equal(r.counts, r2.counts)
    _same(r, ref_api.kmer_counts(["ACGTACGT", "AC", "ACNGT"], 3,
                                 backend=backend))
    with pytest.raises(ValueError):
        api.kmer_counts("ACGT", 16, backend=backend)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_low_comp_golden(golden, golden_low_comp_cpu, backend, mode):
    """Under a CPU backend both modes run the exact host path, as in the
    reference."""
    got = api.kmer_low_comp_regions(golden, 8, 100, 20.0, thr=0.75,
                                    backend=backend, mode=mode)
    regs = got.regions
    assert list(regs["beg"]) == [20008, 50008, 80007]
    assert list(regs["end"]) == [20600, 50900, 80400]
    assert list(regs["score"]) == [137.92365715607448, 214.36400798067262,
                                   96.94753132724108]
    assert got.n[0] == 99_993 and got.n[1] == 0
    _same(got, ref_api.kmer_low_comp_regions(golden, 8, 100, 20.0, thr=0.75,
                                             backend=backend, mode=mode))
    _same(got, golden_low_comp_cpu)


@pytest.mark.parametrize("backend", BACKENDS)
def test_low_comp_multi_sequence(seqs, backend):
    got = api.kmer_low_comp_regions(seqs, 4, 10, 1.0, thr=0.5,
                                    backend=backend)
    _same(got, ref_api.kmer_low_comp_regions(seqs, 4, 10, 1.0, thr=0.5,
                                             backend=backend))
    _same(got, api.kmer_low_comp_regions(seqs, 4, 10, 1.0, thr=0.5,
                                         device="cpu"))
    assert len(got.regions) and 1 not in set(got.regions["seq_id"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_low_comp_k1_in_fast_mode_runs_the_exact_host_path(backend):
    seq = "ACGT" * 50 + "A" * 80 + "CGTA" * 40
    got = api.kmer_low_comp_regions(seq, 1, 10, 2.0, thr=0.5,
                                    backend=backend, mode="fast")
    _same(got, ref_api.kmer_low_comp_regions(seq, 1, 10, 2.0, thr=0.5,
                                             backend=backend, mode="fast"))
    _same(got, api.kmer_low_comp_regions(seq, 1, 10, 2.0, thr=0.5,
                                         device="cpu"))
    assert len(got.regions) == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_kmer_regions_cpg_weights(backend):
    seq = "ATATATAT" + "CG" * 10 + "ATATATATATAT"
    scores = {km: (3.0 if km == "CG" else -1.0) for km in api.kmer_seq(2)}
    got = api.kmer_regions(seq, 2, scores, 4, 5.0, backend=backend)
    assert len(got.regions) == 1 and got.n[0] == len(seq)
    assert got.counts.sum() >= len(seq) - 2
    _same(got, ref_api.kmer_regions(seq, 2, scores, 4, 5.0, backend=backend))
    _same(got, api.kmer_regions(seq, 2, scores, 4, 5.0, device="cpu"))


@pytest.mark.parametrize("min_score", [0.5, 0.0, -5.0])
@pytest.mark.parametrize("backend", BACKENDS)
def test_kmer_regions_scan_counts(seqs, backend, min_score):
    """Scan counts (rescans counted again) and regions, with min_score <= 0
    too, where every excursion wide enough is a region."""
    rng = np.random.default_rng(5)
    w = dict(zip(api.kmer_seq(2), rng.normal(0.1, 1.0, size=16)))
    got = api.kmer_regions(seqs, 2, w, 2, min_score, backend=backend)
    _same(got, ref_api.kmer_regions(seqs, 2, w, 2, min_score,
                                    backend=backend))
    _same(got, api.kmer_regions(seqs, 2, w, 2, min_score, device="cpu"))
    assert len(got.regions)


@pytest.mark.parametrize("backend", BACKENDS)
def test_kmer_regions_validates_scores(backend):
    with pytest.raises(ValueError):
        api.kmer_regions("ACGT", 2, {"AA": 1.0}, 1, 1.0, backend=backend)
    with pytest.raises(ValueError):
        api.kmer_regions("ACGT", 16, np.zeros(4), 1, 1.0, backend=backend)


@pytest.mark.parametrize("order", ["two-bit", "alphabetical"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_lr_regions(backend, order):
    seq = "ATATATATCGCGCGCGCGCGATATATATATATATATCGCGCG"
    kmers = api.kmer_seq(2)
    if order == "alphabetical":
        kmers = sorted(kmers)
    ks = [2.0 if km == "CG" else -1.0 for km in kmers]
    ts = [2.0 if km == "CG" else -0.5 for km in kmers]
    got = api.lr_regions([seq, "AC", seq[::-1]], (2, 4), kmers, ks, ts,
                         backend=backend)
    r = got.regions[0]
    assert (r["seq_id"], r["beg"], r["end"], r["score"]) == (1, 10, 20, 9.5)
    assert tuple(got.kmer_scores[kmer_to_code("CG")]) == (2.0, 2.0)
    _same(got, ref_api.lr_regions([seq, "AC", seq[::-1]], (2, 4), kmers, ks,
                                  ts, backend=backend))
    _same(got, api.lr_regions([seq, "AC", seq[::-1]], (2, 4), kmers, ks, ts,
                              device="cpu"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_lr_regions_genome(golden, backend):
    kmers = api.kmer_seq(3)
    ks = [1.0 if km in ("AGA", "GAG", "CAG") else -0.6 for km in kmers]
    ts = [0.8 if km in ("AGA", "GAG", "CAG", "AGC", "GCA") else -0.5
          for km in kmers]
    got = api.lr_regions(golden[:60_000], (3, 100), kmers, ks, ts,
                         backend=backend)
    assert len(got.regions) == 2
    _same(got, ref_api.lr_regions(golden[:60_000], (3, 100), kmers, ks, ts,
                                  backend=backend))
    _same(got, api.lr_regions(golden[:60_000], (3, 100), kmers, ks, ts,
                              device="cpu"))


@pytest.mark.parametrize("backend", BACKENDS)
def test_window_kmer_dist(backend):
    seqs = ["CGCCAATGCG", "AC", "CGCGNNACGTCGAT"]
    got = api.window_kmer_dist(seqs, ["CG", "GC"], 6, freq=False,
                               ret_flag=1, backend=backend)
    assert list(got.seq_i) == [1, 0, 1]  # the second: shorter than 6
    assert got.scores[1] is None and got.dist.sum(axis=0).tolist() == [8, 8]
    assert list(got.scores[0][:, 0][:5]) == [1, 0, 0, 0, 1]
    for freq, flag in ((False, 1), (True, 0)):
        got = api.window_kmer_dist(seqs, ["CG", "GC"], 6, freq=freq,
                                   ret_flag=flag, backend=backend)
        _same(got, ref_api.window_kmer_dist(seqs, ["CG", "GC"], 6, freq=freq,
                                            ret_flag=flag, backend=backend))
        _same(got, api.window_kmer_dist(seqs, ["CG", "GC"], 6, freq=freq,
                                        ret_flag=flag, device="cpu"))
    with pytest.raises(ValueError):
        api.window_kmer_dist("ACGTACGT", ["CG", "CGG"], 6, backend=backend)
    with pytest.raises(ValueError):
        api.window_kmer_dist("ACGTACGT", ["CG"], 3, backend=backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_kmers_to_file(tmp_path, golden, backend):
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", golden), ("short", golden[:500])])
    got = api.kmers_to_file(str(fa), str(tmp_path) + "/port_", [2, 8],
                            min_l=1000, backend=backend)
    want = ref_api.kmers_to_file(str(fa), str(tmp_path) + "/jax_", [2, 8],
                                 min_l=1000, backend=backend)
    assert got[2:] == want[2:] == (100_500, 100_000, 1)
    with open(got[1], "rb") as a, open(want[1], "rb") as b:
        assert a.read() == b.read()
    back = api.read_kmers(got[1])
    assert back["k"] == [2, 8]
    assert spectrum_checksum(back["counts"][1]) == CHECKSUM8
    missing = api.kmers_to_file(str(tmp_path / "none.fa"), "x", 4,
                                backend=backend)
    assert missing == (str(tmp_path / "none.fa"), None, 0, 0, 0)


@pytest.mark.parametrize("scoring", ["rank", "threshold", "log2_median",
                                     "weights"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_kmer_spans(golden, backend, scoring):
    """Every scoring; log2_median (a -inf weight at each absent k-mer) too,
    where the port's device path equals the oracle (the reference's
    device path raises there)."""
    kw = dict(min_width=100, min_score=20.0, thr=0.75)
    if scoring == "threshold":
        kw.update(min_score=50.0, f_t=10 / 99_993)
    if scoring == "weights":
        island = {"AGAGAGAG", "GAGAGAGA"}
        kw["kmer_scores"] = np.array(
            [1.5 if km in island else -0.4 for km in api.kmer_seq(8)])
    got = api.kmer_spans(golden, 8, scoring=scoring, backend=backend, **kw)
    _same(got, ref_api.kmer_spans(golden, 8, scoring=scoring,
                                  backend=backend, **kw))
    _same(got, api.kmer_spans(golden, 8, scoring=scoring, device="cpu",
                              **kw))
    if scoring in ("rank", "threshold"):
        assert list(got.regions["beg"]) == [20008, 50008, 80007]
    assert len(got.regions)
    with pytest.raises(ValueError):
        api.kmer_spans(golden, 8, scoring="bogus", backend=backend)


@pytest.mark.parametrize("k", [16, 17, 23])
@pytest.mark.parametrize("backend", BACKENDS)
def test_kmer_wide_regions(golden, backend, k):
    seqs = [golden[:45_000], "ACGT" * 3, golden[45_000:]]
    got = api.kmer_wide_regions(seqs, k, 100, 20.0, backend=backend)
    want = ref_api.kmer_wide_regions(seqs, k, 100, 20.0, backend=backend)
    _same(got, want)
    assert len(got.regions) == 3 and set(got.regions["seq_id"]) == {0, 2}
    dev = api.kmer_wide_regions(seqs, k, 100, 20.0, device="cpu")
    _same(got, dev)
    # the CPU path always counts the spectrum, as the reference's does
    bare = api.kmer_wide_regions(seqs, k, 100, 20.0, backend=backend,
                                 with_spectrum=False)
    _same(bare, got)
    empty = api.kmer_wide_regions(["ACGT"], k, 100, 20.0, backend=backend)
    _same(empty, ref_api.kmer_wide_regions(["ACGT"], k, 100, 20.0,
                                           backend=backend))


# ------------------------------------------------------------ backend rules

def _calls(backend):
    """One call of each of the eight api functions with a backend."""
    kms = api.kmer_seq(2)
    return {
        "kmer_counts": lambda: api.kmer_counts("ACGTACGT", 2,
                                               backend=backend),
        "kmer_regions": lambda: api.kmer_regions(
            "ACGTACGT", 2, np.zeros(16), 1, 1.0, backend=backend),
        "kmer_low_comp_regions": lambda: api.kmer_low_comp_regions(
            "ACGTACGT", 2, 1, 1.0, backend=backend),
        "kmer_spans": lambda: api.kmer_spans("ACGTACGT", 2, backend=backend),
        "kmer_wide_regions": lambda: api.kmer_wide_regions(
            "ACGT" * 10, 16, 1, 1.0, backend=backend),
        "lr_regions": lambda: api.lr_regions(
            "ACGTACGT", (2, 1), kms, np.zeros(16), np.zeros(16),
            backend=backend),
        "window_kmer_dist": lambda: api.window_kmer_dist(
            "ACGTACGT", ["CG"], 4, backend=backend),
        "kmers_to_file": lambda: api.kmers_to_file(
            "missing.fa", "x", 2, backend=backend),
    }


@pytest.mark.parametrize("backend", ["jax", "gpu", "", "HOST"])
@pytest.mark.parametrize("fn", sorted(_calls("auto")))
def test_unknown_backends_raise(fn, backend):
    with pytest.raises(ValueError, match="backend"):
        _calls(backend)[fn]()


@pytest.mark.parametrize("fn", sorted(_calls("auto")))
def test_native_without_the_library_raises(fn, monkeypatch):
    """No fallback to the oracle: nothing of it runs."""
    def never(*a, **kw):
        raise AssertionError("the host oracle ran")

    def no_library():
        raise RuntimeError("the host library did not build or load")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load", no_library)
    for name in ("count_spectrum", "count_spectrum_sparse", "find_regions",
                 "find_tr_regions", "windowed_distributions"):
        monkeypatch.setattr(oracle, name, never)
    with pytest.raises(RuntimeError, match="native backend unavailable"):
        _calls("native")[fn]()


@pytest.mark.parametrize("fn", sorted(_calls("auto")))
def test_auto_with_cuda_and_no_card_raises(fn, monkeypatch):
    """"auto" runs the device path on device="cuda" (the default): with no
    card it raises, and no CPU backend serves the call."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _calls("auto")[fn]()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("fn", sorted(_calls("auto")))
def test_cpu_backends_never_touch_the_card(fn, backend, monkeypatch):
    def never(*a, **kw):
        raise AssertionError("torch.cuda was called")

    for name in ("is_available", "current_device", "synchronize",
                 "device_count"):
        monkeypatch.setattr(torch.cuda, name, never)
    _calls(backend)[fn]()  # device="cuda", the default, is not used


# ------------------------------------------------ the host library's place

def _island_seq():
    """10 kb of the golden genome around its first repeat island."""
    return oracle.golden_genome()[15_000:25_000]


def _folding_calls(device):
    """One call of each public call whose device path folds its
    candidates on the host, on a sequence with candidates."""
    from kmer_spans_tpu_torch.encoding import pack
    from kmer_spans_tpu_torch.parallel.stream import StreamingSpanPipeline

    seq = _island_seq()
    kms = api.kmer_seq(2)
    ks = [2.0 if km == "CG" else -1.0 for km in kms]
    ts = [2.0 if km == "CG" else -0.5 for km in kms]
    counts, n = oracle.count_spectrum(seq, 8)

    def stream():
        p = pack(seq)
        nb = np.where(p.valid, p.bases, 4).astype(np.uint8)
        pipe = StreamingSpanPipeline(8, chunk_bases=4096, block=512,
                                     cand_blocks=8, device=device)
        return pipe.run(lambda: (nb[i:i + 4096]
                                 for i in range(0, nb.size, 4096)),
                        0.75, 100, 20.0)

    return {
        "kmer_low_comp_regions_exact": lambda: api.kmer_low_comp_regions(
            seq, 8, 100, 20.0, device=device),
        "kmer_low_comp_regions_fast": lambda: api.kmer_low_comp_regions(
            seq, 8, 100, 20.0, mode="fast", device=device),
        "kmer_regions": lambda: api.kmer_regions(
            seq, 8, oracle.weighted_ranks(counts, n) - 0.75, 100, 20.0,
            device=device),
        "kmer_spans": lambda: api.kmer_spans(seq, 8, device=device),
        "lr_regions": lambda: api.lr_regions(
            "AT" * 300 + "CG" * 200 + "AT" * 300, (2, 20), kms, ks, ts,
            device=device),
        "kmer_wide_regions": lambda: api.kmer_wide_regions(
            seq, 17, 100, 20.0, device=device),
        "stream": stream,
    }


def _regions_of(res):
    got = res.regions
    return got.tolist() if isinstance(got, np.ndarray) else got


@pytest.mark.parametrize("fn", sorted(_folding_calls("cpu")))
def test_device_path_raises_without_the_library(fn, monkeypatch, tmp_path):
    """The device path folds on the host in the library and has no numpy
    fold beside it: with the library each call finds regions; where the
    library does not build (no compiler), it raises RuntimeError with
    the compiler's failure."""
    assert _regions_of(_folding_calls("cpu")[fn]())
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        _folding_calls("cpu")[fn]()


def _host_calls(backend, tmp_path):
    """The api's calls under a CPU backend at sizes where the device
    path's host code would take the library: k = 10 (a 2^20-entry rank
    chain) and wide k (the sparse chain)."""
    seq = _island_seq()
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("g", seq)])
    kms = api.kmer_seq(2)
    zeros = np.zeros(16)
    return {
        "kmer_counts": lambda: api.kmer_counts(seq, 10, backend=backend),
        "kmer_regions": lambda: api.kmer_regions(
            seq, 2, np.arange(16) / 8.0 - 1.0, 5, 1.0, backend=backend),
        "kmer_low_comp_regions": lambda: api.kmer_low_comp_regions(
            seq, 10, 100, 20.0, backend=backend),
        "kmer_spans": lambda: api.kmer_spans(seq, 10, backend=backend),
        "kmer_wide_regions": lambda: api.kmer_wide_regions(
            seq, 17, 100, 20.0, backend=backend),
        "lr_regions": lambda: api.lr_regions(seq, (2, 20), kms, zeros + 1.0,
                                             zeros - 0.5, backend=backend),
        "window_kmer_dist": lambda: api.window_kmer_dist(
            seq, ["CG", "AT"], 200, backend=backend),
        "kmers_to_file": lambda: api.kmers_to_file(
            str(fa), str(tmp_path / "k_"), 4, backend=backend),
    }


@pytest.mark.parametrize("fn", sorted(_calls("host")))
def test_host_answers_without_the_library(fn, monkeypatch, tmp_path):
    """backend="host" is the route without a C++ compiler: it never loads
    the host library, and answers what "native" answers."""
    want = _host_calls("native", tmp_path)[fn]()

    def never():
        raise AssertionError("the host library was loaded")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load", never)
    got = _host_calls("host", tmp_path)[fn]()
    if isinstance(want, tuple):
        assert got == want
    else:
        _same(got, want)
