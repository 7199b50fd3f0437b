"""The port stands alone: it imports nothing of the JAX package.

kmer_spans_tpu_torch keeps its own copies of the host code it needs
(encoding, oracle, stats.ranks, models.scoring, io, spans.extract and the
host C++ library behind utils.native).  This file holds that no module of the port, nor
chip_smoke.py, imports jax or kmer_spans_tpu, and that every copy gives
what its original gives on the same seeded inputs.  The host library is
held against the reference's numpy paths (the oracle, ``kmer_codes_np``,
``cumulative_mass``, ``extract_spans``, ``chain_ranks_from_mass``), to
which the reference holds its own binding (tests/test_native.py); no
test here loads that binding.
"""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from kmer_spans_tpu import api as ref_api
from kmer_spans_tpu import config as ref_config
from kmer_spans_tpu import encoding as ref_encoding
from kmer_spans_tpu import oracle as ref_oracle
from kmer_spans_tpu.io import fasta as ref_fasta
from kmer_spans_tpu.io import spectrum_file as ref_spectrum_file
from kmer_spans_tpu.models import scoring as ref_scoring
from kmer_spans_tpu.spans import extract as ref_extract
from kmer_spans_tpu.stats import ranks as ref_ranks
from kmer_spans_tpu.utils import testgen as ref_testgen
from kmer_spans_tpu_torch import api, config, encoding, oracle
from kmer_spans_tpu_torch.io import fasta, spectrum_file
from kmer_spans_tpu_torch.models import scoring
from kmer_spans_tpu_torch.spans import extract
from kmer_spans_tpu_torch.stats import ranks
from kmer_spans_tpu_torch.utils import native, testgen

from conftest import random_seq

_ROOT = Path(__file__).resolve().parent.parent
_PORT = _ROOT / "kmer_spans_tpu_torch"


def _run(code: str, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(_ROOT))
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code), *args],
                          cwd=_ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


# ------------------------------------------------------------ isolation

def test_importing_the_port_and_chip_smoke_loads_no_jax_package():
    res = _run("""
        import importlib, pkgutil, sys
        import kmer_spans_tpu_torch as p
        mods = [m.name for m in pkgutil.walk_packages(
            p.__path__, "kmer_spans_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        assert {"kmer_spans_tpu_torch.cli",
                "kmer_spans_tpu_torch.parallel.stream",
                "kmer_spans_tpu_torch.ops.rowgather",
                "kmer_spans_tpu_torch.io.checkpoint",
                "kmer_spans_tpu_torch.utils.metrics",
                "kmer_spans_tpu_torch.ops.scan",
                "kmer_spans_tpu_torch.parallel.collectives",
                "kmer_spans_tpu_torch.parallel.multihost",
                "kmer_spans_tpu_torch.parallel.pipeline",
                "kmer_spans_tpu_torch.parallel.sharded",
                "kmer_spans_tpu_torch.parallel.sharded_scan",
                "kmer_spans_tpu_torch.parallel.wide_scan",
                "kmer_spans_tpu_torch.config",
                "kmer_spans_tpu_torch.utils.testgen"} <= set(mods), mods
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "kmer_spans_tpu"))
        assert not bad, bad
        print(len(mods))
    """)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout) >= 20  # every module of the port was imported


def test_the_multi_device_modules_load_no_jax_package():
    """The modules of the multi-device paths, and the test helper their
    rank workers run (tests/torch_ranks.py), import no JAX package."""
    res = _run("""
        import sys
        sys.path.insert(0, "tests")
        import torch_ranks
        import kmer_spans_tpu_torch.ops.scan
        import kmer_spans_tpu_torch.parallel.multihost
        import kmer_spans_tpu_torch.parallel.wide_scan
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "kmer_spans_tpu"))
        assert not bad, bad
        assert {"kmer_spans_tpu_torch.parallel." + m for m in (
            "collectives", "pipeline", "sharded", "sharded_scan")} <= set(
                sys.modules)
    """)
    assert res.returncode == 0, res.stderr


def test_config_testgen_and_the_host_backends_load_no_jax_package():
    """config.py, utils/testgen.py and the host library's bindings, and
    the api driven through backend="host" and "native", import no JAX
    package."""
    res = _run("""
        import sys
        from kmer_spans_tpu_torch import api
        from kmer_spans_tpu_torch.config import SpanConfig
        from kmer_spans_tpu_torch.utils import native, testgen
        SpanConfig().validate()
        g = testgen.golden_genome()
        for backend in ("host", "native"):
            r = api.kmer_low_comp_regions(g, 8, 100, 20.0, backend=backend)
            assert list(r.regions["beg"]) == [20008, 50008, 80007]
        assert native.pack_nbases(testgen.realistic_genome(2000, 1) + 65
                                  ).shape == (2000,)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "kmer_spans_tpu"))
        assert not bad, bad
    """)
    assert res.returncode == 0, res.stderr


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(_PORT.rglob("*.py")) + [_ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(_ROOT)))
def test_no_source_imports_the_jax_package(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "kmer_spans_tpu"}


# ------------------------------------------------------------ the copies

@pytest.fixture(scope="module")
def genomes(golden):
    rng = np.random.default_rng(77)
    s = list(random_seq(rng, 40_000, n_prob=0.003))
    s[9000:9700] = "TC" * 350
    s[25000:25450] = "A" * 450
    return {"golden": golden, "random": "".join(s)}


@pytest.mark.parametrize("cls", ["SpanConfig", "CountConfig", "WindowConfig"])
def test_config_fields_and_defaults_equal_the_reference(cls):
    got = {f.name: f.default for f in dataclasses.fields(getattr(config, cls))}
    want = {f.name: f.default
            for f in dataclasses.fields(getattr(ref_config, cls))}
    if cls != "WindowConfig":
        # the port's stand-in for the reference's backend="jax"
        assert got.pop("device") == "cuda"
    assert got == want
    assert config.SpanConfig().backend == "auto"


@pytest.mark.parametrize("kw", [
    {}, {"k": 8}, {"k": 0}, {"k": 15}, {"k": 16}, {"thr": 1.5},
    {"thr": 0.0}, {"thr": 1.5, "scoring": "threshold"},
    {"chunk_bases": 1000, "block": 512}, {"chunk_bases": 1024, "block": 512},
])
def test_span_config_validate_rejects_what_the_reference_rejects(kw):
    try:
        ref_config.SpanConfig(**kw).validate()
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        cfg = config.SpanConfig(**kw)
        assert cfg.validate() is cfg
    else:
        with pytest.raises(ValueError) as e:
            config.SpanConfig(**kw).validate()
        assert str(e.value) == want


def test_testgen_equals_the_reference():
    assert testgen.lcg_bases(5000, 3) == ref_testgen.lcg_bases(5000, 3)
    assert testgen.golden_genome() == ref_testgen.golden_genome()
    assert oracle.golden_genome is testgen.golden_genome
    rng = np.random.default_rng(8)
    for counts in (rng.integers(0, 1 << 40, 4096), np.zeros(16, np.int64),
                   np.arange(300)):
        assert testgen.spectrum_checksum(counts) == \
            ref_testgen.spectrum_checksum(counts)
    got = testgen.realistic_genome(200_000, 11)
    want = ref_testgen.realistic_genome(200_000, 11)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_golden_genome_is_the_reference_string(golden):
    assert oracle.golden_genome() == ref_testgen.golden_genome() == golden
    assert oracle.golden_genome(3000, 7) == ref_testgen.golden_genome(3000, 7)


def test_pack_and_codes_equal_the_reference():
    raw = "ACGTNnacgtWSUryk" * 40 + "N" * 7 + "GATTACA" * 30
    got, want = encoding.pack(raw), ref_encoding.pack(raw)
    assert np.array_equal(got.bases, want.bases)
    assert np.array_equal(got.valid, want.valid)
    assert got.n == want.n == len(raw)
    for k in (1, 5, 15):
        for g, w in zip(encoding.kmer_codes_np(got, k),
                        ref_encoding.kmer_codes_np(want, k)):
            assert np.array_equal(g, w)
    assert encoding.MAX_K == ref_encoding.MAX_K


@pytest.mark.parametrize("k", [2, 8, 12])
@pytest.mark.parametrize("which", ["golden", "random"])
def test_oracle_equals_the_reference(genomes, which, k):
    seq = genomes[which]
    counts, n = oracle.count_spectrum(seq, k)
    want_counts, want_n = ref_oracle.count_spectrum(seq, k)
    assert n == want_n and np.array_equal(counts, want_counts)
    w = oracle.weighted_ranks(counts, float(n))
    assert np.array_equal(w, ref_oracle.weighted_ranks(counts, float(n)))
    thr = 0.8 if k == 2 else 0.75
    got = oracle.find_regions(seq, 3, 100, 20.0, w, k, thr)
    want = ref_oracle.find_regions(seq, 3, 100, 20.0, w, k, thr)
    assert got == want and got  # positions and f64 scores, bit for bit


def test_find_regions_scan_counts_equal_the_reference(genomes):
    seq, k = genomes["random"], 6
    counts, n = oracle.count_spectrum(seq, k)
    w = oracle.weighted_ranks(counts, float(n))
    sc = np.zeros(1 << (2 * k), np.int64)
    want_sc = np.zeros_like(sc)
    got = oracle.find_regions(seq, 0, 30, 5.0, w, k, 0.7, scan_counts=sc)
    want = ref_oracle.find_regions(seq, 0, 30, 5.0, w, k, 0.7,
                                   scan_counts=want_sc)
    assert got == want and np.array_equal(sc, want_sc)


@pytest.mark.parametrize("form", ["dense", "sparse"])
@pytest.mark.parametrize("seed", [0, 1])
def test_chain_ranks_from_mass_bit_for_bit(seed, form):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 40, 1 << 12).astype(np.int64)
    counts[rng.integers(0, 1 << 12, 50)] = rng.integers(1000, 90000, 50)
    total = int(counts.sum())
    pm = ref_ranks.cumulative_mass(counts)
    if form == "dense":
        vh = np.zeros(int(counts.max()) + 1, np.int64)
        np.add.at(vh, counts, counts)
    else:
        vals, ncodes = np.unique(counts, return_counts=True)
        vh = (vals, ncodes)
    got = ranks.chain_ranks_from_mass(pm, vh, total, chunk=1000)
    want = ref_ranks.chain_ranks_from_mass(pm, vh, total, chunk=1000)
    assert got.dtype == np.float64
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert np.array_equal(got, ref_oracle.weighted_ranks(counts, total))


@pytest.mark.parametrize("k", [6, 17, 23])
def test_sparse_spectrum_and_ranks_equal_the_reference(genomes, k):
    """count_spectrum_sparse, sparse_mass and SparseRanks (the wide-k
    oracle side), and the oracle's caller over a SparseRanks lookup."""
    seq = genomes["random"]
    got = oracle.count_spectrum_sparse(seq, k)
    want = ref_oracle.count_spectrum_sparse(seq, k)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    pm, (vv, vn), total = ranks.sparse_mass(*got[:2])
    wpm, (wvv, wvn), wtotal = ref_ranks.sparse_mass(*want[:2])
    assert total == wtotal and np.array_equal(pm, wpm)
    assert np.array_equal(vv, wvv) and np.array_equal(vn, wvn)
    sr, wsr = ranks.SparseRanks(*got[:2]), ref_ranks.SparseRanks(*want[:2])
    assert ranks.SparseRanks.sparse_lookup and sr.total == wsr.total
    assert np.array_equal(sr.lookup(got[0]).view(np.int64),
                          wsr.lookup(want[0]).view(np.int64))
    assert sr[int(got[0][5])] == wsr[int(want[0][5])]
    absent = int(got[0][-1]) + 1
    with pytest.raises(KeyError):
        sr[absent]
    with pytest.raises(KeyError):
        sr.lookup(np.array([absent]))
    regions = oracle.find_regions(seq, 0, 100, 20.0, sr, k, 0.75)
    assert regions and regions == ref_oracle.find_regions(
        seq, 0, 100, 20.0, wsr, k, 0.75)
    with pytest.raises(ValueError):
        oracle.count_spectrum_sparse(seq, 32)


def _never_loaded():
    raise AssertionError("the host library was loaded")


def test_chain_ranks_from_mass_native_fold_bit_for_bit(monkeypatch):
    """Above 2^22 terms the fold runs in the host library; it equals the
    chunked numpy fold (the oracle's SparseRanks takes it at every size;
    held to the reference above) and the reference's own numpy fold bit
    for bit."""
    from kmer_spans_tpu.utils import native as ref_native

    rng = np.random.default_rng(5)
    vals = np.array([1, 2, 3, 7, 300], np.int64)
    ncodes = np.array([3_000_000, 900_000, 400_000, 50_000, 11], np.int64)
    total = int((vals * ncodes).sum())
    below = np.concatenate([[0], np.cumsum(vals * ncodes)[:-1]])
    g = rng.integers(0, len(vals), 2000)
    pm = below[g] + vals[g] * rng.integers(0, ncodes[g])
    assert native.available()
    got = ranks.chain_ranks_from_mass(pm, (vals, ncodes), total)
    monkeypatch.setattr(native, "_load", _never_loaded)
    want = ranks._chain_fold(pm, vals, ncodes, total)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    monkeypatch.setattr(ref_native, "chain_from_hist", lambda *a: None)
    ref = ref_ranks.chain_ranks_from_mass(pm, (vals, ncodes), total)
    assert np.array_equal(got.view(np.int64), ref.view(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_extract_spans_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    s = rng.normal(-0.06, 0.3, 30_000)
    s[4000:4900] += 0.45
    s[20_000:20_300] += 0.6
    scored = rng.random(30_000) < 0.98
    v_got = np.zeros(30_001, np.int64)
    v_want = np.zeros(30_001, np.int64)
    got = extract.extract_spans(s, scored, 40, 5.0, seq_id=4,
                                visits_full=v_got)
    want = ref_extract.extract_spans(s, scored, 40, 5.0, seq_id=4,
                                     visits_full=v_want)
    assert got == want and got
    assert np.array_equal(v_got, v_want)


def test_kmer_strings_equal_the_reference():
    for k in (1, 4, 7):
        assert encoding.all_kmers(k) == ref_encoding.all_kmers(k)
    for km in ("A", "ACGT", "TTGCA", "gattaca", "GGGGGGGGGGGGGGG"):
        assert encoding.kmer_to_code(km) == ref_encoding.kmer_to_code(km)
    with pytest.raises(ValueError):
        encoding.all_kmers(16)


def _spectra():
    rng = np.random.default_rng(21)
    counts = rng.poisson(1.2, 1 << 10).astype(np.int64)
    counts[rng.integers(0, 1 << 10, 8)] = rng.integers(100, 5000, 8)
    return {"random": counts, "zeros": np.zeros(256, np.int64),
            "one": np.eye(1, 64, 17, dtype=np.int64)[0] * 9}


@pytest.mark.parametrize("which", ["random", "zeros", "one"])
def test_spectrum_stats_equal_the_reference(which):
    counts = _spectra()[which]
    assert ranks.spectrum_median_freq(counts) == \
        ref_ranks.spectrum_median_freq(counts)
    got, want = ranks.cumulative_mass(counts), ref_ranks.cumulative_mass(
        counts)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("which", ["random", "zeros", "one"])
def test_scoring_models_equal_the_reference(which):
    counts = _spectra()[which]
    total = float(counts.sum())
    rng = np.random.default_rng(3)
    w = rng.normal(size=counts.size)
    pairs = [
        (scoring.WeightScoring(w), ref_scoring.WeightScoring(w)),
        (scoring.ThresholdScoring(counts, 0.001),
         ref_scoring.ThresholdScoring(counts, 0.001)),
        (scoring.Log2MedianScoring(counts),
         ref_scoring.Log2MedianScoring(counts)),
    ]
    if total:
        pairs.append((scoring.RankScoring(counts, total, 0.7),
                      ref_scoring.RankScoring(counts, total, 0.7)))
    codes = rng.integers(0, counts.size, 50)
    for got, want in pairs:
        assert got.threshold == want.threshold
        assert got.weights.dtype == want.weights.dtype == np.float64
        assert np.array_equal(got.weights.view(np.int64),
                              want.weights.view(np.int64))  # -inf too
        assert np.array_equal(got.scores_for(codes), want.scores_for(codes))
    with pytest.raises(ValueError):
        scoring.RankScoring(counts, total, 1.0)


def test_io_copies_equal_the_reference(tmp_path):
    import gzip

    records = [("chr1", "ACGTN" * 50 + "ac"), ("s2", b"GGGATTACA"),
               ("empty", "")]
    fasta.write_fasta(tmp_path / "a.fa", records, width=7)
    ref_fasta.write_fasta(tmp_path / "b.fa", records, width=7)
    raw = (tmp_path / "a.fa").read_bytes()
    assert raw == (tmp_path / "b.fa").read_bytes()
    (tmp_path / "c.fa.gz").write_bytes(gzip.compress(
        b"; comment\n" + raw.replace(b"\n", b"\r\n")))
    for name in ("a.fa", "c.fa.gz"):
        path = str(tmp_path / name)
        assert fasta.read_fasta(path) == ref_fasta.read_fasta(path)
        got = fasta.read_fasta_packed(path, min_len=5)
        want = ref_fasta.read_fasta_packed(path, min_len=5)
        assert [n for n, _ in got] == [n for n, _ in want] == ["chr1", "s2"]
        for (_, g), (_, w) in zip(got, want):
            assert np.array_equal(g.bases, w.bases)
            assert np.array_equal(g.valid, w.valid)
    spectra = [np.arange(16), np.zeros(256, np.int64) + 7]
    spectrum_file.write_kmers(tmp_path / "x.bin", spectra)
    ref_spectrum_file.write_kmers(tmp_path / "y.bin", spectra)
    assert (tmp_path / "x.bin").read_bytes() == \
        (tmp_path / "y.bin").read_bytes()
    got = spectrum_file.read_kmers(tmp_path / "y.bin")
    want = ref_spectrum_file.read_kmers(tmp_path / "x.bin")
    assert got["k"] == want["k"] == [2, 4]
    for g, w in zip(got["counts"], want["counts"]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert spectrum_file.KMER_MAGIC == ref_spectrum_file.KMER_MAGIC
    (tmp_path / "bad.bin").write_bytes(b"\x01" * 12)
    assert spectrum_file.read_kmers(tmp_path / "bad.bin") is None
    with pytest.raises(OverflowError):
        spectrum_file.write_kmers(tmp_path / "z.bin", [np.array([1 << 31])])


@pytest.mark.parametrize("seed", [0, 1])
def test_extract_spans_takes_neg_inf(seed):
    """A -inf score resets the running score to 0, as in the sequential
    oracle (k = 1: one score a base, -inf at every T)."""
    rng = np.random.default_rng(seed)
    seq = list(random_seq(rng, 20_000, n_prob=0.002))
    seq[3000:3600] = "AC" * 300
    seq[3300] = "T"
    seq[9000:9900] = "CCA" * 300
    seq = "".join(seq)
    w = np.array([0.6, 0.5, -np.inf, -0.9])  # A, C, T, G
    want = ref_oracle.find_regions(seq, 2, 10, 4.0, w, 1, 0.0)
    p = encoding.pack(seq)
    scored = p.valid.copy()  # the last base of an N-free stretch is not
    scored[:-1] &= p.valid[1:]
    scored[-1] = False
    s = np.where(scored, w[p.bases], 0.0)
    got = extract.extract_spans(s, scored, 10, 4.0, seq_id=2)
    assert got == want and len(want) >= 3


def test_region_result_matches_the_reference(golden):
    assert [f.name for f in dataclasses.fields(api.RegionResult)] == \
        [f.name for f in dataclasses.fields(ref_api.RegionResult)]
    regions = [(0, 5, 90, 3.25), (2, 100, 400, 17.5)]
    got = api._as_region_array(regions)
    want = ref_api._as_region_array(regions)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    seqs = [golden[:5000], golden[5000:6000].encode(), "ACGN"]
    for g, w in zip(api._as_seq_list(seqs), ref_api._as_seq_list(seqs)):
        assert np.array_equal(g.bases, w.bases)
        assert np.array_equal(g.valid, w.valid)
    for mode in ("fast", "exact"):
        got = api.kmer_low_comp_regions(golden, 8, 100, 20.0, mode=mode,
                                        device="cpu")
        want = ref_api.kmer_low_comp_regions(golden, 8, 100, 20.0,
                                             backend="jax", mode=mode)
        for f in dataclasses.fields(ref_api.RegionResult):
            assert np.array_equal(getattr(got, f.name),
                                  getattr(want, f.name))


# ------------------------------------------------------- the host library

def _genome_nbases(seed, n=200_000):
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, 4, n).astype(np.uint8)
    nb[rng.random(n) < 0.002] = 4
    nb[5000:8000] = np.tile(np.array([0, 3], np.uint8), 1500)
    return nb


def test_host_library_builds_and_loads():
    assert native.available()
    assert native.library_path().exists()
    assert native.library_path().parent == native.BUILD_DIR


@pytest.mark.parametrize("k", [10, 13])
def test_host_spectrum_equals_the_reference(k):
    nb = _genome_nbases(k)
    got, n = native.host_spectrum(nb, k)
    # the reference binding's numpy path
    p = ref_encoding.PackedSeq(bases=nb & 3, valid=nb < 4)
    codes, kv = ref_encoding.kmer_codes_np(p, k)
    want = np.bincount(codes[kv], minlength=1 << (2 * k))
    assert n == int(kv.sum()) and np.array_equal(got, want)


def test_count_spectrum_equals_the_oracle():
    nb = _genome_nbases(3, 50_000)
    got, n = native.count_spectrum(nb, 7)
    seq = "".join("ACTGN"[b] for b in nb)
    want, want_n = ref_oracle.count_spectrum(seq, 7)
    assert n == want_n and np.array_equal(got, want)


@pytest.mark.parametrize("hi", [30, 100_000])
def test_rank_chain_bit_for_bit(hi):
    rng = np.random.default_rng(hi)
    counts = rng.integers(0, hi, 1 << 16).astype(np.int64)
    counts[rng.integers(0, 1 << 16, 30)] = 0
    total = int(counts.sum())
    got = native.rank_chain(counts, total)
    want = ref_oracle.weighted_ranks(counts, total)
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def test_mass_of_codes_equals_the_reference():
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 50, 1 << 14).astype(np.int32)
    counts[rng.integers(0, 1 << 14, 20)] = 70_000  # above the dense cap
    q = np.unique(rng.integers(0, 1 << 14, 3000)).astype(np.int64)
    pm, vv, vn = native.mass_of_codes(counts, q)
    assert np.array_equal(pm, ref_ranks.cumulative_mass(counts)[q])
    vals, ncodes = np.unique(counts, return_counts=True)
    assert np.array_equal(vv, vals) and np.array_equal(vn, ncodes)


def _scores(seed, n=40_000):
    rng = np.random.default_rng(seed)
    s = rng.normal(-0.05, 0.3, n)
    s[3000:3800] += 0.4
    s[30_000:30_500] += 0.5
    scored = rng.random(n) < 0.97
    return s, scored


@pytest.mark.parametrize("seed", [0, 1])
def test_replay_scores_equals_the_reference(seed):
    s, scored = _scores(seed)
    s_flat = np.where(scored, s, 0.0)
    beg, end, sc = native.replay_scores(s_flat, scored, 30, 5.0, 8192)
    got = [(int(b), int(e), float(v)) for b, e, v in zip(beg, end, sc)]
    want = [(b + 8192, e + 8192, v) for _, b, e, v in
            ref_extract.extract_spans(s_flat, scored, 30, 5.0)]
    assert got == want and got


@pytest.mark.parametrize("k", [4, 8])
def test_replay_packed_equals_the_reference(k):
    from kmer_spans_tpu_torch.spans.finish import rebuild_codes

    rng = np.random.default_rng(k)
    block, rows = 1024, 6
    # consecutive candidate blocks of one genome: k - 1 halo bases, then
    # per block a seed code (the k-mer ending at its first position) and
    # its bases, 16 a word
    full = rng.integers(0, 4, k - 1 + rows * block).astype(np.uint32)
    full[k - 1 + 2 * block:k - 1 + 2 * block + 600:2] = 3  # a repeat
    full[k + 2 * block:k - 1 + 2 * block + 600:2] = 0
    cw = np.zeros((rows, 1 + block // 16), np.uint32)
    for r in range(rows):
        for j in range(k):
            cw[r, 0] |= full[r * block + j] << np.uint32(2 * (k - 1 - j))
        b = full[k - 1 + r * block:k - 1 + (r + 1) * block].reshape(-1, 16)
        cw[r, 1:] = np.bitwise_or.reduce(
            b << (2 * np.arange(16, dtype=np.uint32)), axis=1)
    scored = rng.random((rows, block)) < 0.97
    counts = rng.integers(0, 60, 1 << (2 * k)).astype(np.int64)
    codes = rebuild_codes(cw, k, block)
    counts[np.unique(codes[2, 10:600])] += 300
    ranks_ = ref_oracle.weighted_ranks(counts, float(counts.sum()))
    beg, end, sc = native.replay_packed(cw, scored, block, k, ranks_, 0.7,
                                        20, 3.0, 4096)
    got = [(int(b), int(e), float(v)) for b, e, v in zip(beg, end, sc)]
    s = np.where(scored, ranks_[codes] - 0.7, 0.0).reshape(-1)
    want = [(b + 4096, e + 4096, v) for _, b, e, v in
            ref_extract.extract_spans(s, scored.reshape(-1), 20, 3.0)]
    assert got == want and got


def _no_compiler(monkeypatch, tmp_path):
    """The binding as it behaves where no C++ compiler is present."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))


def test_a_failed_build_is_not_remembered(monkeypatch, tmp_path):
    """No compiler: unavailable; a compiler again: the next call builds."""
    _no_compiler(monkeypatch, tmp_path)
    assert not native.available()
    monkeypatch.delenv("CXX")
    assert native.available()
    assert native.library_path().parent == tmp_path


#: one call of each entry point of the binding
_ENTRY_POINTS = {
    "pack_nbases": lambda: native.pack_nbases(np.zeros(10, np.uint8)),
    "count_spectrum": lambda: native.count_spectrum(
        np.zeros(10, np.uint8), 2),
    "host_spectrum": lambda: native.host_spectrum(np.zeros(10, np.uint8), 2),
    "host_spectrum_sparse": lambda: native.host_spectrum_sparse(
        np.zeros(40, np.uint8), 16),
    "chain_from_hist": lambda: native.chain_from_hist([1], [8], 8.0,
                                                      [0, 3]),
    "rank_chain": lambda: native.rank_chain(np.ones(8, np.int64), 8),
    "replay_scores": lambda: native.replay_scores(
        np.zeros(4), np.ones(4, bool), 1, 1.0, 0),
    "replay_tr": lambda: native.replay_tr(
        np.zeros(4, np.int32), np.ones(4, bool), np.zeros(4, bool),
        np.zeros(16), np.zeros(16), 0, 1),
    "mass_of_codes": lambda: native.mass_of_codes(np.ones(8, np.int32),
                                                  np.arange(3)),
    "replay_packed": lambda: native.replay_packed(
        np.zeros((1, 3), np.uint32), np.ones((1, 32), bool), 32, 2,
        np.zeros(16), 0.5, 1, 1.0, 0),
    "find_spans": lambda: native.find_spans(np.zeros(10, np.uint8), 2,
                                            np.zeros(16), 0.0, 1, 1.0),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_points_raise_without_a_compiler(name, monkeypatch,
                                               tmp_path):
    """No entry point returns None: where the library does not build,
    each raises RuntimeError with the compiler's failure; with it, each
    answers."""
    want = _ENTRY_POINTS[name]()
    assert want is not None
    _no_compiler(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        _ENTRY_POINTS[name]()


def test_two_processes_building_at_once_both_load_a_whole_file(tmp_path):
    code = """
        import sys
        from pathlib import Path
        import numpy as np
        from kmer_spans_tpu_torch.utils import native
        native.BUILD_DIR = Path(sys.argv[1])
        assert native.available()
        counts, n = native.count_spectrum(np.arange(200) % 4, 3)
        assert n == 198 and counts.sum() == 198
        print(native.library_path())
    """
    env = dict(os.environ, PYTHONPATH=str(_ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), str(tmp_path)],
        cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert sorted(f.name for f in tmp_path.iterdir()) == \
        [Path(paths.pop()).name]  # no temporary left behind
