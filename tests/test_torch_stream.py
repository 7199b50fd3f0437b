"""The port's streaming span pipeline against the JAX package's, by branch.

The same seeded chunks (islands and N gaps across the chunk edges) go
through kmer_spans_tpu_torch.parallel.stream (device="cpu": the kernels'
plain versions) and kmer_spans_tpu.parallel.stream (JAX on the CPU, its
Pallas kernels in interpret mode), in each scan branch: K4 (k = 3, 4 at
block 512; k = 9), K2 (k = 4, 8 at block 1024), the row gather (k = 11)
and the affine row gather (weight, threshold and log2-median models).
Spectra and per-chunk block summaries are equal, regions have exact
beg/end and f64 scores == JAX's and the sequential oracle's, and
``unresolved`` is equal.  The top C is compared only where JAX's f32
ordering is exact (no carry, every partial sum below 2^24); the port
orders by the exact int64 composition seeded by the carry.
"""

import numpy as np
import pytest

from kmer_spans_tpu.parallel.stream import StreamingSpanPipeline as JaxStream
from kmer_spans_tpu_torch.encoding import kmer_to_code, pack
from kmer_spans_tpu_torch.models.scoring import (
    Log2MedianScoring,
    ScoringModel,
    ThresholdScoring,
    WeightScoring,
)
from kmer_spans_tpu_torch.oracle import (
    count_spectrum,
    find_regions,
    weighted_ranks,
)
from kmer_spans_tpu_torch.parallel.stream import StreamingSpanPipeline

from conftest import random_seq


def nbases_of(seq):
    p = pack(seq)
    nb = p.bases.copy()
    nb[~p.valid] = 4
    return nb


def chunks_of(nb, chunk):
    def factory():
        for i in range(0, len(nb), chunk):
            yield nb[i:i + chunk]
    return factory


def planted(seed, n, unit="AG", islands=(7800, 16000, 30500, 40900),
            n_prob=0.003, gaps=()):
    """Random bases with 700-base repeat islands and N gaps at the given
    positions (chosen across chunk edges)."""
    rng = np.random.default_rng(seed)
    s = list(random_seq(rng, n, n_prob=n_prob))
    for pos in islands:
        s[pos:pos + 700] = (unit * 700)[:700]
    for pos in gaps:
        s[pos:pos + 150] = "N" * 150
    return "".join(s)


def record(pipe):
    """Wrap pipe._finish_chunk to keep each chunk's summaries, top C and
    incoming carry (the same leading arguments in both packages)."""
    rec = []
    orig = pipe._finish_chunk

    def wrapped(*a, **kw):
        tA, tB, maxA, maxB, top_idx, _, x_in = a[:7]
        rec.append({"tA": np.array(tA), "tB": np.array(tB),
                    "maxA": np.array(maxA), "maxB": np.array(maxB),
                    "top_idx": np.array(top_idx), "x_in": int(x_in)})
        return orig(*a, **kw)

    pipe._finish_chunk = wrapped
    return rec


def f32_exact(r) -> bool:
    """JAX's f32 composition of this chunk is exact: no carry, and every
    partial sum an integer below 2^24."""
    sent = -(1 << 29)
    big = (np.abs(r["tA"].astype(np.int64)).sum()
           + max(np.abs(np.where(r["tB"] <= sent, 0, r["tB"])).max(),
                 np.abs(r["maxA"]).max(),
                 np.abs(np.where(r["maxB"] <= sent, 0, r["maxB"])).max()))
    return r["x_in"] == 0 and big < (1 << 24)


def both(seq, k, chunk, block, cand=32, margin=4, thr=0.75, mw=30,
         ms=5.0, scoring=None):
    """(port result, JAX result, port records, JAX records, port pipe)."""
    nb = nbases_of(seq)
    pipe = StreamingSpanPipeline(k, chunk_bases=chunk, block=block,
                                 cand_blocks=cand, margin_blocks=margin,
                                 device="cpu")
    ref = JaxStream(k, chunk_bases=chunk, block=block, cand_blocks=cand,
                    margin_blocks=margin)
    rec, ref_rec = record(pipe), record(ref)
    got = pipe.run(chunks_of(nb, chunk), thr, mw, ms, scoring=scoring)
    want = ref.run(chunks_of(nb, chunk), thr, mw, ms, scoring=scoring)
    return got, want, rec, ref_rec, pipe


def assert_equal_to_jax(got, want, rec, ref_rec):
    assert np.array_equal(got.counts_host, np.asarray(want.counts_host))
    assert got.n_kmers == want.n_kmers
    assert len(rec) == len(ref_rec)
    compared = 0
    for r, w in zip(rec, ref_rec):
        for f in ("tA", "tB", "maxA", "maxB"):
            assert np.array_equal(r[f], w[f]), f
        assert r["x_in"] == w["x_in"]
        if f32_exact(w):
            assert np.array_equal(r["top_idx"], w["top_idx"])
            compared += 1
    assert got.regions == want.regions
    assert got.unresolved == want.unresolved
    return compared


def oracle_regions(seq, k, thr, mw, ms):
    counts, n = count_spectrum(seq, k)
    return find_regions(seq, 0, mw, ms, weighted_ranks(counts, float(n)), k,
                        thr)


@pytest.mark.parametrize("k,chunk,block", [
    (3, 8192, 512),     # K4, k <= 3
    (4, 8192, 512),     # K4, block < 1024
    (4, 16384, 1024),   # K2
    (8, 16384, 1024),   # K2
    (9, 8192, 512),     # K4, k = 9
    (11, 8192, 512),    # row gather
])
def test_rank_stream_equals_jax_and_oracle(k, chunk, block):
    seq = planted(k, 50_000, gaps=(16300, 24500))
    got, want, rec, ref_rec, pipe = both(seq, k, chunk, block)
    assert got.unresolved == []
    assert pipe.pull_batches == 0
    assert_equal_to_jax(got, want, rec, ref_rec)
    expect = oracle_regions(seq, k, 0.75, 30, 5.0)
    assert len(expect) >= 3
    assert sorted(got.regions) == sorted(expect)


def _weight_model(counts, total):
    w = np.full(16, -0.6)
    w[kmer_to_code("AG")] = 1.0
    w[kmer_to_code("GA")] = 1.0
    return WeightScoring(w)


def _threshold_model(counts, total):
    return ThresholdScoring(counts, 6e-3)


def _log2_model(counts, total):
    m = Log2MedianScoring(counts)
    return ScoringModel(weights=m.weights, threshold=0.25)


@pytest.mark.parametrize("seed,k,scoring,ms", [
    (1, 2, _weight_model, 5.0),
    (2, 4, _threshold_model, 5.0),
    (3, 4, _log2_model, 10.0),
])
def test_model_stream_equals_jax_and_oracle(seed, k, scoring, ms):
    """The affine row gather, on tests/test_stream_scoring.py's genomes."""
    seq = planted(seed, 50_000)
    got, want, rec, ref_rec, _ = both(seq, k, 8192, 512, ms=ms,
                                      scoring=scoring)
    assert got.unresolved == []
    assert_equal_to_jax(got, want, rec, ref_rec)
    counts, n = count_spectrum(seq, k)
    model = scoring(counts, n)
    expect = find_regions(seq, 0, 30, ms, model.weights, k, model.threshold)
    assert len(expect) >= 3
    assert sorted(got.regions) == sorted(expect)


def test_top_c_compared_where_jax_is_exact():
    """Some chunks open with no carry and small sums: there the top C of
    both packages is the same list."""
    seq = planted(5, 32_768, islands=(2000, 11000, 19000), n_prob=0.0)
    got, want, rec, ref_rec, _ = both(seq, 4, 8192, 512, cand=8)
    assert assert_equal_to_jax(got, want, rec, ref_rec) >= 2


def test_golden_genome_in_one_chunk(golden):
    nb = nbases_of(golden)
    pipe = StreamingSpanPipeline(8, chunk_bases=1 << 17, block=1024,
                                 cand_blocks=64, margin_blocks=8,
                                 device="cpu")
    res = pipe.run(chunks_of(nb, 1 << 17), 0.75, 100, 20.0)
    assert res.unresolved == []
    assert res.regions == [
        (0, 20008, 20600, 137.92365715607448),
        (0, 50008, 50900, 214.36400798067262),
        (0, 80007, 80400, 96.94753132724108)]
