"""The port's host library (csrc/host/kmerspans_host.cpp through
utils/native.py) for the native backend: ks_spans (find_spans), ks_pack
(pack_nbases) and ks_count_sparse (host_spectrum_sparse), held bit for bit
to the JAX package's binding of native/kmerspans_native.cpp and to the
port's sequential oracle, on the cases of tests/test_native.py."""

import numpy as np
import pytest

from kmer_spans_tpu.utils import native as jax_native
from kmer_spans_tpu_torch import oracle
from kmer_spans_tpu_torch.encoding import pack
from kmer_spans_tpu_torch.utils import native
from kmer_spans_tpu_torch.utils.testgen import spectrum_checksum

from conftest import random_seq


@pytest.fixture(scope="module")
def ref():
    """The JAX package's binding, whose library the root conftest.py
    builds before any test worker starts."""
    assert jax_native.available()
    return jax_native


def _nbases(seq):
    p = pack(seq)
    nb = p.bases.copy()
    nb[~p.valid] = 4
    return nb


def _ranks(seq, k):
    counts, n = oracle.count_spectrum(seq, k)
    return oracle.weighted_ranks(counts, float(n))


def _same_spans(got, want):
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    if want[3] is None:
        assert got[3] is None
    else:
        assert got[3].dtype == want[3].dtype
        assert np.array_equal(got[3], want[3])


def _as_regions(spans, seq_id=0):
    beg, end, score, _ = spans
    return [(seq_id, int(b), int(e), float(s))
            for b, e, s in zip(beg, end, score)]


def test_pack_nbases_equals_the_reference(ref):
    raw = np.frombuffer(b"ACGTnNWacgtSUryk-*\x00\xff" * 50, dtype=np.uint8)
    got = native.pack_nbases(raw)
    assert got.dtype == np.uint8
    assert np.array_equal(got, ref.pack_nbases(raw))
    assert list(got[:11]) == [0, 1, 3, 2, 4, 4, 3, 0, 1, 3, 2]
    p = pack(raw.tobytes())
    assert np.array_equal(got, np.where(p.valid, p.bases, 4))


def test_spans_golden(ref, golden):
    nb = _nbases(golden)
    counts, n = native.count_spectrum(nb, 8)
    assert n == 99_993 and spectrum_checksum(counts) == 6585132732039205817
    ranks = oracle.weighted_ranks(counts, float(n))
    got = native.find_spans(nb, 8, ranks, 0.75, 100, 20.0)
    _same_spans(got, ref.find_spans(nb, 8, ranks, 0.75, 100, 20.0))
    assert list(got[0]) == [20008, 50008, 80007]
    assert list(got[1]) == [20600, 50900, 80400]
    assert [round(s, 6) for s in got[2]] == [137.923657, 214.364008,
                                             96.947531]
    assert _as_regions(got) == oracle.find_regions(golden, 0, 100, 20.0,
                                                   ranks, 8, 0.75)


@pytest.mark.parametrize("k", [2, 4, 8, 12])
@pytest.mark.parametrize("seed", [0, 1])
def test_spans_random_bit_identical(ref, k, seed):
    rng = np.random.default_rng(50 + 10 * k + seed)
    s = list(random_seq(rng, 12_000, n_prob=0.01))
    s[3000:3400] = "GA" * 200
    s[7000:7330] = "TTC" * 110
    seq = "".join(s)
    ranks = _ranks(seq, k)
    nb = _nbases(seq)
    for thr, mw, ms in [(0.5, 5, 2.0), (0.75, 3, 0.5), (0.75, 100, 20.0)]:
        got = native.find_spans(nb, k, ranks, thr, mw, ms)
        _same_spans(got, ref.find_spans(nb, k, ranks, thr, mw, ms))
        assert _as_regions(got) == oracle.find_regions(seq, 0, mw, ms,
                                                       ranks, k, thr)


def test_scan_counts(ref):
    rng = np.random.default_rng(77)
    seq = random_seq(rng, 3_000, n_prob=0.02)
    w = rng.normal(0.2, 1.0, size=16)
    want_sc = np.zeros(16, dtype=np.int64)
    want = oracle.find_regions(seq, 0, 2, 0.5, w, 2, 0.0,
                               scan_counts=want_sc)
    got = native.find_spans(_nbases(seq), 2, w, 0.0, 2, 0.5,
                            want_scan_counts=True)
    _same_spans(got, ref.find_spans(_nbases(seq), 2, w, 0.0, 2, 0.5,
                                    want_scan_counts=True))
    assert _as_regions(got) == want
    assert got[3].sum() > 3_000  # rescans counted again
    assert np.array_equal(got[3], want_sc)


def test_neg_inf_weights(ref):
    """A -inf weight (log2_median's zero-count k-mer) resets the score."""
    rng = np.random.default_rng(4)
    seq = random_seq(rng, 5_000) + "AC" * 200 + random_seq(rng, 3_000)
    w = rng.normal(-0.1, 0.5, size=64)
    w[[5, 17, 40]] = -np.inf
    got = native.find_spans(_nbases(seq), 3, w, 0.0, 20, 3.0)
    _same_spans(got, ref.find_spans(_nbases(seq), 3, w, 0.0, 20, 3.0))
    assert _as_regions(got) == oracle.find_regions(seq, 0, 20, 3.0, w, 3)


def test_capacity_growth(ref):
    """More than 1024 regions: the buffers grow and the call repeats."""
    rng = np.random.default_rng(3)
    chunks = []
    for _ in range(1500):
        chunks.append(random_seq(rng, 120))
        chunks.append("AG" * 25)
    seq = "".join(chunks)
    ranks = _ranks(seq, 2)
    nb = _nbases(seq)
    got = native.find_spans(nb, 2, ranks, 0.5, 5, 1.0,
                            want_scan_counts=True)
    assert got[0].size > 1024
    _same_spans(got, ref.find_spans(nb, 2, ranks, 0.5, 5, 1.0,
                                    want_scan_counts=True))
    assert _as_regions(got) == oracle.find_regions(seq, 0, 5, 1.0, ranks,
                                                   2, 0.5)


@pytest.mark.parametrize("k", [16, 17, 23])
def test_host_spectrum_sparse_equals_the_reference(ref, k):
    rng = np.random.default_rng(k)
    nb = rng.integers(0, 4, 150_000).astype(np.uint8)
    nb[rng.random(150_000) < 0.003] = 4
    nb[20_000:21_000] = np.tile(np.array([0, 3], np.uint8), 500)
    got = native.host_spectrum_sparse(nb, k)
    want = ref.host_spectrum_sparse(nb, k)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == np.int64 and np.array_equal(g, w)
    for threads in (1, 3):
        again = native.host_spectrum_sparse(nb, k, threads=threads)
        assert again[2] == got[2]
        assert all(np.array_equal(a, b) for a, b in zip(again[:2], got[:2]))
    p = pack(np.where(nb < 4, np.frombuffer(b"ACTG", np.uint8)[nb & 3],
                      ord("N")).astype(np.uint8))
    sparse = oracle.count_spectrum_sparse(p, k)
    assert sparse[2] == got[2]
    assert all(np.array_equal(a, b) for a, b in zip(sparse[:2], got[:2]))
