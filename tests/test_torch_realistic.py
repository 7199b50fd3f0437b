"""The port on the realistic-composition genome (the reference's
real-assembly validation, test.R:104-106, :572-590; tests/test_realistic.py
for the JAX package): the port's own utils/testgen.realistic_genome,
array-equal to the JAX package's, through the port's fast paths (k = 8,
the fused class screen; k = 12, the pm screen), its exact path and its
native backend, each equal to the JAX host oracle's regions bit for bit;
counts three ways."""

import numpy as np
import pytest

from kmer_spans_tpu import api as ref_api
from kmer_spans_tpu.encoding import PackedSeq as RefPackedSeq
from kmer_spans_tpu.utils.testgen import realistic_genome as ref_realistic
from kmer_spans_tpu_torch import api
from kmer_spans_tpu_torch.encoding import PackedSeq, kmer_to_code
from kmer_spans_tpu_torch.utils import native
from kmer_spans_tpu_torch.utils.testgen import realistic_genome


@pytest.fixture(scope="module")
def genome():
    g = realistic_genome(1_500_000, seed=7)
    assert g.dtype == np.uint8 and g.shape == (1_500_000,)
    return g


def _packed(nb, cls=PackedSeq):
    return cls(bases=np.where(nb == 4, 0, nb).astype(np.uint8), valid=nb != 4)


def test_genome_equals_the_reference(genome):
    assert np.array_equal(genome, ref_realistic(1_500_000, seed=7))
    assert np.array_equal(realistic_genome(300_000, seed=3),
                          ref_realistic(300_000, seed=3))


@pytest.fixture(scope="module")
def oracle_regions(genome):
    """The JAX host oracle's regions at k = 8 and 12, each run once."""
    p = _packed(genome, RefPackedSeq)
    out = {}
    for k in (8, 12):
        res = ref_api.kmer_low_comp_regions(p, k, 100, 20.0, thr=0.75,
                                            backend="host", mode="exact")
        out[k] = res
    return out


def _triples(res):
    return [(int(r["beg"]), int(r["end"]), float(r["score"]))
            for r in res.regions]


def test_composition_and_cpg_depletion(genome):
    res = api.kmer_counts(_packed(genome), 2, with_f=True, backend="host")
    counts = res.counts.astype(np.float64)
    total = counts.sum()
    mono = np.zeros(4)
    for c in range(16):
        mono[c >> 2] += counts[c] / 2
        mono[c & 3] += counts[c] / 2
    mono /= mono.sum()
    assert 0.36 < mono[1] + mono[3] < 0.46  # GC ~ 41 %
    cg = counts[kmer_to_code("CG")] / total
    assert 0.1 < cg / (mono[1] * mono[3]) < 0.4  # CpG obs/exp


def test_counts_three_ways(genome, oracle_regions):
    """The oracle ("host"), the host library (native.host_spectrum and
    "native") and the device path's plain versions: the same k = 6
    spectrum, equal to the JAX host oracle's."""
    p = _packed(genome)
    k = 6
    host = api.kmer_counts(p, k, backend="host")
    dev = api.kmer_counts(p, k, device="cpu")
    nat = api.kmer_counts(p, k, backend="native")
    want = ref_api.kmer_counts(_packed(genome, RefPackedSeq), k,
                               backend="host")
    for got in (host, dev, nat):
        assert got.n == want.n and np.array_equal(got.counts, want.counts)
    counts_n, nw = native.host_spectrum(genome.copy(), k)
    assert np.array_equal(counts_n, want.counts)
    assert nw == int(want.counts.sum())
    # the k = 8 and 12 spectra of the oracle runs, from the device path
    for kk in (8, 12):
        got = api.kmer_counts(p, kk, device="cpu")
        assert np.array_equal(got.counts, oracle_regions[kk].counts)


@pytest.mark.parametrize("k", [8, 12])
def test_spans_fast_exact_and_native_equal_the_oracle(genome,
                                                      oracle_regions, k):
    p = _packed(genome)
    want = oracle_regions[k]
    assert len(want.regions) >= (2 if k == 8 else 1)
    if k == 8:  # the (AC)n microsatellite at 200k is called
        assert any(b <= 200_101 and e >= 200_200
                   for b, e, _ in _triples(want))
    fast = api.kmer_low_comp_regions(p, k, 100, 20.0, thr=0.75,
                                     mode="fast", device="cpu")
    assert _triples(fast) == _triples(want)
    assert np.array_equal(fast.counts, want.counts)
    for res in (api.kmer_low_comp_regions(p, k, 100, 20.0, thr=0.75,
                                          device="cpu"),
                api.kmer_low_comp_regions(p, k, 100, 20.0, thr=0.75,
                                          backend="native")):
        assert np.array_equal(res.regions, want.regions)
        assert np.array_equal(res.counts, want.counts)
        assert np.array_equal(res.w_rank, want.w_rank)
