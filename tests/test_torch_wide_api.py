"""The port's api.kmer_wide_regions (device="cpu", the kernels' plain
versions) against the JAX package's under both its backends, "jax" (the
device pipeline) and "host" (the sequential oracle over a sparse
spectrum): regions, spectrum codes and counts, n_words.

Where the wide device step overflows its run list or misses a candidate,
the JAX api serves the call with its CPU oracle; the port reruns on the
same device and counts the rerun in api.exact_fallbacks.  The regions are
the same either way.
"""

import dataclasses

import numpy as np
import pytest

from kmer_spans_tpu import api as ref_api
from kmer_spans_tpu.spans import pm_pipeline as ref_pm
from kmer_spans_tpu_torch import api

from conftest import random_seq
from test_pm_pipeline import _plant


def _seqs(seed, n=(40_000, 30_000)):
    rng = np.random.default_rng(seed)
    return [
        _plant(random_seq(rng, n[0], n_prob=0.002),
               [(6_000, "GATTACA", 200), (n[0] - 15_000, "AG", 400)]),
        "ACGT" * 3,  # shorter than k: skipped
        _plant(random_seq(rng, n[1]), [(n[1] - 18_000, "CCTGA", 260)]),
    ]


def _spy_on_jax_fallback(monkeypatch) -> list:
    """The fallback flag of each of JAX's wide device steps, in order."""
    flags = []
    ref_finish = ref_pm.finish_pm_spans

    def spy(*a, **kw):
        res = ref_finish(*a, **kw)
        flags.append(res.fallback)
        return res

    monkeypatch.setattr(ref_pm, "finish_pm_spans", spy)
    return flags


def _same(got, want):
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert got.regions.dtype == want.regions.dtype
    assert got.regions.tolist() == want.regions.tolist()
    assert np.array_equal(got.spectrum_codes, want.spectrum_codes)
    assert np.array_equal(got.spectrum_counts, want.spectrum_counts)
    assert got.n_words == want.n_words


@pytest.mark.parametrize("k", [16, 17, 23])
def test_equals_jax_under_both_backends(k, monkeypatch):
    monkeypatch.setattr(api, "exact_fallbacks", 0)
    seqs = _seqs(70 + k)
    got = api.kmer_wide_regions(seqs, k, 30, 5.0, thr=0.75, block=1024,
                                device="cpu")
    for backend in ("jax", "host"):
        _same(got, ref_api.kmer_wide_regions(seqs, k, 30, 5.0, thr=0.75,
                                             backend=backend, block=1024))
    assert api.exact_fallbacks == 0
    assert {int(r["seq_id"]) for r in got.regions} == {0, 2}
    assert got.spectrum_codes.dtype == got.spectrum_counts.dtype == np.int64


def test_without_the_spectrum(monkeypatch):
    seqs = _seqs(3)
    got = api.kmer_wide_regions(seqs, 17, 30, 5.0, block=1024, device="cpu",
                                with_spectrum=False)
    want = ref_api.kmer_wide_regions(seqs, 17, 30, 5.0, backend="jax",
                                     block=1024, with_spectrum=False)
    _same(got, want)
    assert got.spectrum_codes.size == 0 and got.n_words > 0


def test_list_overflow_reruns_where_jax_falls_back(monkeypatch):
    """A run list of 2 overflows: JAX's api goes to its CPU oracle, the
    port reruns with the list capacity doubled until the runs fit."""
    seqs = _seqs(11, n=(24_000, 20_000))
    monkeypatch.setattr(api, "exact_fallbacks", 0)
    make = api.make_wide_pm_pipeline
    caps = []

    def tiny_list(k, list_cap=None, **kw):
        caps.append(list_cap or 2)
        return make(k, list_cap=list_cap or 2, **kw)

    monkeypatch.setattr(api, "make_wide_pm_pipeline", tiny_list)
    got = api.kmer_wide_regions(seqs, 17, 30, 5.0, block=1024, device="cpu")
    assert len(caps) == 2 and caps[1] > 2 and api.exact_fallbacks == 1

    jax_fell_back = _spy_on_jax_fallback(monkeypatch)
    monkeypatch.setattr(
        ref_api, "_cached_wide_pm_pipeline",
        lambda k, block, cand: ref_pm.make_wide_pm_pipeline(
            k, block=block, cand_blocks=cand, list_cap=2))
    want = ref_api.kmer_wide_regions(seqs, 17, 30, 5.0, backend="jax",
                                     block=1024)
    assert jax_fell_back == [True]
    _same(got, want)
    assert len(got.regions) >= 3


def test_candidate_miss_reruns_where_jax_falls_back(monkeypatch):
    """C = 1 misses candidate blocks: JAX's api goes to its CPU oracle,
    the port reruns with twice the candidates until none is missed."""
    seqs = _seqs(12, n=(24_000, 20_000))
    monkeypatch.setattr(api, "exact_fallbacks", 0)
    got = api.kmer_wide_regions(seqs, 16, 30, 5.0, block=1024,
                                cand_blocks=1, device="cpu")
    assert api.exact_fallbacks >= 2
    jax_fell_back = _spy_on_jax_fallback(monkeypatch)
    want = ref_api.kmer_wide_regions(seqs, 16, 30, 5.0, backend="jax",
                                     block=1024, cand_blocks=1)
    assert jax_fell_back == [True]
    _same(got, want)
    assert len(got.regions) >= 3


def test_arguments():
    for k in (15, 24):
        with pytest.raises(ValueError):
            api.kmer_wide_regions("ACGT" * 10, k, 30, 5.0, device="cpu")
    for thr in (0.0, 1.0):
        with pytest.raises(ValueError):
            api.kmer_wide_regions("ACGT" * 10, 17, 30, 5.0, thr=thr,
                                  device="cpu")
    empty = api.kmer_wide_regions(["ACGT", "N" * 8], 17, 30, 5.0,
                                  device="cpu")
    assert empty.regions.size == 0 and empty.n_words == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.kmer_wide_regions("ACGT" * 10, 17, 30, 5.0)
