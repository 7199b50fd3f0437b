"""The port's api.kmer_low_comp_regions at 10 <= k <= 15 against the JAX
package's fast mode and the sequential oracle."""

import numpy as np
import torch

from kmer_spans_tpu import api as ref_api
from kmer_spans_tpu_torch import api

from conftest import random_seq
from test_pm_pipeline import _plant
from test_span_pipeline import _chain_rank_regions
from test_torch_api import _same_result


def _spy(monkeypatch, first_cap=None):
    """Record each pm pipeline build's (strategy, list_cap); a build with
    neither set gets list capacity ``first_cap`` when one is given."""
    calls = []
    make = api.make_pm_span_pipeline

    def spy(k, **kw):
        calls.append((kw["strategy"], kw["list_cap"], kw["cand_blocks"]))
        if first_cap and kw["strategy"] is None and kw["list_cap"] is None:
            kw["list_cap"] = first_cap
        return make(k, **kw)

    monkeypatch.setattr(api, "make_pm_span_pipeline", spy)
    monkeypatch.setattr(api, "exact_fallbacks", 0)
    return calls


def _regions(res):
    return [(int(r["beg"]), int(r["end"]), float(r["score"]))
            for r in res.regions]


def test_golden_k12_equals_jax_fast_and_oracle(golden, monkeypatch):
    calls = _spy(monkeypatch)
    got = api.kmer_low_comp_regions(golden, 12, 100, 20.0, thr=0.75,
                                    mode="fast", device="cpu")
    assert len(calls) == 1 and api.exact_fallbacks == 0
    want = ref_api.kmer_low_comp_regions(golden, 12, 100, 20.0, thr=0.75,
                                         backend="jax", mode="fast")
    _same_result(got, want)
    chain = _chain_rank_regions(golden, 12, 0.75, 100, 20.0)
    assert _regions(got) == [(b, e, s) for _, b, e, s in chain]
    assert len(chain) >= 3


def test_multi_sequence_k10_equals_jax_fast():
    rng = np.random.default_rng(10)
    seqs = []
    for i in range(3):
        s = list(random_seq(rng, 7_000 + 1_500 * i, n_prob=0.002))
        s[1000:1900] = "CAG" * 300
        seqs.append("".join(s))
    seqs.insert(1, "ACGTACG")  # shorter than k: skipped, keeps its seq_id
    got = api.kmer_low_comp_regions(seqs, 10, 50, 8.0, thr=0.7,
                                    mode="fast", device="cpu")
    want = ref_api.kmer_low_comp_regions(seqs, 10, 50, 8.0, thr=0.7,
                                         backend="jax", mode="fast")
    _same_result(got, want)
    assert set(got.regions["seq_id"]) == {0, 2, 3}


def _island_seq(seed):
    rng = np.random.default_rng(seed)
    return _plant(random_seq(rng, 40_000),
                  [(4000, "AG", 300), (15000, "CCTGA", 150),
                   (30000, "T", 600)])


def test_packed_retry_on_smallv_overflow(monkeypatch):
    """k = 13 picks smallv at this size; with a list of 2 it overflows and
    the call retries once with the packed key, as the reference does,
    which is no device rerun."""
    calls = _spy(monkeypatch, first_cap=2)
    seq = _island_seq(21)
    got = api.kmer_low_comp_regions(seq, 13, 30, 5.0, thr=0.75,
                                    mode="fast", device="cpu")
    assert [c[0] for c in calls] == [None, "packed"]
    assert api.exact_fallbacks == 0
    exact = ref_api.kmer_low_comp_regions(seq, 13, 30, 5.0, thr=0.75,
                                          backend="host", mode="exact")
    assert _regions(got) == _regions(exact) and len(_regions(got)) >= 2


def test_list_overflow_reruns_on_the_device(monkeypatch):
    """k = 12 is packed already: a list overflow reruns the pipeline with
    the list capacity doubled until the runs fit, counted."""
    calls = _spy(monkeypatch, first_cap=2)
    seq = _island_seq(22)
    got = api.kmer_low_comp_regions(seq, 12, 30, 5.0, thr=0.75,
                                    mode="fast", device="cpu")
    assert [c[0] for c in calls] == [None, None]
    assert calls[1][1] > 2 and calls[1][1] & (calls[1][1] - 1) == 0
    assert api.exact_fallbacks == 1
    want = ref_api.kmer_low_comp_regions(seq, 12, 30, 5.0, thr=0.75,
                                         backend="jax", mode="fast")
    _same_result(got, want)


def test_candidate_miss_reruns_on_the_device(monkeypatch):
    calls = _spy(monkeypatch)
    seq = _island_seq(23)
    packed = ref_api._as_seq_list(seq)
    got = api._low_comp_fast(packed, 12, 30, 5.0, 0.75, torch.device("cpu"),
                             block=1024, cand_blocks=1)
    caps = [c[2] for c in calls]
    assert caps[:2] == [1, 2] and caps == sorted(caps)
    assert api.exact_fallbacks == len(caps) - 1 >= 1
    want = ref_api.kmer_low_comp_regions(seq, 12, 30, 5.0, thr=0.75,
                                         backend="jax", mode="fast")
    _same_result(got, want)


def test_k9_raises_naming_its_queue_item(golden):
    # k = 9 runs in both modes: the class screen (between the two
    # pipelines) in fast mode, and the device form of mode="exact", which
    # no longer raises, each equal to the reference's same mode
    got = api.kmer_low_comp_regions(golden, 9, 100, 20.0, mode="fast",
                                    device="cpu")
    want = ref_api.kmer_low_comp_regions(golden, 9, 100, 20.0, thr=0.75,
                                         backend="jax", mode="fast")
    _same_result(got, want)
    got = api.kmer_low_comp_regions(golden, 9, 100, 20.0, device="cpu")
    want = ref_api.kmer_low_comp_regions(golden, 9, 100, 20.0, thr=0.75,
                                         backend="jax", mode="exact")
    _same_result(got, want)
