"""The captured CUDA graph of the exact path's device step
(spans/pipeline.py make_weight_span_pipeline), on the CPU: the rule that
picks it, its counters, and a CPU call that never takes it.  The graph
itself runs only on a card (tests/test_torch_card.py)."""

import numpy as np
import pytest
import torch

from kmer_spans_tpu_torch import api
from kmer_spans_tpu_torch.oracle import golden_genome
from kmer_spans_tpu_torch.spans import pipeline
from kmer_spans_tpu_torch.spans.pipeline import (
    make_weight_span_pipeline,
    quantize_weight_table,
    uses_graph,
)
from kmer_spans_tpu_torch.utils import metrics

GRAPH_COUNTERS = ("spans.pipeline:graph_steps",
                  "spans.pipeline:graph_captures")


@pytest.mark.parametrize("device_type, n, k, want", [
    ("cuda", 1 << 20, 8, True),
    ("cuda", 1 << 12, 8, True),
    ("cuda", 1 << 21, 8, False),
    ("cuda", 1 << 28, 8, False),
    ("cuda", 1 << 16, 12, True),
    ("cuda", 1 << 16, 13, False),
    ("cpu", 1 << 12, 8, False),
    ("cpu", 1 << 20, 8, False),
    ("cpu", 1 << 28, 8, False),
])
def test_graph_rule(device_type, n, k, want):
    assert uses_graph(device_type, n, k) is want


def test_graph_rule_bounds():
    assert pipeline.GRAPH_MAX_N == 1 << 20 and pipeline.GRAPH_MAX_K == 12


@pytest.mark.parametrize("counter", GRAPH_COUNTERS)
def test_graph_counters_are_listed(counter):
    assert tuple(counter.split(":")) in metrics.COUNTERS


@pytest.mark.parametrize("call", ["low_comp", "spans"])
def test_cpu_exact_call_takes_no_graph(call):
    """A CPU exact call (kmer_low_comp_regions without, kmer_spans with
    the scan histogram) replays and captures nothing, and its regions are
    the host library's or the oracle's."""
    g = golden_genome()
    run = {"low_comp": lambda **kw: api.kmer_low_comp_regions(
               g, 8, 100, 20.0, thr=0.75, **kw),
           "spans": lambda **kw: api.kmer_spans(g, 8, **kw)}[call]
    with metrics.tracing() as rec:
        got = run(device="cpu")
    assert all(rec.counters[c] == 0 for c in GRAPH_COUNTERS)
    want = run(backend="host")
    assert len(got.regions) >= 1
    for f in ("n", "counts", "regions"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("k, scan", [(2, True), (8, False), (8, True)])
def test_eager_chain_is_the_step(k, scan):
    """``fn.eager`` is the step that ``fn`` runs off the card."""
    rng = np.random.default_rng(k)
    arr = rng.integers(0, 4, 8 * 4096).astype(np.uint8)
    arr[rng.random(arr.size) < 0.01] = 4
    w_q, _ = quantize_weight_table(rng.normal(-0.2, 1.0, 1 << (2 * k)), 0.0,
                                   4096)
    fn = make_weight_span_pipeline(k, cand_blocks=4, with_scan_counts=scan,
                                   device="cpu")
    steps = pipeline.graph_steps
    got, want = fn(arr, w_q), fn.eager(arr, w_q)
    assert pipeline.graph_steps == steps
    assert set(got) == set(want) and ("scan_hist" in got) is scan
    for key in got:
        assert torch.equal(got[key], want[key]), key
    with pytest.raises(TypeError):
        fn.eager(arr, w_q[:-1])
