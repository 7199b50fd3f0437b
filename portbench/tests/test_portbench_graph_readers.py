"""The reader of the device step's graph replays
(metrics/graph_steps_per_call.py): its arithmetic on made-up records, its
silence without the program's counter, and a traced CPU run, where no
step replays a graph."""

import pytest

from _setup import ROOT, SMALL
from benchlib import cells, runner


def reader(name):
    return cells.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def call(t0, t1, ok=True):
    return runner.CallRecord(t0, t1, 100, [100], ok)


def record(calls, counters=None):
    return runner.RunRecord(config={"k": 8}, setup_s=1.0,
                            window_s=calls[-1].t1 - calls[0].t0, calls=calls,
                            spans=[], counters=counters or {}, device=None)


@pytest.mark.parametrize("value, want", [(19_998, 9_999.0), (218, 109.0),
                                         (0, 0.0)])
def test_graph_steps_reader_per_call(value, want):
    """Per call that finished: a failed call adds no divisor."""
    rec = record([call(0, 1), call(1, 2), call(2, 3, ok=False)],
                 counters={"graph_steps": value})
    got = reader("graph_steps_per_call")
    assert got.read(rec) == pytest.approx(want)
    assert got.COUNTERS["graph_steps"] == \
        "kmer_spans_tpu_torch.spans.pipeline:graph_steps"


def test_graph_steps_reader_without_the_counter():
    """A program without the counter (an older commit) gives nothing to
    read: the reader returns None and does not raise."""
    got = reader("graph_steps_per_call")
    assert got.read(record([call(0.0, 1.0)])) is None
    assert got.read(record([call(0.0, 1.0, ok=False)],
                           counters={"graph_steps": 3})) is None


def test_graph_steps_metric_is_declared():
    """The metric's entry: the device step's layer, on the four cells of
    the span path."""
    bench = cells.load_benchmark(ROOT)
    entry, = [m for m in bench["per_layer"]
              if m["name"] == "graph_steps_per_call"]
    assert entry["layer"] == "device step"
    assert entry["source"] == "program_counter"
    assert entry["moves"] == "bases_per_s"
    assert all(w.split(".")[0].startswith("lowcomp_")
               for w in entry["workloads"])
    assert len(entry["workloads"]) == 4


def test_traced_cpu_run_reports_no_graph_step():
    """On the CPU the step runs eagerly: the traced line reports the
    metric at 0, and the run is correct."""
    small = dict(SMALL, sequences=5, pool=2)
    traced = runner.run_cell(ROOT, "lowcomp_k8.scaffolds", 3_900_000_023,
                             0.2, True, "cpu", traffic=small)
    assert traced["correct"]
    assert traced["metrics"]["graph_steps_per_call"]["value"] == 0
