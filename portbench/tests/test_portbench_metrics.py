"""The metrics' arithmetic on made-up records and traces, and the host
spans' wrappers."""

import types

import numpy as np
import pytest

from _setup import ROOT
from benchlib import cells, roofline, runner, trace


def reader(name):
    return cells.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def record(calls, window_s, spans=(), counters=None, device=None,
           config=None):
    return runner.RunRecord(
        config=config or {"k": 8}, setup_s=7.5,
        window_s=window_s, calls=calls, spans=list(spans),
        counters=counters or {}, device=device)


def call(t0, t1, bases=100, ok=True, lengths=None):
    return runner.CallRecord(t0, t1, bases, lengths or [bases], ok)


def test_bases_per_s_is_over_the_whole_window():
    calls = [call(0, 2, 300), call(2, 3, 300), call(3, 4.5, 300, ok=False)]
    # the failed call's bases are not done; its time is the window's
    assert reader("bases_per_s").read(record(calls, 4.5)) == 600 / 4.5


def test_call_s_p95_is_over_every_call():
    walls = np.arange(1, 41) * 0.1
    t, calls = 0.0, []
    for w in walls:
        calls.append(call(t, t + w))
        t += w
    got = reader("call_s_p95").read(record(calls, t))
    assert got == pytest.approx(np.percentile(walls, 95))
    assert got > np.percentile(walls[:-1], 95)  # the slowest call counts


def test_setup_s():
    assert reader("setup_s").read(record([call(0, 1)], 1)) == 7.5


def test_layer_spans_per_call():
    S = trace.Span
    spans = [S("count", 0.0, 1.0, None, 0),
             S("staging", 0.1, 0.4, "count", 0),
             S("staging", 1.0, 1.5, None, 0), S("rank", 1.5, 1.6, None, 0),
             S("quantize", 1.6, 1.7, None, 0),
             S("device_step", 1.7, 1.8, None, 0),
             S("finish", 1.8, 2.6, None, 0), S("pull", 2.0, 2.1, "finish", 0),
             S("pull", 2.2, 2.3, "finish", 0)]
    rec = record([call(0.0, 3.0), call(3.0, 3.0)], 3.0, spans)
    got = {n: reader(n).read(rec) for n in (
        "staging_ms_per_call", "count_ms_per_call", "weights_ms_per_call",
        "device_step_ms_per_call", "finish_ms_per_call",
        "pull_batches_per_call", "api_other_ms_per_call")}
    assert got == pytest.approx({
        "staging_ms_per_call": 400.0, "count_ms_per_call": 350.0,
        "weights_ms_per_call": 100.0, "device_step_ms_per_call": 50.0,
        "finish_ms_per_call": 400.0, "pull_batches_per_call": 1.0,
        "api_other_ms_per_call": 200.0})


def test_k3_launches_per_call():
    rec = record([call(0, 1), call(1, 2)], 2, counters={"k3_launches": 308})
    assert reader("k3_launches_per_call").read(rec) == 154
    assert reader("k3_launches_per_call").read(record([call(0, 1)], 1)) \
        is None


@pytest.mark.parametrize("lengths,k,want", [
    ([248_956_422], 8, 248_956_422 * 5 + 4 * 4**8),
    ([248_956_422], 12, 248_956_422 * 5 + 4 * 4**12),
    ([100] * 154 + [5], 8, 100 * 154 * 5 + 154 * 4 * 4**8)])
def test_k3_bytes_at_the_cells_shapes(lengths, k, want):
    assert roofline.k3_count_bytes(lengths, k) == want


def events(anchors, ops):
    out = [{"cat": "user_annotation", "name": name, "ts": t, "dur": 1}
           for name, t in zip(("portbench.open", "portbench.close"),
                              anchors)]
    out += [{"cat": c, "name": n, "ts": t, "dur": d} for c, n, t, d in ops]
    out.append({"cat": "cpu_op", "name": "aten::add", "ts": 1e6 + 5,
                "dur": 500})
    return out


def test_trace_reduction_busy_idle_and_k3():
    # anchors at 1 s and 2 s of the trace clock, launched at host 10 and 11
    ops = [("kernel", "void (anonymous namespace)::masked_hist_kernel<true>"
            "(int const*)", 1.1e6, 100_000),
           ("kernel", "other_kernel(int)", 1.15e6, 100_000),  # overlaps
           ("gpu_memcpy", "Memcpy DtoH", 1.5e6, 50_000),
           ("kernel", "late(int)", 2.5e6, 10)]  # after the window
    dev = trace.reduce_trace(events([1e6, 2e6], ops), 10.0, 11.0)
    assert dev.window_s == pytest.approx(1.0)
    assert dev.busy_s == pytest.approx(0.2)
    assert [x - 10 for gap in dev.gaps for x in gap] == pytest.approx(
        [0.0, 0.1, 0.25, 0.5, 0.55, 1.0])
    rec = record([call(10.0, 11.0, lengths=[1 << 20])], 1.0, device=dev)
    assert reader("device_idle_share").read(rec) == pytest.approx(80.0)
    want = 100 * roofline.k3_count_bytes([1 << 20], 8) / 3.35e12 / 0.1
    assert reader("k3_roofline").read(rec) == pytest.approx(want)
    assert trace.reduce_trace(events([1e6], ops), 10.0, 11.0) is None


def test_breakdown_names_the_host_activity():
    ops = [("kernel", "k1(int)", 1.2e6, 100_000),
           ("kernel", "k2(int)", 1.6e6, 100_000)]
    dev = trace.reduce_trace(events([1e6, 2e6], ops), 0.0, 1.0)
    S = trace.Span
    spans = [S("staging", 0.0, 0.15, None, 0),
             S("finish", 0.35, 0.55, None, 0)]
    b = trace.breakdown(dev, spans, [(0.0, 0.9)])
    assert b["device_ops"] == [["k1", pytest.approx(0.1)],
                               ["k2", pytest.approx(0.1)]]
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"staging": 0.2, "finish": 0.3, "call": 0.3})


def test_tracer_installs_nests_and_restores():
    mod = types.ModuleType("fake_program")
    import sys
    sys.modules["fake_program"] = mod

    def make():
        def step(x):
            return x + 1
        step.pull = lambda x: x * 2
        return step

    def outer(x):
        return mod.inner(x) + mod.make()(x) + mod.make().pull(x)

    mod.inner = lambda x: x
    mod.make, mod.outer = make, outer
    specs = [{"name": "outer", "targets": ["fake_program:outer"]},
             {"name": "inner", "targets": ["fake_program:inner"]},
             {"name": "inner", "targets": ["fake_program:inner"]},
             {"name": "step", "wrap": "result", "sync": True,
              "targets": ["fake_program:make"]},
             {"name": "pull", "wrap": "result_attr", "attr": "pull",
              "targets": ["fake_program:make"]}]
    tr = trace.Tracer(specs)
    try:
        tr.call = 3
        assert mod.outer(5) == 5 + 6 + 10
    finally:
        tr.remove()
        del sys.modules["fake_program"]
    assert mod.outer is outer and mod.make is make
    got = sorted((s.name, s.parent, s.call) for s in tr.spans)
    assert got == [("inner", "outer", 3), ("outer", None, 3),
                   ("pull", "outer", 3), ("step", "outer", 3)]


def test_a_target_the_program_lacks_is_left_out():
    tr = trace.Tracer([{"name": "gone",
                        "targets": ["kmer_spans_tpu_torch.api:no_such"]}])
    tr.remove()
    assert tr.spans == []
    assert trace.read_counters({"x": "kmer_spans_tpu_torch.api:no_such"}) \
        == {}


def test_counters_read_module_attributes():
    from kmer_spans_tpu_torch.ops import histogram
    got = trace.read_counters(
        {"k3": "kmer_spans_tpu_torch.ops.histogram:histogram_launches"})
    assert got == {"k3": histogram.histogram_launches}


def test_profiler_anchors_the_trace_to_the_host_clock():
    """On the CPU the profiler records the two annotations (and no device
    activity): the window comes out as the host clock read it."""
    import time
    p = trace.Profiler(cuda=False)
    with p:
        time.sleep(0.05)
    dev = p.result()
    assert dev is not None and dev.ops == [] and dev.busy_s == 0
    assert dev.window_s == pytest.approx(p.host1 - p.host0)
