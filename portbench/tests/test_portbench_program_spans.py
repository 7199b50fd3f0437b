"""The readers of the program's own spans and counters
(benchlib/program.py and the metrics that read it): their arithmetic on
made-up records, the breakdown's labels, and a traced CPU run."""

import pytest

from _setup import ROOT, SMALL
from benchlib import cells, program, runner, trace


def reader(name):
    return cells.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def call(t0, t1, ok=True):
    return runner.CallRecord(t0, t1, 100, [100], ok)


def record(calls, spans=(), program_spans=None, counters=None):
    rec = runner.RunRecord(config={"k": 8}, setup_s=1.0,
                           window_s=calls[-1].t1 - calls[0].t0, calls=calls,
                           spans=list(spans), counters=counters or {},
                           device=None)
    if program_spans is not None:
        rec.program_spans = program_spans
    return rec


P = program.ProgramSpan

#: one call (0 to 10 s) of one sequence, then a second call (10 to 12 s)
#: of one more: the finish's children, the sequence's, a step with its
#: device time
SPANS = [
    P("api.kmer_low_comp_regions", 0.0, 10.0, -1, 0, {}),          # 0
    P("regions.sequence", 1.0, 9.0, 0, 0, {"seq_id": 0}),           # 1
    P("regions.stage", 1.0, 1.5, 1, 0, {}),                         # 2
    P("regions.step", 1.5, 1.6, 1, 0, {"device_ms": 30.0}),         # 3
    P("regions.outputs", 1.6, 2.0, 1, 0, {}),                       # 4
    P("finish.weight", 2.0, 8.0, 1, 0, {}),                         # 5
    P("finish.pull", 2.5, 3.0, 5, 0, {}),                           # 6
    P("finish.pull", 3.0, 3.25, 5, 0, {}),                          # 7
    P("finish.assemble", 3.5, 4.0, 5, 0, {}),                       # 8
    P("extract.screen", 4.0, 5.0, 5, 0, {}),                        # 9
    P("extract.confirm", 5.0, 5.5, 5, 0, {}),                       # 10
    P("extract.replay", 5.5, 7.5, 5, 0, {}),                        # 11
    P("regions.sequence", 10.5, 11.5, -1, 1, {"seq_id": 0}),        # 12
    P("regions.step", 10.5, 10.6, 12, 1, {"device_ms": 10.0}),      # 13
]


def test_program_span_readers_per_call():
    rec = record([call(0.0, 10.0), call(10.0, 12.0)], program_spans=SPANS)
    got = {n: reader(n).read(rec) for n in (
        "finish_self_ms_per_call", "finish_pull_ms_per_call",
        "finish_assemble_ms_per_call", "extract_screen_ms_per_call",
        "extract_confirm_ms_per_call", "extract_replay_ms_per_call",
        "step_device_ms_per_call", "sequence_self_ms_per_call")}
    assert got == pytest.approx({
        # finish.weight 6 s less its children's 0.75 + 0.5 + 1 + 0.5 + 2
        "finish_self_ms_per_call": 1e3 * 1.25 / 2,
        "finish_pull_ms_per_call": 1e3 * 0.75 / 2,
        "finish_assemble_ms_per_call": 1e3 * 0.5 / 2,
        "extract_screen_ms_per_call": 1e3 * 1.0 / 2,
        "extract_confirm_ms_per_call": 1e3 * 0.5 / 2,
        "extract_replay_ms_per_call": 1e3 * 2.0 / 2,
        "step_device_ms_per_call": 40.0 / 2,
        # 8 s less 0.5 + 0.1 + 0.4 + 6; then 1 s less 0.1
        "sequence_self_ms_per_call": 1e3 * (1.0 + 0.9) / 2})
    # the six parts of the finish add up to finish.weight
    six = [v for n, v in got.items() if n.startswith(("finish", "extract"))]
    assert sum(six) == pytest.approx(1e3 * 6.0 / 2)


def test_span_readers_without_the_program_recorder():
    """A program without the recorder (an older commit) gives no spans:
    every reader returns None; a span name the window lacks reads 0."""
    rec = record([call(0.0, 1.0)], program_spans=[])
    for name in ("finish_self_ms_per_call", "finish_pull_ms_per_call",
                 "extract_confirm_ms_per_call", "step_device_ms_per_call",
                 "sequence_self_ms_per_call", "replays_per_call",
                 "pulled_blocks_per_call", "staged_mb_per_call"):
        assert reader(name).read(rec) is None, name
    no_pull = record([call(0.0, 10.0)], program_spans=SPANS[:6])
    assert reader("finish_pull_ms_per_call").read(no_pull) == 0.0
    assert reader("step_device_ms_per_call").read(no_pull) == 30.0


@pytest.mark.parametrize("name, counter, value, want", [
    ("replays_per_call", "replays", 11_000, 5_500.0),
    ("pulled_blocks_per_call", "pulled_blocks", 48_000, 24_000.0),
    ("staged_mb_per_call", "staged_bytes", 2 * 536_870_912, 536.870912),
])
def test_counter_readers_per_call(name, counter, value, want):
    rec = record([call(0, 1), call(1, 2), call(2, 3, ok=False)],
                 counters={counter: value})
    assert reader(name).read(rec) == pytest.approx(want)
    assert reader(name).COUNTERS[counter].split(":")[1] == counter


def test_breakdown_labels_gaps_by_the_programs_innermost_span():
    """A gap inside the wrapper's ``finish`` and the program's
    ``finish.pull`` takes the inner label; one inside ``finish`` alone
    (the program's ``finish.weight`` self time) takes ``finish.weight``."""
    ops = [{"cat": "user_annotation", "name": "portbench.open", "ts": 1e6,
            "dur": 1},
           {"cat": "user_annotation", "name": "portbench.close", "ts": 2e6,
            "dur": 1},
           {"cat": "kernel", "name": "k(int)", "ts": 1.5e6, "dur": 100_000}]
    dev = trace.reduce_trace(ops, 0.0, 1.0)
    got = [P("finish.weight", 0.05, 0.95, -1, 0, {}),
           P("finish.pull", 0.1, 0.45, 0, 0, {})]
    rec = record([call(0.0, 1.0)],
                 spans=[trace.Span("finish", 0.0, 1.0, None, 0)])
    rec.spans.extend(program.as_trace_spans(got))
    b = trace.breakdown(dev, rec.spans, [(0.0, 1.0)])
    # gaps 0..0.5 (mid 0.25: finish.pull) and 0.6..1.0 (mid 0.8)
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"finish.pull": 0.5, "finish.weight": 0.4})


def test_traced_run_hands_over_the_programs_spans():
    """On the CPU: a traced run opens the recorder around the window only
    and reports every new metric but the device time of the steps; an
    untraced run leaves the recorder off."""
    from kmer_spans_tpu_torch.utils import metrics
    small = dict(SMALL, sequences=5, pool=2)
    traced = runner.run_cell(ROOT, "lowcomp_k8.scaffolds", 3_900_000_017,
                             0.2, True, "cpu", traffic=small)
    assert traced["correct"] and not metrics.enabled
    want = {"finish_self_ms_per_call", "finish_pull_ms_per_call",
            "finish_assemble_ms_per_call", "extract_screen_ms_per_call",
            "extract_confirm_ms_per_call", "extract_replay_ms_per_call",
            "replays_per_call", "pulled_blocks_per_call",
            "staged_mb_per_call", "sequence_self_ms_per_call"}
    got = traced["metrics"]
    assert want <= set(got) and "step_device_ms_per_call" not in got
    assert got["replays_per_call"]["value"] > 0
    six = sum(got[n]["value"] for n in want if n.endswith("ms_per_call")
              and n.startswith(("finish", "extract")))
    assert six <= got["finish_ms_per_call"]["value"]
    assert six >= 0.9 * got["finish_ms_per_call"]["value"]
    plain = runner.run_cell(ROOT, "lowcomp_k8.scaffolds", 3_900_000_018,
                            0.2, False, "cpu", traffic=small)
    assert plain["correct"] and not metrics.enabled
    assert program._open is None
