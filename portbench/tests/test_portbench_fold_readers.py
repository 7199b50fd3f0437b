"""The readers of the host library's fold in span extraction
(metrics/extract_fold_ms_per_call.py, metrics/native_folds_per_call.py):
their arithmetic on made-up records, their silence without the recorder,
and a traced CPU run in which the library folds every stretch."""

import pytest

from _setup import ROOT, SMALL
from benchlib import cells, program, runner


def reader(name):
    return cells.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def call(t0, t1, ok=True):
    return runner.CallRecord(t0, t1, 100, [100], ok)


def record(calls, program_spans=None, counters=None):
    rec = runner.RunRecord(config={"k": 8}, setup_s=1.0,
                           window_s=calls[-1].t1 - calls[0].t0, calls=calls,
                           spans=[], counters=counters or {}, device=None)
    if program_spans is not None:
        rec.program_spans = program_spans
    return rec


P = program.ProgramSpan

#: one call (0 to 4 s) whose finish the host library folds: the pulls,
#: the assembly and the fold of each stretch
FOLD_SPANS = [
    P("api.kmer_low_comp_regions", 0.0, 4.0, -1, 0, {}),           # 0
    P("regions.sequence", 0.0, 4.0, 0, 0, {"seq_id": 0}),           # 1
    P("finish.weight", 1.0, 4.0, 1, 0, {}),                         # 2
    P("finish.pull", 1.0, 1.5, 2, 0, {}),                           # 3
    P("finish.assemble", 1.5, 2.0, 2, 0, {}),                       # 4
    P("extract.fold", 2.0, 2.75, 2, 0, {}),                         # 5
    P("finish.assemble", 2.75, 3.0, 2, 0, {}),                      # 6
    P("extract.fold", 3.0, 3.5, 2, 0, {}),                          # 7
]

#: a call whose finish the numpy layers extract: no fold
NUMPY_SPANS = [
    P("api.kmer_low_comp_regions", 0.0, 10.0, -1, 0, {}),          # 0
    P("finish.weight", 2.0, 8.0, 0, 0, {}),                         # 1
    P("finish.assemble", 3.5, 4.0, 1, 0, {}),                       # 2
    P("extract.screen", 4.0, 5.0, 1, 0, {}),                        # 3
    P("extract.replay", 5.5, 7.5, 1, 0, {}),                        # 4
]

FINISH_PARTS = ("finish_self_ms_per_call", "finish_pull_ms_per_call",
                "finish_assemble_ms_per_call", "extract_screen_ms_per_call",
                "extract_confirm_ms_per_call", "extract_replay_ms_per_call",
                "extract_fold_ms_per_call")


def test_fold_span_reader_per_call():
    """The fold's reader sums ``extract.fold``; the numpy layers' read 0
    there, and the seven parts of the finish add up to finish.weight."""
    rec = record([call(0.0, 4.0)], program_spans=FOLD_SPANS)
    got = {n: reader(n).read(rec) for n in FINISH_PARTS}
    assert got == pytest.approx({
        "finish_self_ms_per_call": 1e3 * 0.5,
        "finish_pull_ms_per_call": 1e3 * 0.5,
        "finish_assemble_ms_per_call": 1e3 * 0.75,
        "extract_screen_ms_per_call": 0.0,
        "extract_confirm_ms_per_call": 0.0,
        "extract_replay_ms_per_call": 0.0,
        "extract_fold_ms_per_call": 1e3 * 1.25})
    assert sum(got.values()) == pytest.approx(1e3 * 3.0)


def test_fold_span_reader_reads_zero_on_the_numpy_path():
    rec = record([call(0.0, 10.0), call(10.0, 12.0)],
                 program_spans=NUMPY_SPANS)
    assert reader("extract_fold_ms_per_call").read(rec) == 0.0
    assert reader("extract_screen_ms_per_call").read(rec) == 1e3 * 1.0 / 2


@pytest.mark.parametrize("name", ["extract_fold_ms_per_call",
                                  "native_folds_per_call"])
def test_fold_readers_without_the_program_recorder(name):
    """A program without the recorder or the counter (an older commit)
    gives nothing to read: the reader returns None and does not raise."""
    assert reader(name).read(record([call(0.0, 1.0)], program_spans=[])) \
        is None


@pytest.mark.parametrize("value, want", [(6_712, 3_356.0), (0, 0.0)])
def test_native_folds_reader_per_call(value, want):
    rec = record([call(0, 1), call(1, 2), call(2, 3, ok=False)],
                 counters={"native_folds": value})
    got = reader("native_folds_per_call")
    assert got.read(rec) == pytest.approx(want)
    assert got.COUNTERS["native_folds"].split(":")[1] == "native_folds"


def test_traced_run_reports_the_fold():
    """On the CPU, where the host library loads: a traced run reports both
    new metrics, the fold above 0 and the screen at 0, and the seven parts
    of the finish make up the finish."""
    from kmer_spans_tpu_torch.utils import metrics, native
    if not native.available():
        pytest.skip("the host library does not build here (no C++ compiler)")
    small = dict(SMALL, sequences=5, pool=2)
    traced = runner.run_cell(ROOT, "lowcomp_k8.scaffolds", 3_900_000_019,
                             0.2, True, "cpu", traffic=small)
    assert traced["correct"] and not metrics.enabled
    got = traced["metrics"]
    assert {*FINISH_PARTS, "native_folds_per_call"} <= set(got)
    assert got["native_folds_per_call"]["value"] > 0
    assert got["extract_fold_ms_per_call"]["value"] > 0
    assert got["extract_screen_ms_per_call"]["value"] == 0
    assert got["extract_replay_ms_per_call"]["value"] == 0
    seven = sum(got[n]["value"] for n in FINISH_PARTS)
    assert seven <= got["finish_ms_per_call"]["value"]
    assert seven >= 0.9 * got["finish_ms_per_call"]["value"]
