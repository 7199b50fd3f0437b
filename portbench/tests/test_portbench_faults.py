"""A run whose timed path is broken underneath comes out not correct,
once for each fault that these cells can have, and so does the control:
the reference in float32 put in the program's place.  The runs skip the
look for a card and use the program's CPU path at a small size."""

import numpy as np
import pytest

from _setup import ROOT, SMALL
from benchlib import cells, runner

from kmer_spans_tpu_torch import api


def run(workload, seed=2**32 + 9, **over):
    return runner.run_cell(ROOT, workload, seed, 0.3, False, "cpu",
                           traffic=dict(SMALL, **over))


@pytest.mark.parametrize("workload", ["lowcomp_k8.chromosome",
                                      "lowcomp_k8.scaffolds"])
def test_sound_run_is_correct(workload):
    res = run(workload)
    assert res["correct"] and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert list(res)[-1] == "checks"


def test_an_altered_answer(monkeypatch):
    """A region's score changed by one unit in the last place where the
    host finish produces it."""
    finish = api.finish_weight_spans

    def altered(*a, **kw):
        res = finish(*a, **kw)
        if res.regions:
            sid, beg, end, score = res.regions[0]
            res.regions[0] = (sid, beg, end, np.nextafter(score, np.inf))
        return res

    monkeypatch.setattr(api, "finish_weight_spans", altered)
    res = run("lowcomp_k8.chromosome")
    assert not res["correct"]
    assert res["checks"]["regions_wrong"]["value"] > 0


def test_half_the_batch_left_out(monkeypatch):
    """Half the assembly's sequences left out of the span step."""
    call_regions = api._call_regions

    def half(packed, *a, **kw):
        return call_regions(packed[: len(packed) // 2], *a, **kw)

    monkeypatch.setattr(api, "_call_regions", half)
    res = run("lowcomp_k8.scaffolds", sequences=12)
    assert not res["correct"]
    assert res["checks"]["regions_wrong"]["value"] > 0


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    """The spectrum count returns its accumulator as it found it."""
    def unchanged(packed, k, device):
        return np.zeros(1 << (2 * k), np.int64), 0

    monkeypatch.setattr(api, "device_count_spectrum", unchanged)
    res = run("lowcomp_k8.chromosome")
    assert not res["correct"]
    assert res["checks"]["spectrum_entries_wrong"]["value"] > 0


@pytest.mark.parametrize("workload", ["lowcomp_k8.chromosome",
                                      "lowcomp_k12.chromosome",
                                      "lowcomp_k8.scaffolds"])
def test_the_control_fails(workload):
    """The reference in float32 against the reference in float64."""
    cell = cells.find_cell(ROOT, cells.load_benchmark(ROOT), workload)
    cell.traffic.update(SMALL, sequences=min(cell.traffic["sequences"], 12))
    from benchlib import genome
    asm = genome.make_assembly(cell.traffic, 77, 0)
    want = cell.call.reference(asm, cell.config, np.float64)
    control = cell.call.reference(asm, cell.config, np.float32)
    got = cell.call.compare(control, want)
    assert got["weights_entries_wrong"] > 0 and got["regions_wrong"] > 0
    assert got["spectrum_entries_wrong"] == 0  # integers: no precision
