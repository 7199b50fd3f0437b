"""The fast mode's spans and counters (api.py _low_comp_fast and
_class_regions), and its answer against the benchmark's plain reference
(portbench/reference/low_comp_fast.py, through portbench/calls/
low_comp_fast.py), on the CPU.

Inside ``metrics.tracing()`` a fast call records one ``fast.stage`` and,
for each pipeline run, one ``fast.step``, ``fast.pull`` and
``fast.finish``; the counters ``api:fast_runs`` and
``api:fast_pulled_bytes`` equal the runs and the bytes of the outputs
copied to the host.  With the recorder off no site opens a span."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kmer_spans_tpu_torch import api
from kmer_spans_tpu_torch.encoding import PackedSeq
from kmer_spans_tpu_torch.oracle import golden_genome
from kmer_spans_tpu_torch.stats.ranks import cumulative_mass
from kmer_spans_tpu_torch.utils import metrics

BENCH = Path(__file__).resolve().parents[1] / "portbench"
RUN_SPANS = ("fast.step", "fast.pull", "fast.finish")
CPU = torch.device("cpu")


def _benchlib():
    """The benchmark's folder on the path, as portbench/run.py puts it."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))


def _draft(total: int, contigs: int, seed: int):
    """The fragmented traffic cut to ``total`` bases in ``contigs``
    contigs (benchlib/drafts.py), an N gap every 300,000 bases."""
    _benchlib()
    from benchlib import drafts

    return drafts.draft(total, contigs, seed, n_gap_every=300_000,
                        n_gap_first=150_000)


def _packed(asm):
    return [PackedSeq(bases=b, valid=v) for b, v in zip(asm.bases, asm.valid)]


def _fast(seqs, **kw):
    return api.kmer_low_comp_regions(seqs, 8, 100, 50.0, thr=0.6,
                                     mode="fast", device="cpu", **kw)


def _rerun_island():
    """A sequence whose repeat island's run no capacity of one block holds
    (tests/test_torch_api.py's overflow case)."""
    rng = np.random.default_rng(2)
    seq = "".join("ACGT"[b] for b in rng.integers(0, 4, 9_000))
    return api._as_seq_list(seq[:2000] + "TG" * 400 + seq[2800:])


def _spy_pipeline(monkeypatch):
    """Records each run's capacity and the bytes of its outputs."""
    caps, pulled = [], []
    make = api.make_span_pipeline

    def spy(k, **kw):
        fn = make(k, **kw)
        caps.append(kw["cand_blocks"])

        def run(*a):
            out = fn(*a)
            pulled.append(sum(v.numel() * v.element_size()
                              for v in out.values()))
            return out
        return run

    monkeypatch.setattr(api, "make_span_pipeline", spy)
    return caps, pulled


def _children(rec, i):
    return [s.name for s in rec.spans if s.parent == i]


def test_one_stage_and_each_run_spans_nest_under_the_call():
    """One run (C covers every block): the call holds ``fast.stage`` and
    the run's step, pull and finish, in that order, and the finish holds
    the fold of each candidate stretch."""
    seqs = _packed(_draft(1 << 18, 12, 2**33 + 3))
    with metrics.tracing() as rec:
        got = _fast(seqs)
    sp = rec.spans
    assert [s.name for s in sp if s.parent < 0] == \
        ["api.kmer_low_comp_regions"]
    assert _children(rec, 0) == ["fast.stage", *RUN_SPANS]
    assert rec.counters["api:fast_runs"] == 1
    fin = next(i for i, s in enumerate(sp) if s.name == "fast.finish")
    folds = _children(rec, fin)
    assert folds and set(folds) == {"extract.fold"}
    assert rec.counters["spans.extract:native_folds"] == len(folds)
    # the fast finish folds precomputed scores: no fold reads a table
    assert rec.counters["spans.extract:table_folds"] == 0
    for s in sp:
        assert s.t0 <= s.t1
        if s.parent >= 0:
            p = sp[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1
    assert len(got.regions) > 0


def test_reruns_record_each_run_and_count_runs_and_bytes(monkeypatch):
    """A capacity of one block reruns the pipeline with twice the
    capacity: one step, pull and finish a run, ``fast_runs`` the runs and
    ``fast_pulled_bytes`` the bytes of every run's outputs."""
    caps, pulled = _spy_pipeline(monkeypatch)
    with metrics.tracing() as rec:
        api._low_comp_fast(_rerun_island(), 6, 30, 3.0, 0.75, CPU,
                           block=1024, cand_blocks=1)
    runs = len(caps)
    assert runs >= 2 and caps[:2] == [1, 2]
    by_name = rec.by_name()
    assert by_name["fast.stage"][0] == 1
    assert all(by_name[name][0] == runs for name in RUN_SPANS)
    names = [s.name for s in rec.spans if s.name.startswith("fast.")]
    assert names == ["fast.stage", *RUN_SPANS * runs]
    assert rec.counters["api:fast_runs"] == runs
    assert rec.counters["api:fast_pulled_bytes"] == sum(pulled) > 0


def test_the_sites_cost_nothing_while_off(monkeypatch):
    """With the recorder off no site opens a span or makes a CUDA event,
    the counters still count, and the answer is the one it gives on."""
    seqs = _rerun_island()
    with metrics.tracing():
        on = api._low_comp_fast(seqs, 6, 30, 3.0, 0.75, CPU, block=1024,
                                cand_blocks=1)
    made = []
    monkeypatch.setattr(metrics, "begin", lambda *a, **kw: made.append(a))
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **kw: made.append("event"))
    runs, nbytes = api.fast_runs, api.fast_pulled_bytes
    off = api._low_comp_fast(seqs, 6, 30, 3.0, 0.75, CPU, block=1024,
                             cand_blocks=1)
    assert made == [] and not metrics.enabled
    assert api.fast_runs > runs and api.fast_pulled_bytes > nbytes
    assert off.regions.tobytes() == on.regions.tobytes()
    assert off.w_rank.tobytes() == on.w_rank.tobytes()


def test_the_exact_mode_records_no_fast_span():
    with metrics.tracing() as rec:
        api.kmer_low_comp_regions(golden_genome(), 8, 100, 20.0, thr=0.75,
                                  device="cpu")
    assert not any(s.name.startswith("fast.") for s in rec.spans)
    assert rec.counters["api:fast_runs"] == 0
    assert rec.counters["api:fast_pulled_bytes"] == 0
    assert rec.counters["spans.extract:table_folds"] == \
        rec.counters["spans.extract:native_folds"] > 0


@pytest.mark.parametrize("k", [3, 8, 12])
def test_no_fast_fold_reads_a_table(k):
    """At every screen of the fast mode (the non-fused class screen at
    k = 3, the fused one at 8, the pm screen at 12) the finish folds
    precomputed scores: ``table_folds`` stays 0 while ``native_folds``
    counts the folds."""
    with metrics.tracing() as rec:
        got = api.kmer_low_comp_regions(golden_genome(), k, 100, 20.0,
                                        thr=0.75, mode="fast", device="cpu")
    assert len(got.regions) == 3
    assert rec.counters["spans.extract:native_folds"] > 0
    assert rec.counters["spans.extract:table_folds"] == 0


@pytest.mark.parametrize("total,contigs,seed", [
    (1 << 20, 40, 2**33 + 11), (1 << 21, 84, 2**35 + 5)])
def test_answer_equals_the_benchmark_reference(total, contigs, seed):
    """The fast cell's comparison reads 0 on a small draft at the
    source's settings, and the reference's w_rank (the int64 mass over n)
    is the program's bit for bit; the regions are exact mode's."""
    _benchlib()
    from benchlib import cells

    call = cells.load_module(BENCH / "calls" / "low_comp_fast.py")
    with open(BENCH / "configs" / "fast_k8.json") as fh:
        cfg = json.load(fh)
    assert cfg["mode"] == "fast" and cfg["thr"] == 0.6
    asm = _draft(total, contigs, seed)
    res = call.run(api, call.program_input(asm), cfg, "cpu")
    got = call.answer(res)
    want = call.reference(asm, cfg)
    assert call.compare(got, want) == {name: 0 for name, _ in call.CHECKS}
    assert want["w_rank"].tobytes() == res.w_rank.tobytes()
    mass = cumulative_mass(res.counts).astype(np.float64) / res.n[0]
    assert res.w_rank.tobytes() == mass.tobytes()
    exact = api.kmer_low_comp_regions(call.program_input(asm), 8, 100, 50.0,
                                      thr=0.6, device="cpu")
    assert exact.regions.tobytes() == res.regions.tobytes()
    assert len(res.regions) > 0
