"""The port's span recorder (kmer_spans_tpu_torch/utils/metrics.py) and
the counters of the exact path, on the CPU.

The recorder is off by default and keeps nothing then; inside
``tracing()`` the exact path's spans nest under the api call that made
them, and the answers are bit-identical either way.  The counters of
spans/extract.py and spans/finish.py equal counts worked out by hand."""

import json

import numpy as np
import pytest
import torch
from test_torch_extract import SCORES_A, SCORES_B

from kmer_spans_tpu_torch import api, cli
from kmer_spans_tpu_torch.io.fasta import write_fasta
from kmer_spans_tpu_torch.oracle import golden_genome
from kmer_spans_tpu_torch.parallel import device as pdevice
from kmer_spans_tpu_torch.spans import extract, finish
from kmer_spans_tpu_torch.spans.finish import finish_weight_spans
from kmer_spans_tpu_torch.spans.pipeline import (
    make_weight_span_pipeline,
    quantize_weight_table,
)
from kmer_spans_tpu_torch.utils import metrics, native

FINISH_CHILDREN = {"finish.pull", "finish.assemble", "extract.fold",
                   "extract.screen", "extract.confirm", "extract.replay"}


def _low_comp(seqs):
    return api.kmer_low_comp_regions(seqs, 8, 100, 20.0, thr=0.75,
                                     device="cpu").regions


def _two_sequences():
    g = golden_genome()
    return [g[:60_000], g[40_000:]]


def test_off_by_default_and_keeps_nothing():
    assert not metrics.enabled
    with metrics.tracing() as rec:
        assert metrics.enabled
        with pytest.raises(RuntimeError):
            with metrics.tracing():
                pass
    assert not metrics.enabled and metrics._recorder is None
    kept = len(rec.spans)
    _low_comp(golden_genome())
    assert len(rec.spans) == kept == 0


def _finish_parents(rec):
    """{span name: the names of the spans it ran inside}."""
    parent_of = {}
    for s in rec.spans:
        if s.parent >= 0:
            parent_of.setdefault(s.name, set()).add(rec.spans[s.parent].name)
    return parent_of


def test_spans_nest_under_their_call():
    """Two api calls on two sequences: every span has its call's id; each
    sequence's stage, step, outputs and finish lie in it, and the finish's
    children in ``finish.weight``: the assembly and the host library's
    fold, one a candidate stretch."""
    assert native.available()
    seqs = _two_sequences()
    with metrics.tracing() as rec:
        _low_comp(seqs)
        _low_comp(seqs)
    sp = rec.spans
    roots = [i for i, s in enumerate(sp) if s.parent < 0]
    assert [sp[i].name for i in roots] == ["api.kmer_low_comp_regions"] * 2
    assert [sp[i].call for i in roots] == [0, 1]
    for s in sp:
        assert s.t0 <= s.t1
        if s.parent >= 0:
            p = sp[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1 and s.call == p.call
    parent_of = _finish_parents(rec)
    assert parent_of["regions.sequence"] == {"api.kmer_low_comp_regions"}
    for name in ("regions.stage", "regions.step", "regions.outputs",
                 "finish.weight"):
        assert parent_of[name] == {"regions.sequence"}
    assert {"finish.assemble", "extract.fold"} <= set(parent_of)
    assert not {"extract.screen", "extract.replay"} & set(parent_of)
    for name in FINISH_CHILDREN & set(parent_of):
        assert parent_of[name] == {"finish.weight"}
    stretches = rec.by_name()["finish.assemble"][0]
    assert rec.counters["spans.extract:native_folds"] == stretches \
        == rec.by_name()["extract.fold"][0] > 0
    seq_spans = [s for s in sp if s.name == "regions.sequence"]
    assert [(s.call, s.attrs["seq_id"], s.attrs["bases"])
            for s in seq_spans] == [(c, i, len(seqs[i]))
                                    for c in (0, 1) for i in (0, 1)]
    by_name = rec.by_name()
    assert by_name["regions.sequence"][0] == 4
    assert by_name["finish.weight"][0] == 4
    assert all(sec >= 0 for _, sec in by_name.values())
    # two calls of two sequences, each staged twice (the count, the step)
    assert rec.counters["parallel.device:staged_bytes"] == \
        2 * 2 * 2 * pdevice.bucket_size(60_000)


def test_numpy_path_spans_nest_under_the_finish(monkeypatch):
    """Without the host library the numpy layers extract: their screen
    and replays lie in ``finish.weight``, no fold runs, and the same
    regions come out."""
    seqs = _two_sequences()
    with_fold = _low_comp(seqs)
    monkeypatch.setattr(native, "_load", lambda: None)
    with metrics.tracing() as rec:
        got = _low_comp(seqs)
    assert got.tobytes() == with_fold.tobytes() and got.size
    parent_of = _finish_parents(rec)
    assert {"finish.assemble", "extract.screen", "extract.replay"} \
        <= set(parent_of)
    assert "extract.fold" not in parent_of
    for name in FINISH_CHILDREN & set(parent_of):
        assert parent_of[name] == {"finish.weight"}
    assert rec.counters["spans.extract:native_folds"] == 0
    assert rec.counters["spans.extract:replays"] > 0


def _extract_tied(s):
    scored = np.ones(s.shape[0], bool)
    scored[[0, 150]] = False  # three scored stretches
    return extract.extract_spans(s, scored, 20, 5.0, seq_id=2)


@pytest.mark.parametrize("case", [
    pytest.param(lambda: _low_comp(golden_genome()), id="low_comp_golden"),
    pytest.param(lambda: _low_comp(_two_sequences()), id="low_comp_two"),
    pytest.param(lambda: _extract_tied(SCORES_A), id="extract_tied_a"),
    pytest.param(lambda: _extract_tied(SCORES_B), id="extract_tied_b"),
])
def test_answers_bit_identical_with_the_recorder_on(case):
    off = case()
    with metrics.tracing() as rec:
        on = case()
    assert rec.spans
    if isinstance(off, np.ndarray):
        assert off.tobytes() == on.tobytes() and off.size
    else:
        assert off == on and off


@pytest.mark.parametrize("scores, min_width, min_score, want, counts", [
    # integers: the screen is exact.  The first pass over the whole range
    # finds the excursions at 0 (S 1, 2, then 0 at 2; 1 >= min_width 1
    # long, max 2) and at 3 (S 2, 4, 6, then 0 at 6); the one at 7 is
    # too short.  Both replays emit; each rescan range ([2, 2] and
    # [6, 6]) is one position, too short for any excursion: 3 ranges.
    ([1, 1, -5, 2, 2, 2, -10, 3], 1, 2.0,
     [(1, 2, 2.0), (4, 6, 6.0)], (3, 0, 2, 2)),
    # ties: the screen's only zero is at 0, so its one run (1..4) does not
    # hold (the fold reaches 0 at 2): two walks, from 1 (to the fold's
    # zero at 2, not a screened zero) and from 3 (to the end), confirm
    # the excursions at 1 and 3.  Both emit; their rescans ([2, 2] and
    # [4, 4], one score -0.4 each) hold nothing: 3 ranges.
    ([-0.1, 0.4, -0.4, 0.4, -0.4], 0, 0.0,
     [(2, 2, 0.4), (4, 4, 0.4)], (3, 2, 2, 2)),
], ids=["integers", "ties"])
def test_extract_counters_by_hand(scores, min_width, min_score, want,
                                  counts):
    names = ("replay_ranges", "confirm_walks", "replays", "replay_emits")
    before = [getattr(extract, n) for n in names]
    got = extract.extract_segment_spans(np.array(scores, float), 1,
                                        min_width, min_score)
    assert got == want
    assert tuple(getattr(extract, n) - b
                 for n, b in zip(names, before)) == counts


def test_pulled_blocks_are_the_missing_candidates():
    """Four islands, a top C of 2: the candidate blocks the step missed
    are pulled (each batch pads its index list with its first block)."""
    rng = np.random.default_rng(7)
    seq = list(rng.choice(list("ACGT"), 40_000))
    for beg in (3000, 9000, 21000, 33000):
        seq[beg:beg + 600] = "CG" * 300
    arr = np.array(["ACTG".index(c) for c in seq], np.uint8)
    arr = np.concatenate([arr, np.full(-arr.size % 1024, 4, np.uint8)])
    w = np.full(16, -1.0)
    w[(1 << 2) | 3] = w[(3 << 2) | 1] = 2.0  # CG and GC
    w_q, scale = quantize_weight_table(w, 0.0, 1024)
    fn = make_weight_span_pipeline(2, block=1024, cand_blocks=2,
                                   device="cpu")
    out = {key: v.numpy() for key, v in fn(torch.from_numpy(arr),
                                           w_q).items()}
    asked = []

    def pull(nbases, idx):
        asked.append(set(idx.tolist()))
        return fn.pull(nbases, idx)

    before = finish.pulled_blocks
    with metrics.tracing() as rec:
        res = finish_weight_spans(out, arr.size, w, 0.0, 40, 20.0, scale,
                                  block=1024, pull_fn=pull,
                                  nbases_dev=torch.from_numpy(arr))
    assert len(res.regions) == 4 and asked
    assert finish.pulled_blocks - before == sum(map(len, asked)) \
        == rec.counters["spans.finish:pulled_blocks"]
    assert rec.by_name()["finish.pull"][0] == len(asked)
    # the library folds each candidate stretch once
    assert rec.counters["spans.extract:native_folds"] == \
        rec.by_name()["finish.assemble"][0] > 0


def test_an_exception_closes_the_spans_it_left_open():
    with metrics.tracing() as rec:
        outer = metrics.begin("t.outer")
        metrics.begin("t.inner")  # never ended: an exception passed it
        metrics.end(outer)
        after = metrics.begin("t.after")
        metrics.end(after)
    outer_s, inner_s, after_s = rec.spans
    assert outer_s.t0 <= inner_s.t0 <= inner_s.t1 <= outer_s.t1
    assert inner_s.parent == 0
    assert after_s.parent == -1 and after_s.call == 1


def test_phases_and_the_cli_metrics_json(tmp_path, capsys):
    m = metrics.Metrics()
    with metrics.tracing() as rec:
        with m.phase("count"):
            pass
    assert [s.name for s in rec.spans] == ["phase.count"]
    fa = tmp_path / "g.fa"
    write_fasta(str(fa), [("chr1", golden_genome())])
    cli.main(["stream", str(fa), "-k", "8", "--chunk", "32768", "--block",
              "512", "--cand-blocks", "32", "--device", "cpu", "--metrics"])
    got = json.loads(capsys.readouterr().err.splitlines()[1])
    assert set(got["spans"]) >= {"phase.count", "phase.rank"}
    assert all(v["count"] >= 1 and v["self_seconds"] >= 0
               for v in got["spans"].values())
    assert set(got["counters"]) == {f"{mod}:{attr}"
                                    for mod, attr in metrics.COUNTERS}
    assert [p["name"] for p in got["phases"][:2]] == ["count", "rank"]
