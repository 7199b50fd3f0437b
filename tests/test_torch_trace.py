"""The port's span recorder (kmer_spans_tpu_torch/utils/metrics.py) and
the counters of the exact path and the window path, on the CPU.

The recorder is off by default and keeps nothing then; inside
``tracing()`` the exact path's and the window path's spans nest under the
api call that made them, and the answers are bit-identical either way.
The counters of spans/extract.py, spans/finish.py and
parallel/window_stream.py equal counts worked out by hand."""

import json

import numpy as np
import pytest
import torch
from test_torch_extract import SCORES_A, SCORES_B

from kmer_spans_tpu_torch import api, cli
from kmer_spans_tpu_torch.encoding import PackedSeq
from kmer_spans_tpu_torch.io.fasta import write_fasta
from kmer_spans_tpu_torch.oracle import golden_genome
from kmer_spans_tpu_torch.parallel import device as pdevice
from kmer_spans_tpu_torch.parallel import window_stream
from kmer_spans_tpu_torch.spans import extract, finish
from kmer_spans_tpu_torch.spans.finish import finish_weight_spans
from kmer_spans_tpu_torch.spans.pipeline import (
    make_weight_span_pipeline,
    quantize_weight_table,
)
from kmer_spans_tpu_torch.utils import metrics, native

FINISH_CHILDREN = {"finish.pull", "finish.assemble", "extract.fold"}


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
    for name in FINISH_CHILDREN & set(parent_of):
        assert parent_of[name] == {"finish.weight"}
    stretches = rec.by_name()["finish.assemble"][0]
    assert rec.counters["spans.extract:native_folds"] == stretches \
        == rec.counters["spans.extract:table_folds"] \
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


def test_numpy_path_spans_nest_under_the_finish():
    """The finish's one fold: on the same two sequences each candidate
    stretch's ``extract.fold`` lies in ``finish.weight``, after its
    assembly; the counters count one fold a stretch, every region among
    the emissions and at least as many candidate excursions, and the
    regions are those of the recorder off."""
    seqs = _two_sequences()
    off = _low_comp(seqs)
    with metrics.tracing() as rec:
        got = _low_comp(seqs)
    assert got.tobytes() == off.tobytes() and got.size
    parent_of = _finish_parents(rec)
    assert {"finish.assemble", "extract.fold"} <= set(parent_of)
    for name in FINISH_CHILDREN & set(parent_of):
        assert parent_of[name] == {"finish.weight"}
    names = [s.name for s in rec.spans if s.name in ("finish.assemble",
                                                      "extract.fold")]
    assert names == ["finish.assemble", "extract.fold"] * (len(names) // 2)
    c = rec.counters
    assert c["spans.extract:native_folds"] == len(names) // 2 > 0
    assert c["spans.extract:replay_emits"] == got.size
    assert c["spans.extract:replays"] >= got.size


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
    # integers: the fold finds the excursions at 0 (S 1, 2, then 0 at 2;
    # 1 >= min_width 1 long, max 2) and at 3 (S 2, 4, 6, then 0 at 6);
    # the one at 7 is too short.  Both candidates emit; each rescan
    # ([2, 2] and [6, 6]) holds no positive score: one fold.
    ([1, 1, -5, 2, 2, 2, -10, 3], 1, 2.0,
     [(1, 2, 2.0), (4, 6, 6.0)], (2, 2, 1)),
    # ties: the fold reaches 0 at 2 (0.4 - 0.4) and at 4: the excursions
    # at 1 and 3 are candidates and emit; their rescans ([2, 2] and
    # [4, 4], one score -0.4 each) hold nothing: one fold.
    ([-0.1, 0.4, -0.4, 0.4, -0.4], 0, 0.0,
     [(2, 2, 0.4), (4, 4, 0.4)], (2, 2, 1)),
], ids=["integers", "ties"])
def test_extract_counters_by_hand(scores, min_width, min_score, want,
                                  counts):
    names = ("replays", "replay_emits", "native_folds", "table_folds")
    before = [getattr(extract, n) for n in names]
    scores = np.array(scores, float)
    got = extract.extract_spans(scores, np.ones(scores.shape[0], bool),
                                min_width, min_score)
    assert [r[1:] for r in got] == want
    # precomputed scores: no fold reads a table
    assert tuple(getattr(extract, n) - b
                 for n, b in zip(names, before)) == counts + (0,)


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
    # the library folds each candidate stretch once, from the table
    assert rec.counters["spans.extract:native_folds"] == \
        rec.counters["spans.extract:table_folds"] == \
        rec.by_name()["finish.assemble"][0] > 0


@pytest.mark.parametrize("call", [
    pytest.param(lambda: _low_comp(_two_sequences()), id="low_comp"),
    pytest.param(lambda: api.kmer_regions(
        _two_sequences(), 2, [-0.5, 0.1, -0.3, 0.6] * 4, 40, 5.0,
        device="cpu").regions, id="kmer_regions_scan_counts"),
])
def test_every_exact_fold_reads_the_table(call):
    """On the exact path every fold reads its scores from the weight
    table: ``table_folds`` equals ``native_folds`` and the candidate
    stretches assembled, one ``extract.fold`` each."""
    with metrics.tracing() as rec:
        got = call()
    c = rec.counters
    assert got.size
    assert c["spans.extract:table_folds"] == c["spans.extract:native_folds"] \
        == rec.by_name()["finish.assemble"][0] \
        == rec.by_name()["extract.fold"][0] > 0


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


def _window_assembly():
    """Three sequences with N gaps: one longer than the largest chunk
    (2^22 starts), one shorter than the least (2^15), and one of at most
    the window (skipped)."""
    rng = np.random.default_rng(19)
    seqs = []
    for n in ((1 << 22) + 5_000, 9_000, 150):
        bases = rng.integers(0, 4, n).astype(np.uint8)
        valid = np.ones(n, bool)
        valid[n // 3:n // 3 + 40] = False
        seqs.append(PackedSeq(bases=bases, valid=valid))
    return seqs


def _engine_chunks(n: int) -> int:
    """The chunks parallel/device.py device_window_dist streams a sequence
    through: the length's power of two within [2^15, 2^22]."""
    chunk = 1 << 15
    while chunk < n and chunk < (1 << 22):
        chunk *= 2
    return -(-n // chunk)


def test_window_spans_nest_and_count():
    """``api.window_kmer_dist`` holds a ``window.sequence`` a counted
    sequence, and each holds its stage, chunk loop and pull; the counters
    equal the chunks and the window starts worked out from the lengths."""
    seqs = _window_assembly()
    with metrics.tracing() as rec:
        got = api.window_kmer_dist(seqs, ["CG", "GC", "TA"], 200,
                                   device="cpu")
    assert list(got.seq_i) == [1, 1, 0]
    sp = rec.spans
    assert [s.name for s in sp if s.parent < 0] == ["api.window_kmer_dist"]
    parent_of = _finish_parents(rec)
    assert parent_of["window.sequence"] == {"api.window_kmer_dist"}
    for name in ("window.stage", "window.chunks", "window.pull"):
        assert parent_of[name] == {"window.sequence"}
    for s in sp:
        if s.parent >= 0:
            p = sp[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1
    by_seq = [[c.name for c in sp if c.parent == i]
              for i, s in enumerate(sp) if s.name == "window.sequence"]
    assert by_seq == [["window.stage", "window.chunks", "window.pull"]] * 2
    assert [(s.attrs["seq_id"], s.attrs["bases"]) for s in sp
            if s.name == "window.sequence"] == [(0, (1 << 22) + 5_000),
                                             (1, 9_000)]
    counted = [p.n for p in seqs if p.n > 200]
    assert rec.counters["parallel.window_stream:chunks"] == \
        sum(_engine_chunks(n) for n in counted) == 2 + 1
    assert rec.counters["parallel.window_stream:window_starts"] == \
        sum(n - 200 + 1 for n in counted)
    # the window path runs no span step and stages nothing through
    # staged_nbases
    assert rec.counters["parallel.device:staged_bytes"] == 0


def test_window_sites_cost_nothing_while_off(monkeypatch):
    """With the recorder off no site opens a span or makes a CUDA event,
    the counters still count, and the answer is the one it gives on."""
    seqs = _window_assembly()
    kmers = ["CG", "GC", "TA"]
    with metrics.tracing():
        on = api.window_kmer_dist(seqs, kmers, 200, device="cpu")
    made = []
    monkeypatch.setattr(metrics, "begin", lambda *a, **kw: made.append(a))
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **kw: made.append("event"))
    before = window_stream.chunks
    off = api.window_kmer_dist(seqs, kmers, 200, device="cpu")
    assert made == [] and not metrics.enabled
    assert window_stream.chunks - before == 3
    assert off.dist.tobytes() == on.dist.tobytes()
    assert np.array_equal(off.seq_i, on.seq_i)
