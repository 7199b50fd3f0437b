"""The program's own spans, for the readers of a traced run.

kmer_spans_tpu_torch/utils/metrics.py records spans inside the program
while its ``tracing()`` context is open (off by default).  A traced run
opens it around the window and hands what it recorded to the readers:

  * a reader that needs the program's spans sets ``SPANS = WINDOW``.  The
    runner iterates every reader's SPANS once, after the warm-up and just
    before the window opens; iterating WINDOW opens the program's
    recorder (and names no wrapper span).  Untraced runs load no
    per-layer reader, so the recorder stays off there;
  * ``spans(run)``, at the first read after the window, closes the
    recorder, puts each span in the window call that contains it, keeps
    them on the run (``run.program_spans``) and adds them to
    ``run.spans`` too, so that the breakdown labels each idle gap of the
    device by the innermost open span, the program's or a wrapper's.  The
    program's names all hold a dot; the wrappers' hold none.

A program without the recorder (an older commit) gives no spans: its
readers find nothing and return None.
"""

from __future__ import annotations

import bisect
import dataclasses

from . import trace


@dataclasses.dataclass
class ProgramSpan:
    name: str
    t0: float
    t1: float
    parent: int  # index of the span it ran inside, -1: none
    call: int  # the window call that contains it (-1: none)
    attrs: dict


#: (the tracing context, its recorder) while a window is recorded
_open = None


def _close():
    """The recorder's spans, closed; None when none was open."""
    global _open
    if _open is None:
        return None
    ctx, rec = _open
    _open = None
    ctx.__exit__(None, None, None)
    return rec.spans


class _OpensTheRecorder:
    """A reader's SPANS: iterating it opens the program's recorder."""

    def __iter__(self):
        _close()  # one a previous run left open records nothing here
        global _open
        try:
            from kmer_spans_tpu_torch.utils import metrics
        except ImportError:
            return iter(())
        if hasattr(metrics, "tracing"):
            ctx = metrics.tracing()
            _open = (ctx, ctx.__enter__())
        return iter(())


WINDOW = _OpensTheRecorder()


def spans(run) -> list[ProgramSpan]:
    """The program's spans of the run's window (see the module's doc)."""
    got = getattr(run, "program_spans", None)
    if got is not None:
        return got
    raw = _close() or []
    starts = [c.t0 for c in run.calls]
    got = []
    for sp in raw:
        c = bisect.bisect_right(starts, sp.t0) - 1
        if c >= 0 and sp.t1 > run.calls[c].t1:
            c = -1
        got.append(ProgramSpan(sp.name, sp.t0, sp.t1, sp.parent, c,
                               dict(sp.attrs)))
    run.program_spans = got
    run.spans.extend(as_trace_spans(got))
    return got


def as_trace_spans(got: list[ProgramSpan]) -> list[trace.Span]:
    """The program's spans as the wrappers' (the parent by name)."""
    return [trace.Span(s.name, s.t0, s.t1,
                       got[s.parent].name if s.parent >= 0 else None,
                       s.call) for s in got]


def seconds(run, name: str) -> float | None:
    """Seconds in the spans ``name`` inside window calls: 0 where the
    program recorded others but none of these (no pull in the window),
    None where it recorded none."""
    got = spans(run)
    if not got:
        return None
    return sum(s.t1 - s.t0 for s in got if s.name == name and s.call >= 0)


def self_seconds(run, name: str) -> float | None:
    """Seconds in the spans ``name`` inside window calls less their child
    spans' (0 and None as ``seconds``)."""
    got = spans(run)
    if not got:
        return None
    mine = {i for i, s in enumerate(got) if s.name == name and s.call >= 0}
    total = sum(got[i].t1 - got[i].t0 for i in mine)
    inner = sum(s.t1 - s.t0 for s in got if s.parent in mine)
    return total - inner


def attr_sum(run, name: str, key: str) -> float | None:
    """The sum of attribute ``key`` over the spans ``name``; None where
    none has it."""
    vals = [s.attrs[key] for s in spans(run)
            if s.name == name and s.call >= 0 and key in s.attrs]
    return sum(vals) if vals else None


def per_call(run, value) -> float | None:
    """``value`` (seconds) as ms a done call; None without either."""
    if value is None or not run.done:
        return None
    return 1e3 * value / len(run.done)
