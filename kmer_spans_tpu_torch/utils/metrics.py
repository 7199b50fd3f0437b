"""Per-phase metrics (the port's copy of
``kmer_spans_tpu/utils/metrics.py``) and the program's span recorder.

Every pipeline phase reports structured numbers (bases processed, phase
wall time, bases/s and any extra fields) through a lightweight recorder.
``StreamingSpanPipeline.run`` and the CLI's ``--metrics`` use it.  The
reference's optional jax.profiler trace around each phase has no caller
in the port and is left out.

The span recorder is process-wide and off by default; ``tracing()`` turns
it on for the work inside it and hands out what it recorded:

    with metrics.tracing() as rec:
        api.kmer_low_comp_regions(seqs, 8, 100, 50.0, thr=0.6)
    rec.spans      # Span(name, t0, t1, parent, call, attrs), in open order
    rec.counters   # what the work added to each of COUNTERS

A span site inside the program costs one test of ``enabled`` while the
recorder is off, and reads no clock:

    sp = metrics.begin("finish.pull") if metrics.enabled else None
    ...
    if sp is not None:
        metrics.end(sp)

Spans use ``time.perf_counter()``, the host clock a device trace can be
anchored to; they nest by a stack of open spans, so one thread records at
a time.  ``Metrics.phase`` opens a span ``phase.<name>`` too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import json
import logging
import time

logger = logging.getLogger("kmer_spans_tpu_torch")


@dataclasses.dataclass
class PhaseStat:
    name: str
    seconds: float
    bases: int = 0
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def bases_per_sec(self) -> float:
        return self.bases / self.seconds if self.seconds > 0 else 0.0


class Metrics:
    """Collects per-phase stats; emits one structured log line per phase."""

    def __init__(self):
        self.phases: list[PhaseStat] = []

    @contextlib.contextmanager
    def phase(self, name: str, bases: int = 0, **extra):
        sp = begin(f"phase.{name}") if enabled else None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if sp is not None:
                end(sp)
            stat = PhaseStat(name=name, seconds=dt, bases=bases, extra=extra)
            self.phases.append(stat)
            logger.info(
                "phase=%s seconds=%.4f bases=%d bases_per_sec=%.3g %s",
                name, dt, bases, stat.bases_per_sec,
                " ".join(f"{k}={v}" for k, v in extra.items()),
            )

    def record(self, name: str, seconds: float, bases: int = 0, **extra):
        self.phases.append(
            PhaseStat(name=name, seconds=seconds, bases=bases, extra=extra)
        )

    def summary(self, recorder: Recorder | None = None) -> dict:
        """The phases; with a closed ``recorder``, also each span name's
        count and self seconds, and its counters."""
        out = {
            "phases": [
                {
                    "name": p.name,
                    "seconds": round(p.seconds, 6),
                    "bases": p.bases,
                    "bases_per_sec": round(p.bases_per_sec, 1),
                    **p.extra,
                }
                for p in self.phases
            ],
            "total_seconds": round(sum(p.seconds for p in self.phases), 6),
        }
        if recorder is not None:
            out["spans"] = {
                name: {"count": n, "self_seconds": round(sec, 6)}
                for name, (n, sec) in recorder.by_name().items()}
            out["counters"] = dict(recorder.counters)
        return out

    def dump(self, recorder: Recorder | None = None) -> str:
        return json.dumps(self.summary(recorder))


# ---------------------------------------------------------------------------
# The span recorder
# ---------------------------------------------------------------------------

#: True while a ``tracing()`` context is open: every span site tests it
#: first
enabled = False
_recorder: Recorder | None = None

#: the program's work counters (module of the package, attribute): each
#: module's int, counted whether the recorder is on or off; a recorder
#: keeps what the work inside it added to each, under "module:attribute"
COUNTERS = (
    ("parallel.device", "staged_bytes"),
    ("spans.finish", "pulled_blocks"),
    ("spans.extract", "replays"),
    ("spans.extract", "replay_emits"),
    ("spans.extract", "native_folds"),
    ("spans.extract", "table_folds"),
    ("spans.pipeline", "graph_steps"),
    ("spans.pipeline", "graph_captures"),
    ("parallel.window_stream", "chunks"),
    ("parallel.window_stream", "window_starts"),
    ("ops.window", "window_counts_launches"),
    ("api", "fast_runs"),
    ("api", "fast_pulled_bytes"),
)


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    parent: int  # index of the span it ran inside, -1 for none
    call: int  # the top-level call: the outermost span it ran inside
    attrs: dict


def _read_counters() -> dict[str, int]:
    pkg = __name__.rsplit(".", 2)[0]
    return {f"{mod}:{attr}": int(getattr(
                importlib.import_module(f"{pkg}.{mod}"), attr))
            for mod, attr in COUNTERS}


class Recorder:
    """The spans recorded while ``tracing()`` was open, in the order they
    opened: ``spans`` and ``counters`` once it has closed.

    While open it keeps each field in a list of its own, so that a span
    adds no object the garbage collector has to walk."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._open: list[int] = []  # indices of the open spans
        self._calls = 0
        self._name: list[str] = []
        self._t0: list[float] = []
        self._t1: list[float] = []
        self._parent: list[int] = []
        self._call: list[int] = []
        self._attrs: dict[int, dict] = {}
        self._events: dict[int, tuple] = {}  # CUDA event pairs

    def begin(self, name: str, device=None, attrs=None) -> int:
        i = len(self._name)
        if self._open:
            parent = self._open[-1]
            self._call.append(self._call[parent])
        else:
            parent = -1
            self._call.append(self._calls)
            self._calls += 1
        self._name.append(name)
        self._parent.append(parent)
        self._t1.append(float("nan"))
        if attrs:
            self._attrs[i] = attrs
        if device is not None and device.type == "cuda":
            import torch
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            self._events[i] = ev
            ev[0].record()
        self._open.append(i)
        self._t0.append(time.perf_counter())
        return i

    def end(self, i: int, attrs=None) -> None:
        # spans left open inside it (an exception passed them) close too
        while self._open:
            j = self._open.pop()
            if j in self._events:
                self._events[j][1].record()
            self._t1[j] = time.perf_counter()
            if j == i:
                break
        if attrs:
            self._attrs.setdefault(i, {}).update(attrs)

    def close(self) -> None:
        """Closes what is still open and builds ``spans``; reads each
        span's device time, once the host has waited for its work (a later
        copy to the host did)."""
        if self._open:
            self.end(self._open[0])
        for i, (e0, e1) in self._events.items():
            if e1.query():
                self._attrs.setdefault(i, {})["device_ms"] = \
                    e0.elapsed_time(e1)
        self.spans = [Span(*f, self._attrs.get(i, {})) for i, f in enumerate(
            zip(self._name, self._t0, self._t1, self._parent, self._call))]
        self._events.clear()

    def by_name(self) -> dict[str, tuple[int, float]]:
        """{name: (count, self seconds)}: a span's self time is its
        duration less its children's."""
        child_s = [0.0] * len(self.spans)
        for sp in self.spans:
            if sp.parent >= 0:
                child_s[sp.parent] += sp.t1 - sp.t0
        out: dict[str, list] = {}
        for sp, inner in zip(self.spans, child_s):
            n_s = out.setdefault(sp.name, [0, 0.0])
            n_s[0] += 1
            n_s[1] += sp.t1 - sp.t0 - inner
        return {name: (n, s) for name, (n, s) in out.items()}


@contextlib.contextmanager
def tracing():
    """Turns the process-wide recorder on for the work inside; yields the
    Recorder, which holds its spans and counters once the context ends.
    Contexts do not nest."""
    global enabled, _recorder
    if _recorder is not None:
        raise RuntimeError("the span recorder is already on")
    rec = Recorder()
    before = _read_counters()
    _recorder, enabled = rec, True
    try:
        yield rec
    finally:
        enabled, _recorder = False, None
        rec.close()
        rec.counters = {key: value - before[key]
                        for key, value in _read_counters().items()}


def begin(name: str, device=None, **attrs) -> int:
    """Opens a span; a site calls it only where ``enabled``.  A CUDA
    ``device`` puts a CUDA event pair around the span's work: its
    ``device_ms`` attribute."""
    return _recorder.begin(name, device, attrs)


def end(i: int, **attrs) -> None:
    """Closes the span ``i`` (and any left open inside it)."""
    rec = _recorder
    if rec is not None:
        rec.end(i, attrs)


def traced(name: str):
    """A decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not enabled:
                return fn(*args, **kwargs)
            i = begin(name)
            try:
                return fn(*args, **kwargs)
            finally:
                end(i)
        return run
    return wrap
