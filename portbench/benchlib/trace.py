"""Host spans around the program's layer calls, its counters, and the
device trace of a traced window.

Spans come from the benchmark's own wrappers, installed only for a traced
run: a metric's reader lists what it needs, each span as a dict

  * ``{"name": n, "targets": ["pkg.module:attr", ...]}``: every call of
    those functions (module attributes, replaced while the run lasts);
  * ``"wrap": "result"``: the calls of the callable that the target
    returns, ``"sync": true`` to synchronize the device before the span
    closes;
  * ``"wrap": "result_attr", "attr": a``: the calls of its attribute a.

Each span records its name, start and end on the host clock, the span it
ran inside and the window call it belongs to.  Counters are module
attributes of the program read before and after the window.  The device
trace is torch.profiler's (CUDA activity only), reduced to busy time, the
kernels by name and the idle gaps by what the host was doing.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
import tempfile
import time
from collections import defaultdict


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    parent: str | None  # the name of the span it ran inside
    call: int  # the window call it belongs to (-1: outside every call)


def _resolve(target: str):
    """(module, attribute name) of "pkg.module:attr"; None, with a note,
    where the program no longer has it (its readers then find nothing)."""
    mod_name, attr = target.split(":")
    try:
        mod = importlib.import_module(mod_name)
    except ImportError:
        mod = None
    if mod is None or not hasattr(mod, attr):
        print(f"# {target} not found: its spans or counter stay empty",
              file=sys.stderr)
        return None
    return mod, attr


class Tracer:
    """Installs the span wrappers, records spans; ``remove`` restores."""

    def __init__(self, specs: list[dict]):
        self.spans: list[Span] = []
        self.call = -1
        self._stack: list[str] = []
        self._saved = []
        by_target = defaultdict(dict)  # one wrapper a span and target
        for spec in specs:
            key = (spec["name"], spec.get("wrap", "call"), spec.get("attr"))
            for target in spec["targets"]:
                by_target[target].setdefault(key, spec)
        for target, group in by_target.items():
            found = _resolve(target)
            if found is None:
                continue
            mod, attr = found
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(orig, list(group.values())))

    def remove(self) -> None:
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []

    def timed(self, name: str, fn, sync: bool = False):
        def run(*args, **kwargs):
            parent = self._stack[-1] if self._stack else None
            self._stack.append(name)
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                if sync:
                    import torch
                    if torch.cuda.is_available():
                        torch.cuda.synchronize()
            finally:
                t1 = time.perf_counter()
                self._stack.pop()
                self.spans.append(Span(name, t0, t1, parent, self.call))
            return out
        return run

    def _wrap(self, orig, group: list[dict]):
        fn = orig
        for spec in group:
            if spec.get("wrap", "call") == "call":
                fn = self.timed(spec["name"], fn)
        results = [s for s in group if s.get("wrap", "call") != "call"]
        if not results:
            return fn

        def factory(*args, **kwargs):
            made = fn(*args, **kwargs)
            proxy = made
            for spec in results:
                if spec["wrap"] == "result":
                    proxy = self.timed(spec["name"], proxy,
                                       bool(spec.get("sync")))
            for key, value in vars(made).items():
                setattr(proxy, key, value)
            for spec in results:
                if spec["wrap"] == "result_attr":
                    setattr(proxy, spec["attr"], self.timed(
                        spec["name"], getattr(made, spec["attr"])))
            return proxy
        return factory


def read_counters(counters: dict[str, str]) -> dict[str, int]:
    """{name: value} of each counter, a "pkg.module:attr" of the program."""
    out = {}
    for name, target in counters.items():
        found = _resolve(target)
        if found is not None:
            out[name] = int(getattr(*found))
    return out


# ---------------------------------------------------------------------------
# The device trace
# ---------------------------------------------------------------------------

#: categories of device activity in a chrome trace of torch.profiler
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the host annotations that open and close the traced window: the
#: anchors between the host clock and the trace's
_OPEN, _CLOSE = "portbench.open", "portbench.close"


def base_name(name: str) -> str:
    """A kernel's name without its parameter list, return type, template
    arguments and namespaces: "void ns::k<4>(int*)" is "k"."""
    head = name.replace("(anonymous namespace)", "")
    head = head.split("(")[0].split("<")[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


@dataclasses.dataclass
class DeviceTrace:
    """A traced window's device activity, on the host clock."""

    window_s: float
    busy_s: float
    ops: list[tuple[str, float, float]]  # (name, start, duration)
    gaps: list[tuple[float, float]]  # idle (start, end)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_trace(events: list[dict], host0: float, host1: float):
    """The device activity between the two anchors, which the host clock
    read as host0 and host1; None without both."""
    marks = {e["name"]: e["ts"] for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") in (_OPEN, _CLOSE)}
    if len(marks) < 2:
        return None
    a0, a1 = marks[_OPEN] * 1e-6, marks[_CLOSE] * 1e-6
    scale = (host1 - host0) / (a1 - a0) if a1 > a0 else 1.0

    def host(ts_us):
        return host0 + (ts_us * 1e-6 - a0) * scale

    ops = []
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        t0 = host(e["ts"])
        if host0 <= t0 <= host1:
            ops.append((e["name"], t0,
                        float(e.get("dur", 0)) * 1e-6 * scale))
    busy = _union([(t, min(t + d, host1)) for _, t, d in ops])
    busy_s = sum(b - a for a, b in busy)
    gaps, at = [], host0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < host1:
        gaps.append((at, host1))
    return DeviceTrace(window_s=host1 - host0, busy_s=busy_s, ops=ops,
                       gaps=gaps)


class Profiler:
    """torch.profiler over the window: the card's activity, and the host's
    for the two annotations that anchor the trace's clock to the host's."""

    def __init__(self, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self._cuda = cuda
        self._prof = profile(activities=acts)

    def _mark(self, name: str) -> float:
        import torch
        from torch.profiler import record_function
        if self._cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        with record_function(name):
            pass
        return t

    def __enter__(self):
        self._prof.__enter__()
        self.host0 = self._mark(_OPEN)
        return self

    def __exit__(self, *exc):
        self.host1 = self._mark(_CLOSE)
        self._prof.__exit__(*exc)
        return False

    def result(self) -> DeviceTrace | None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.unlink(path)
        out = reduce_trace(events, self.host0, self.host1)
        if self._cuda and (out is None or not out.ops):
            cats = defaultdict(int)
            for e in events:
                cats[e.get("cat")] += 1
            print(f"# the device trace gave nothing: {dict(cats)}",
                  file=sys.stderr)
        return out


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without its return type and parameter list, at most
    ``limit`` long."""
    head = name.replace("(anonymous namespace)::", "")
    head = head.removeprefix("void ").split("(")[0].strip() or name
    return head[:limit]


def host_activity(spans: list[Span], call_times, times) -> list[str]:
    """What the host was doing at each of the sorted ``times``: the
    innermost span open then, else "call" inside a window call, else
    "between calls".  Spans nest (one thread), so a sweep keeps the open
    ones as a stack."""
    edges = sorted([(s.t0, 1, -s.t1, s.name) for s in spans]
                   + [(s.t1, 0, 0.0, s.name) for s in spans])
    calls = sorted(call_times)
    out, stack, i, j = [], [], 0, 0
    for t in times:
        while i < len(edges) and edges[i][0] <= t:
            _, opens, _, name = edges[i]
            if opens:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            i += 1
        while j < len(calls) and calls[j][1] < t:
            j += 1
        if stack:
            out.append(stack[-1])
        elif j < len(calls) and calls[j][0] <= t:
            out.append("call")
        else:
            out.append("between calls")
    return out


def breakdown(trace: DeviceTrace, spans: list[Span], call_times) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by what the host was doing in them."""
    by_op = defaultdict(float)
    for name, _, d in trace.ops:
        by_op[short_name(name)] += d
    mids = [0.5 * (a + b) for a, b in trace.gaps]
    by_host = defaultdict(float)
    for (a, b), label in zip(trace.gaps,
                             host_activity(spans, call_times, mids)):
        by_host[label] += b - a
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
