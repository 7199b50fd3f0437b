"""One run of one cell: set-up, the measured window, the metrics, and the
comparison that decides ``correct``.

The window is a closed loop with one caller: each call starts when the
previous one returns, cycling through a pool of seeded assemblies made in
set-up, and the window closes with the first call that ends
``seconds`` or more after it opened.  A traced run installs the metrics'
host spans and records the device with torch.profiler; an untraced run
drives the program exactly as users do.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from . import cells, genome, trace


@dataclasses.dataclass
class CallRecord:
    t0: float
    t1: float
    bases: int  # bases of the assembly called
    lengths: list[int]  # its sequences' lengths
    ok: bool


@dataclasses.dataclass
class RunRecord:
    """What the metrics' readers read."""

    config: dict
    setup_s: float
    window_s: float
    calls: list[CallRecord]
    spans: list[trace.Span]
    counters: dict[str, int]  # the change of each counter over the window
    device: trace.DeviceTrace | None

    @property
    def done(self) -> list[CallRecord]:
        return [c for c in self.calls if c.ok]

    def span_seconds(self, name: str, parent=...) -> float:
        """Seconds in the spans ``name`` (those inside ``parent`` only, if
        given; None: only those inside no other span)."""
        return sum(s.t1 - s.t0 for s in self.spans if s.name == name
                   and (parent is ... or s.parent == parent))

    def count(self, name: str) -> int:
        return sum(1 for s in self.spans if s.name == name)


def _digest(assembly) -> tuple:
    """Sums of the assembly's bytes in words of eight, plain and weighted
    by position, to see whether a call wrote into its input."""
    out = []
    for arr in (*assembly.bases, *assembly.valid):
        raw = arr.view(np.uint8)
        words = np.zeros(-(-raw.shape[0] // 8) * 8, np.uint8)
        words[:raw.shape[0]] = raw
        w = words.view(np.uint64)
        out.append((int(w.sum()), int(np.bitwise_xor.reduce(w)),
                    int((w * np.arange(1, w.shape[0] + 1,
                                       dtype=np.uint64)).sum())))
    return tuple(out)


def _card(device) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        out["nvidia_smi"] = smi.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out["nvidia_smi"] = f"unread: {exc}"
    return out


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, device="cuda", t_start: float | None = None,
             traffic: dict | None = None, workers: int = 1) -> dict:
    """One run; the result's dict, ``checks`` last.  ``traffic`` overrides
    parameters of the cell's traffic file (the tests' small sizes)."""
    if t_start is None:
        t_start = time.perf_counter()
    cell = cells.find_cell(root, cells.load_benchmark(root), workload)
    cell.traffic.update(traffic or {})
    cfg, call = cell.config, cell.call
    import torch

    from kmer_spans_tpu_torch import api

    t_inputs = time.perf_counter()
    pool = [genome.make_assembly(cell.traffic, seed, i, device)
            for i in range(int(cell.traffic["pool"]))]
    digests = [_digest(a) for a in pool]
    inputs = [call.program_input(a) for a in pool]
    checked = int(np.random.default_rng([seed, 1]).integers(len(pool)))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # the warm-up: builds and loads the kernels, fills the allocator
    t_warm = time.perf_counter()
    call.run(api, inputs[(checked + 1) % len(pool)], cfg, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"# set-up {setup_s:.3f} s: imports {t_inputs - t_start:.3f}, "
          f"inputs {t_warm - t_inputs:.3f}, warm-up call "
          f"{t_start + setup_s - t_warm:.3f}", file=sys.stderr)

    metrics = cell.per_layer if traced else cell.end_to_end
    readers = {m["name"]: cells.reader(cell, m) for m in metrics}
    specs = [s for r in readers.values() for s in getattr(r, "SPANS", ())]
    counters = {k: v for r in readers.values()
                for k, v in getattr(r, "COUNTERS", {}).items()}
    tracer = trace.Tracer(specs) if traced else None
    before = trace.read_counters(counters)
    profiler = (trace.Profiler() if traced and cuda
                else contextlib.nullcontext())
    calls, kept = [], []
    try:
        with profiler:
            opened = time.perf_counter()
            i = checked  # the checked assembly is called first
            while True:
                j = i % len(pool)
                if tracer is not None:
                    tracer.call = len(calls)
                t0 = time.perf_counter()
                try:
                    res = call.run(api, inputs[j], cfg, device)
                except Exception:  # a failed call counts; the loop goes on
                    if all(c.ok for c in calls):
                        traceback.print_exc()  # the first failure's
                    res = None
                t1 = time.perf_counter()
                calls.append(CallRecord(t0, t1, pool[j].total,
                                        pool[j].lengths, res is not None))
                if j == checked and res is not None:
                    kept.append(call.answer(res))
                del res
                i += 1
                if t1 - opened >= seconds:
                    break
    finally:
        if tracer is not None:
            tracer.remove()
    window_s = calls[-1].t1 - opened
    after = trace.read_counters(counters)
    device_info = _card(device)
    record = RunRecord(
        config=cfg, setup_s=setup_s,
        window_s=window_s, calls=calls,
        spans=tracer.spans if tracer else [],
        counters={k: after[k] - before[k] for k in after},
        device=profiler.result() if traced and cuda else None)

    values = {}
    for m in metrics:
        value = readers[m["name"]].read(record)
        if value is not None:
            values[m["name"]] = {"value": float(value), "unit": m["unit"]}
    extra = {}
    if record.device is not None:
        device_info["busy_s"] = record.device.busy_s
        device_info["window_s"] = record.device.window_s
        extra["breakdown"] = trace.breakdown(
            record.device, record.spans, [(c.t0, c.t1) for c in calls])

    # the comparison, after the window, with the program's state freed
    del inputs, record
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = call.reference(pool[checked], cfg, np.float64, workers, device)
    found = [call.compare(got, want) for got in kept]
    checks = {name: {"value": max((f[name] for f in found), default=0),
                      "limit": limit} for name, limit in call.CHECKS}
    checks["answers_missing"] = {"value": int(not kept), "limit": 0}
    checks["inputs_changed"] = {
        "value": sum(d != _digest(a) for d, a in zip(digests, pool)),
        "limit": 0}
    wrong = sum(any(f[n] > lim for n, lim in call.CHECKS) for f in found)
    failed = sum(not c.ok for c in calls) + wrong
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    print("# call walls, s: " + " ".join(f"{c.t1 - c.t0:.3f}" for c in calls)
          + f"; set-up {setup_s:.3f} s", file=sys.stderr)
    print(f"# reference {time.perf_counter() - t_ref:.3f} s on assembly "
          f"{checked} of the pool ({call.size(want)}); {len(kept)} answers "
          "compared", file=sys.stderr)
    return {"correct": bool(correct), "attempted": len(calls),
            "failed": int(failed), "metrics": values, "device": device_info,
            **extra, "checks": checks}
