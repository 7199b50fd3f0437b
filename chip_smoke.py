#!/usr/bin/env python3
"""Drive the PyTorch port (kmer_spans_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--bases N]

Run from the repository root.  Phases, each of which raises on failure:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds the CUDA kernels from kmer_spans_tpu_torch/csrc/;
  3. each kernel against its plain PyTorch version on the card, exact, on
     seeded inputs (random aug words with invalid positions, a stretch of
     2^17 identical codes, blocks with no scored position);
  4. the golden genome through api.kmer_low_comp_regions(mode="fast") on
     the card: exactly the 3 planted regions, equal (==) to the
     sequential oracle's rank chain;
  5. the full-size main path: N bases (default 2^28) from --seed, repeat
     islands and N gaps planted, through make_span_pipeline(packed=True)
     -> unpack_outputs -> finish_spans; kernel launch counts read around
     this run; the packed vector and regions must equal the same run with
     the plain versions on the card;
  6. each kernel and its plain version timed (CUDA events) on the aug
     words of that genome: the main path's shapes (N positions, block
     8192, k = 8).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np

THR, MIN_W, MIN_S = 0.75, 100, 20.0
BLOCK = 8192


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def make_genome(n: int, seed: int) -> np.ndarray:
    """Random bases (N as 4) with repeat islands and N gaps planted as in
    bench.py: a 3000-base alternating island every 5 Mb from 1 Mb, a
    100-base N gap every 10 Mb from 2.5 Mb."""
    rng = np.random.default_rng(seed)
    nbases = rng.integers(0, 4, size=n, dtype=np.uint8)
    for start in range(1_000_000, n - 5000, 5_000_000):
        nbases[start:start + 3000] = np.tile(np.array([0, 3], np.uint8), 1500)
    for start in range(2_500_000, n - 200, 10_000_000):
        nbases[start:start + 100] = 4
    return nbases


def time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    import torch

    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max().item()) if g.numel() else 0)
    return err


def aug_case(rng, n, k):
    codes = rng.integers(0, 1 << (2 * k), n).astype(np.int32)
    valid = rng.random(n) < 0.9
    scored = valid & (rng.random(n) < 0.85)
    return (codes | (valid.astype(np.int32) << 16)
            | (scored.astype(np.int32) << 17)).astype(np.int32)


def check_kernels(dev, seed: int) -> dict:
    """Phase 3: every kernel against its plain version, exact."""
    import torch

    from kmer_spans_tpu_torch.ops.convert import to_tensor
    from kmer_spans_tpu_torch.ops.histogram import count_aug, count_aug_plain
    from kmer_spans_tpu_torch.ops.screen_scan import (
        fused_screen_scan,
        fused_screen_scan_plain,
    )

    rng = np.random.default_rng(seed)
    err = {"count_aug": 0, "fused_screen_scan": 0}
    for k in (4, 6, 8):
        aug = aug_case(rng, (1 << 22) + 5, k)
        aug[7000:7000 + (1 << 17)] = (1 << 16) | 9  # 2^17 identical codes
        x = to_tensor(aug, dev)
        for view in (x, x[1:]):  # 16-byte aligned and unaligned starts
            e = max_abs_err(count_aug(view, k), count_aug_plain(view, k))
            torch.cuda.synchronize()
            if e:
                raise AssertionError(f"count_aug k={k}: max |err| {e}")
            err["count_aug"] = max(err["count_aug"], e)
        log(f"  count_aug k={k}: equal to plain (n={aug.size:,}, "
            "2^17 identical codes)")
    for k in (4, 8):
        for cb in (2, 4):
            for block in (1024, 8192):
                nw = (1 << (2 * k)) // (32 // cb)
                words = rng.integers(-(2 ** 31), 2 ** 31, nw,
                                     dtype=np.int64).astype(np.int32)
                aug = aug_case(rng, 40 * block, k)
                aug[block:2 * block] &= ~(1 << 17)  # no scored position
                args = (to_tensor(words, dev), to_tensor(aug, dev),
                        torch.tensor(3071, dtype=torch.int32, device=dev),
                        cb, block)
                got = fused_screen_scan(*args)
                want = fused_screen_scan_plain(*args)
                torch.cuda.synchronize()
                e = max_abs_err(got, want)
                if e:
                    raise AssertionError(
                        f"fused_screen_scan k={k} class_bits={cb} "
                        f"block={block}: max |err| {e}")
                if got[1][1].item() > -(1 << 29):
                    raise AssertionError("no-scored sentinel lost")
                err["fused_screen_scan"] = max(err["fused_screen_scan"], e)
        log(f"  fused_screen_scan k={k}: equal to plain (class_bits 2/4, "
            "block 1024/8192)")
    return err


def time_kernels(dev, nbases_dev) -> dict:
    """Phase 6: kernel and plain version at the main path's shapes."""
    import torch

    from kmer_spans_tpu_torch.ops.gather import (
        class_table_from_mass,
        screen_thr_q,
    )
    from kmer_spans_tpu_torch.ops.histogram import count_aug, count_aug_plain
    from kmer_spans_tpu_torch.ops.screen_scan import (
        fused_screen_scan,
        fused_screen_scan_plain,
    )
    from kmer_spans_tpu_torch.parallel.pipeline import _rank_mass
    from kmer_spans_tpu_torch.spans.pipeline import aug_words

    aug, _ = aug_words(nbases_dev, 8, BLOCK)
    flat = aug.reshape(-1)
    counts = count_aug(flat, 8)
    if max_abs_err(counts, count_aug_plain(flat, 8)):
        raise AssertionError("count_aug differs from plain at full size")
    mass = _rank_mass(counts)
    total = counts.sum().to(torch.float32)
    thr_q = screen_thr_q(torch.tensor(THR, dtype=torch.float32, device=dev))
    k2 = {cb: (class_table_from_mass(mass, total, cb), flat, thr_q, cb, BLOCK)
          for cb in (4, 2)}
    for args in k2.values():
        if max_abs_err(fused_screen_scan(*args),
                       fused_screen_scan_plain(*args)):
            raise AssertionError("fused_screen_scan differs from plain at "
                                 "full size")
    out = {}
    # the JSON line reports the main path's 4-bit classes; 2-bit classes
    # (bench.py's choice at thr >= 0.7) are logged beside them
    for name, label, kern, plain in (
            ("count_aug", "count_aug", lambda: count_aug(flat, 8),
             lambda: count_aug_plain(flat, 8)),
            ("fused_screen_scan", "fused_screen_scan (4-bit)",
             lambda: fused_screen_scan(*k2[4]),
             lambda: fused_screen_scan_plain(*k2[4])),
            (None, "fused_screen_scan (2-bit)",
             lambda: fused_screen_scan(*k2[2]),
             lambda: fused_screen_scan_plain(*k2[2]))):
        # in turns on one card: plain, kernel, kernel, plain
        p1 = time_ms(plain, 3)
        t1 = time_ms(kern, 5)
        t2 = time_ms(kern, 5)
        p2 = time_ms(plain, 3)
        if name:
            out[name] = {"ms": (t1 + t2) / 2, "plain_ms": (p1 + p2) / 2}
        log(f"  {label} at {flat.numel():,} positions: kernel "
            f"{t1:.4f}/{t2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms")
    return out


def golden_phase(dev) -> None:
    """Phase 4: the golden genome through the port's api."""
    from kmer_spans_tpu_torch import api
    from kmer_spans_tpu_torch.oracle import (
        count_spectrum,
        find_regions,
        golden_genome,
        weighted_ranks,
    )

    seq = golden_genome()
    res = api.kmer_low_comp_regions(seq, k=8, min_w=MIN_W, min_score=MIN_S,
                                    thr=THR, mode="fast", device=dev)
    counts, n = count_spectrum(seq, 8)
    want = find_regions(seq, 0, MIN_W, MIN_S,
                        weighted_ranks(counts, float(n)), 8, THR)
    got = [(int(r["beg"]), int(r["end"]), float(r["score"]))
           for r in res.regions]
    if got != [(b, e, s) for _, b, e, s in want] or len(got) != 3:
        raise AssertionError(f"golden regions {got} != oracle {want}")
    if [b for b, _, _ in got] != [20008, 50008, 80007]:
        raise AssertionError(f"golden regions moved: {got}")
    if api.exact_fallbacks:
        raise AssertionError("the api overflowed its candidate capacity")
    log(f"  golden: {got} == oracle chain")


@contextlib.contextmanager
def plain_versions(on: bool):
    """While on, the pipeline's K1 and K2 calls run their plain PyTorch
    versions on the card (the reference run of phase 5)."""
    from kmer_spans_tpu_torch.ops import histogram, screen_scan

    saved = histogram.count_aug, screen_scan.fused_screen_scan
    if on:
        histogram.count_aug = histogram.count_aug_plain
        screen_scan.fused_screen_scan = screen_scan.fused_screen_scan_plain
    try:
        yield
    finally:
        histogram.count_aug, screen_scan.fused_screen_scan = saved


def full_size_phase(dev, nbases: np.ndarray, card: str):
    """Phase 5: the main path at full size.

    Returns the kernels' launch counts in that run and the genome on the
    card.
    """
    import torch

    from kmer_spans_tpu_torch.ops import histogram, screen_scan
    from kmer_spans_tpu_torch.ops.convert import to_tensor
    from kmer_spans_tpu_torch.spans.finish import finish_spans, \
        unpack_outputs
    from kmer_spans_tpu_torch.spans.pipeline import make_span_pipeline

    n = nbases.shape[0]
    cand = min(n // BLOCK, max(256, 5 * (n // 2_500_000)))
    nbases_dev = to_tensor(nbases, dev)
    torch.cuda.synchronize()

    def run(plain: bool):
        fn = make_span_pipeline(8, block=BLOCK, cand_blocks=cand, packed=True,
                                device=dev)
        with plain_versions(plain):
            t0 = time.perf_counter()
            vec = fn(nbases_dev, THR)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        host = vec.cpu().numpy()
        t2 = time.perf_counter()
        out = unpack_outputs(host, 8, n, BLOCK, cand,
                             packed_bases=fn.packed_bases, lazy_codes=True)
        res = finish_spans(out, n, THR, MIN_W, MIN_S, block=BLOCK)
        t3 = time.perf_counter()
        return vec, res, (t1 - t0, t2 - t1, t3 - t2)

    histogram.launches = 0
    screen_scan.launches = 0
    vec, res, first = run(plain=False)
    launches = {"count_aug": histogram.launches,
                "fused_screen_scan": screen_scan.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    _, _, steady = run(plain=False)
    vec_p, res_p, plain_t = run(plain=True)
    if res.fallback or res_p.fallback:
        raise AssertionError("candidate capacity overflow (fallback)")
    if not torch.equal(vec, vec_p):
        raise AssertionError("packed vector differs from the plain run")
    if res.regions != res_p.regions:
        raise AssertionError("regions differ from the plain run")
    islands = range(1_000_000, n - 5000, 5_000_000)
    hit = [any(b <= s + 3000 and e >= s for _, b, e, _ in res.regions)
           for s in islands]
    if not all(hit) or not all(np.isfinite(r[3]) for r in res.regions):
        raise AssertionError(f"islands without a region: "
                             f"{[s for s, h in zip(islands, hit) if not h]}")
    log(f"  n={n:,} block={BLOCK} cand={cand}: {len(res.regions)} regions, "
        f"all {len(hit)} planted islands called, equal to the plain run")
    for name, t in (("kernels, first call", first),
                    ("kernels, second call", steady),
                    ("plain versions", plain_t)):
        log(f"  {name}: device step {t[0] * 1e3:.1f} ms, pull "
            f"{t[1] * 1e3:.1f} ms, host finish {t[2] * 1e3:.1f} ms "
            f"[{card}]")
    return launches, nbases_dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bases", type=int, default=1 << 28)
    args = ap.parse_args(argv)
    if args.bases % BLOCK:
        ap.error(f"--bases must be a multiple of {BLOCK}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    log("phase 1: device")
    card = card_line()
    log(card)

    log("phase 2: build")
    from kmer_spans_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, diag = _build.compile_library()
    _build.library()
    log(f"  built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in diag.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())

    log("phase 3: kernels against their plain versions")
    err = check_kernels(dev, args.seed)
    nbases = make_genome(args.bases, args.seed)

    log("phase 4: golden genome through the api")
    golden_phase(dev)

    log("phase 5: full-size main path")
    launches, nbases_dev = full_size_phase(dev, nbases, card)

    log("phase 6: kernel and plain times at the main path's shapes "
        f"[{card}]")
    times = time_kernels(dev, nbases_dev)

    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    sources = {
        "count_aug": ("kmer_spans_tpu_torch/csrc/count_aug.cu",
                      "kmer_spans_tpu/ops/pallas_kernels.py:145"),
        "fused_screen_scan": ("kmer_spans_tpu_torch/csrc/screen_scan.cu",
                              "kmer_spans_tpu/ops/screen_scan.py:114"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
