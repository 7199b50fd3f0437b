#!/usr/bin/env python3
"""Drive the PyTorch port (kmer_spans_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--bases N]

(``--mesh-rank DIR`` is phase 14's own: one of its two ranks.)

Run from the repository root.  Phases, each of which raises on failure:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds the CUDA kernels from kmer_spans_tpu_torch/csrc/
     (one nvcc per source, in parallel), and the C++ compiler the host
     library (csrc/host/), which must load;
  3. each kernel against its plain PyTorch version on the card, exact, on
     seeded inputs (random aug words with invalid positions, a stretch of
     2^17 identical codes; for the fused screen blocks of 256 to 32768
     with 2- and 4-bit classes, a block with no scored position, grids
     with fewer blocks than CTAs, tables of 32 to 2^14 words; for the
     value histogram sizes 1 to 2^24 (4^12) in all five of its forms
     (sliced, cluster, global, partitioned, cluster_merged), 2^17
     identical values, all invalid, offset views of values and valid
     whose alignments agree and differ, and at 65536, 4^9 and 4^12 bins
     every value in one bin, all in one part of 2^15 bins, values on part
     boundaries, half of them negative or >= size; 4^13 and 4^15 bins in
     the partitioned and global forms; the partitioned form's chunked
     walk under a 4 MiB scratch cap; for the window counts kernel k = 1
     to 15, 1 to 40 tracked rows with repeats, windows 2k to 70,000, N
     runs, the padded tail, unaligned starts and the cohort's seg, with
     counts and without; for the class gather tables of 2 to 2^15
     words, random entries, 2^17 identical entries, entries all in the
     last word, a length that is not a multiple of 4, an unaligned view,
     and the table sizes it must refuse);
  4. the golden genome through api.kmer_low_comp_regions(mode="fast") on
     the card at k = 8 (exactly the 3 planted regions), 9, 3 and 12, and
     through its default mode="exact" at k = 8 (the same 3 regions), equal
     (==) to the sequential oracle's rank chain, with no rerun; and
     api.kmer_spans at k = 8 with threshold and log2_median scoring, equal
     to the oracle with the same weights;
  5. the full-size k = 8 path: N bases (default 2^28) from --seed, repeat
     islands and N gaps planted, through make_span_pipeline(packed=True)
     -> unpack_outputs -> finish_spans; kernel launch counts read around
     this run; the packed vector and regions must equal the same run with
     the plain versions on the card;
  6. each kernel, its plain version and, where one exists, the one
     PyTorch call that computes the same function (torch.bincount on the
     input already masked) timed in turns (CUDA events) at the main
     paths' shapes, beside the least time the card could take (bytes
     moved over 3.35 TB/s): the aug words of that genome (N positions,
     block 8192, k = 8; K2 with 4- and 2-bit classes), the value
     histogram at the k = 9 count (4^9 bins, every form), the k = 13 pm
     screen's run lengths (256 bins), the k = 12 sort screen's two run
     histograms (65536 bins each, every form), and the exact path's 4^8,
     4^10 and 4^12 spectra and k = 8 scan histogram (every form) and its
     4^14 and 4^15 spectra (the global and partitioned forms; at 4^9
     and 4^12 the partitioned form's passes each, from torch.profiler), the
     window path's count histograms (16 dimers, window 200: 3328 bins,
     and 154 scaffolds' 154 * 3232 bins, every form, beside the mask they
     need), the window counts kernel at 2^22 starts and 16 dimers, with
     counts and without, beside its plain chain (window_group and
     dist_values), and the class gather's k = 9 codes (32768 words) and
     k = 12 sort-screen entries (16384 words);
  7. the full-size k >= 10 path on the same genome, for k = 12 (packed
     key), 13 and 15 (strategy from the length): make_pm_span_pipeline ->
     unpack_pm_outputs -> finish_pm_spans, launch counts read around each
     run, the packed vector and regions equal to the same run with the
     plain value histogram, every planted island called;
  8. the full-size non-fused class path (k = 9, make_span_pipeline(9,
     packed=True) -> unpack_outputs -> finish_spans) and sort path
     (k = 12, make_span_pipeline(12, packed=True, packed_counts=False) ->
     host recount -> finish_spans(counts=...)) on the same genome, launch
     counts read around each run, the packed vector and regions equal to
     the same run with the plain value histogram and class gather, every
     planted island called;
  9. the full-size exact api path on the same genome, each call with the
     kernels and again with the plain versions, the two equal:
     api.kmer_counts at k = 8 and 12 (n the number of valid k-mers), the
     default api.kmer_low_comp_regions(mode="exact") at k = 8 and 12
     (every planted island called, regions equal bit for bit) and
     api.kmer_regions at k = 8 with scan counts and a CpG-style table at
     min_score 20 and 0 (the second pulls candidate blocks in batches);
     launch counts read around each kernels' run; each run's wall time,
     count, device step, pull, host finish, batched pulls and peak memory
     logged;
 10. windowed distributions on the same genome, each call with the
     kernels and again with the plain versions, the two equal:
     api.window_kmer_dist with the 16 dimers, window 200, over the whole
     genome and (ret_flag=1, the int64 positions matrix) its first 48 Mb;
     the 154-scaffold cohort (bench.py's lengths) per scaffold
     (api.kmer_counts k = 1 and api.window_kmer_dist) and in one
     windowed_counts_device(seg2d=...) call, equal to the per-scaffold
     dists; K3's launches counted, the window counts kernel launched once
     a chunk, staging and chunk device time logged;
 11. api.lr_regions on the same genome at min_length 100, k = 2 and 8,
     with the kernels and with the plain versions (equal), every planted
     island called, the pull batches counted, the stages (staging,
     summaries, runstats, pulls, host replay) timed, and the first 2^20
     bases equal to the sequential oracle, positions and f64 scores;
 12. the streaming pipeline (parallel/stream.py) on the same genome in
     chunks of 2^25 (block 8192, C = 128): k = 8 (K3, K2), 9 (K3, K4) and
     12 (K3, the row gather) with rank scoring and k = 8 with threshold
     scoring (the affine row gather), each with the kernels and with the
     plain versions (spectra, per-chunk summaries, regions equal), K3
     launched once a chunk in the count pass and K2 or K4 once a chunk in
     the scan, every island called, nothing unresolved, the k = 8 and 12
     regions equal to phase 9's exact ones; a stop after chunk 3 and a
     resume from its checkpoint, equal to the whole run; k = 12 over a
     2^30-base genome (32 chunks) with its peak device memory and each
     chunk's stage times (CUDA events); and the CLI's stream and spans
     on the golden genome with --device cuda, equal to --device cpu.
     Phase 6 times K2, K3 and K4 at the stream's chunk shapes too;
 13. wide codes on the same genome: make_wide_pm_pipeline at k = 17 and
     23 (K3 once a call) and the sort route at k = 17
     (make_wide_span_pipeline: K3 twice, K4; device_sparse_spectrum;
     finish_wide_spans), each with the kernels and with the plain
     versions (vectors and regions equal), launches counted, every
     island called, the sort route's regions equal to the pm route's;
     t_list, the listed runs, the code build (CUDA events), device step,
     pull, host finish and peak memory logged; api.kmer_wide_regions at
     k = 17 over the genome (n_words the valid k-mers, regions equal to
     the pipeline's), over its first 2^20 bases and over the golden
     genome (both equal to the oracle with a SparseRanks lookup); and the
     CLI's wide with --device cuda, equal to --device cpu.  Phase 6 times
     K3 at the wide shapes (the k = 17 pm run lengths, 256 bins with one
     hot bin; the wide sort screen's two run histograms) and K4 at the
     wide sort entries;
 14. the multi-device paths (parallel/) in a process group of this
     process alone under NCCL (a file store in a temporary directory):
     make_pipeline_step at k = 8 on the genome (counts equal to
     api.kmer_counts, scored equal to the single-device mask, S within
     2e-4 of an f64 doubling scan of the same s), the k = 13 sharded scan
     and the wide k = 17 sharded scan (regions equal to phases 7's and
     13's, every island called), each device step with the kernels and
     with the plain versions (outputs equal), launches counted, walls and
     peak memory logged; dryrun_multichip; then the genome's first 2^24
     bases through distributed_low_comp_regions (k = 13) and
     wide_low_comp_regions (k = 17) here and in two gloo ranks sharing the
     card (this script with --mesh-rank), both ranks' regions equal to
     each other and to this process's.  Phase 6 times K3 at the shard
     count's 4^13 bins and the wide sharded scan's two run histograms, and
     K4 at its table, on the inputs those steps pass;
 15. the api's CPU backends beside the card, with the host CPU's model
     (/proc/cpuinfo or lscpu): backend="native" (the host C++ library) over the
     whole genome, kmer_counts and kmer_low_comp_regions at k = 8 and 12
     and kmer_regions at k = 8 with phase 9's CpG-style table, each equal
     to phase 9's result on the card (counts, scan counts, regions with
     f64 ==), each wall beside the card's; backend="host" (the
     sequential oracle) at k = 8 on the golden genome and the genome's
     first 2^22 bases, and kmer_wide_regions(backend="native") at k = 17
     on that head, each equal to the card's run on the same input; and
     the dense span scan (ops/scan.py span_scan) on the card over the
     k = 8 exact step's 2^28 f32 scores, equal to span_scan_blocked and,
     on the first 2^20 positions, to a sequential f64 loop within
     rtol = atol = 2e-4.  It adds nothing to the kernels' launches;
 16. the host span replay (spans/extract.py) on tied decimal tables: the
     genome's first 2^22 bases through api.kmer_regions at k = 2 and 8,
     min_width 20, min_score 2.0, tables drawn from --seed in steps of
     0.1 from -0.55 to 0.45, with the kernels and with the plain versions
     (equal), each equal to backend="native" (n, scan counts, regions
     with f64 ==); region counts, host finish and walls logged.

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
#: NVIDIA's published H100 SXM peaks: HBM3 bytes/s and non-tensor 32-bit
#: operations/s; a bound is the larger of bytes and operations over them
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


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


def edge_values(rng, case: str, size: int, n: int):
    """K3 inputs at the partitioned form's edges: every value in one bin;
    all in one part (2^15 bins), spread over it; on part boundaries
    (2^15 j - 1, 2^15 j); half of them negative or >= size."""
    from kmer_spans_tpu_torch.ops.histogram import SLICE_BINS

    parts = -(-size // SLICE_BINS)
    valid = rng.random(n) < 0.9
    if case == "one bin":
        values = np.full(n, size // 3)
        valid[:] = True
    elif case == "one part":
        lo = parts // 2 * SLICE_BINS
        values = rng.integers(lo, min(size, lo + SLICE_BINS), n)
    elif case == "part edges":
        j = np.arange(parts + 1) * SLICE_BINS
        values = rng.choice(np.clip(np.concatenate([j - 1, j]), 0, size - 1),
                            n)
    else:  # "out of range"
        values = rng.integers(0, size, n)
        out = rng.random(n) < 0.5
        values[out] = rng.choice([-1, -(2 ** 31), size, 2 ** 31 - 1],
                                 int(out.sum()))
    return values.astype(np.int32), valid


def check_histogram_edges(dev, rng) -> None:
    """Phase 3, K3's edges against plain, exact: the edge_values cases at
    65536, 4^9 and 4^12 bins in every form; 4^13 and 4^15 bins in the
    partitioned and global forms; and the partitioned form's chunked walk
    (a scratch cap of 4 MiB: 2^22 positions in several chunks, offset
    views aligned alike and unlike)."""
    import torch

    from kmer_spans_tpu_torch.ops import histogram as hist
    from kmer_spans_tpu_torch.ops.convert import to_tensor

    n = (1 << 22) + 5

    def same(x, m, size, forms, what):
        want = hist.histogram_plain(x, m, size)
        for form in forms:
            e = max_abs_err(hist.histogram_kernel(x, m, size, form), want)
            torch.cuda.synchronize()
            if e:
                raise AssertionError(f"histogram {what}, size={size}, "
                                     f"form={form}: max |err| {e}")

    for size in (1 << 16, 1 << 18, 1 << 24):
        for case in ("one bin", "one part", "part edges", "out of range"):
            x, m = (to_tensor(a, dev) for a in edge_values(rng, case, size,
                                                           n))
            same(x, m, size, hist.FORMS, case)
        log(f"  histogram size={size}: equal to plain in every form with "
            "one bin, one part, part edges, out of range")
    for size in (1 << 26, 1 << 30):
        values = rng.integers(-3, size + 40, n).astype(np.int32)
        x, m = to_tensor(values, dev), to_tensor(rng.random(n) < 0.8, dev)
        same(x, m, size, ("partitioned", "global"), "random")
    log("  histogram sizes 4^13 and 4^15: equal to plain in the partitioned "
        "and global forms")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cap = hist.PARTITION_SCRATCH_CAP
    hist.PARTITION_SCRATCH_CAP = 4 << 20
    try:
        for size in (1 << 18, 1 << 24):
            values = rng.integers(-3, size + 40, n).astype(np.int32)
            values[9000:9000 + (1 << 17)] = size - 1
            x = to_tensor(values, dev)
            m = to_tensor(rng.random(n) < 0.8, dev)
            chunks = -(-n // hist.partition_plan(n, size, sms).chunk)
            for args in ((x, m), (x[1:], m[1:]), (x[3:], m[:-3])):
                same(*args, size, ("partitioned",), f"in {chunks} chunks")
    finally:
        hist.PARTITION_SCRATCH_CAP = cap
    log(f"  histogram partitioned form under a 4 MiB scratch cap: equal to "
        f"plain in {chunks} chunks, offset views aligned alike and unlike")


def window_values_err(args: tuple, want_counts: bool) -> int:
    """max |err| of window_values against its plain version on the same
    CUDA tensors: values, valid, wv and cnt; the sizes equal."""
    import torch

    from kmer_spans_tpu_torch.ops.window import (
        window_values,
        window_values_plain,
    )

    got = window_values(*args, want_counts=want_counts)
    want = window_values_plain(*args, want_counts=want_counts)
    torch.cuda.synchronize()
    if got[2] != want[2]:
        raise AssertionError(f"window_values size {got[2]} != {want[2]}")
    keep = (0, 1, 3, 4) if want_counts else (0, 1, 3)
    return max_abs_err(tuple(got[i] for i in keep),
                       tuple(want[i] for i in keep))


def check_window_counts(dev, rng) -> int:
    """Phase 3, the window counts kernel against its plain version: k 1 to
    15, 1 to 40 tracked rows (repeats among them), windows from 2k to
    70,000 (its run sizes), N runs, the padded tail, unaligned lo and m
    not a multiple of 4, the cohort's seg; with counts and without."""
    import torch

    from kmer_spans_tpu_torch.ops.blocked import blocked_codes
    from kmer_spans_tpu_torch.ops.convert import to_tensor

    n = 48 * BLOCK
    arr = rng.integers(0, 4, n).astype(np.uint8)
    arr[rng.random(n) < 0.0005] = 4
    arr[9000:9300] = 4
    arr[50_000:53_000] = np.tile(np.array([0, 3], np.uint8), 1500)
    x = to_tensor(arr, dev)
    b2, v2 = (x & 3).reshape(-1, BLOCK), (x < 4).reshape(-1, BLOCK)
    seg = to_tensor(np.sort(rng.integers(0, 154, n)).astype(np.int32), dev)
    err, cases = 0, 0
    for k, windows in ((1, (2, 200)), (2, (4, 200, 1025, 4097, 16385,
                                          70_000)),
                       (5, (10, 201)), (12, (24, 200)), (15, (30, 113))):
        codes, kv = blocked_codes(b2, v2, k)
        c, kv = codes.reshape(-1), kv.reshape(-1)
        present = c[kv].cpu().numpy()
        for T in (1, 3, 16, 40):
            tr = rng.choice(present, T).astype(np.int32)
            tr[T - T // 4:] = tr[:T // 4]
            tracked = to_tensor(tr, dev)
            for w in windows:
                for lo, hi, sg in ((0, 40 * BLOCK, None), (3, n - 5, None),
                                   (0, n, seg)):
                    for want_counts in (False, True):
                        err = max(err, window_values_err(
                            (c, kv, v2.reshape(-1), tracked, k, w, lo, hi,
                             sg, None if sg is None else 154), want_counts))
                        cases += 1
    if err:
        raise AssertionError(f"window_values: max |err| {err}")
    log(f"  window_values: equal to plain in {cases} cases (k 1 to 15, 1 to "
        "40 tracked rows with repeats, windows 2k to 70,000, N runs, the "
        "padded tail, unaligned starts, seg)")
    return err


def check_kernels(dev, seed: int) -> dict:
    """Phase 3: every kernel against its plain version, exact."""
    import torch

    from kmer_spans_tpu_torch.ops.convert import to_tensor
    from kmer_spans_tpu_torch.ops.gather import word_gather, word_gather_plain
    from kmer_spans_tpu_torch.ops.histogram import (
        FORMS,
        SLICE_BINS,
        count_aug,
        count_aug_plain,
        histogram,
        histogram_kernel,
        histogram_plain,
    )
    from kmer_spans_tpu_torch.ops.screen_scan import (
        fused_screen_scan,
        fused_screen_scan_plain,
    )

    rng = np.random.default_rng(seed)
    err = {"count_aug": 0, "fused_screen_scan": 0, "histogram": 0,
           "word_gather": 0, "window_counts": check_window_counts(dev, rng)}
    thr_q = torch.tensor(3071, dtype=torch.int32, device=dev)
    for nw in (2, 8, 8192, 16384, 32768):
        words = to_tensor(rng.integers(-(2 ** 31), 2 ** 31, nw,
                                       dtype=np.int64).astype(np.int32), dev)
        n = (1 << 22) + 5  # not a multiple of 4
        entry = rng.integers(0, 8 * nw, n).astype(np.int32)
        entry[7000:7000 + (1 << 17)] = 8 * nw - 3  # 2^17 identical
        last = rng.integers(8 * nw - 8, 8 * nw, n).astype(np.int32)
        for e_np in (entry, last):  # random; all in the last word
            x = to_tensor(e_np, dev)
            for view in (x, x[1:]):  # 16-byte aligned and unaligned starts
                e = max_abs_err(word_gather(words, view, thr_q),
                                word_gather_plain(words, view, thr_q))
                torch.cuda.synchronize()
                if e:
                    raise AssertionError(f"word_gather W={nw}: max |err| {e}")
        log(f"  word_gather W={nw}: equal to plain (n={n:,}, 2^17 identical "
            "entries, all in the last word, unaligned view)")
    for nw in (1 << 16, 24):
        try:
            word_gather(torch.zeros(nw, dtype=torch.int32, device=dev), x,
                        thr_q)
        except ValueError:
            continue
        raise AssertionError(f"word_gather took a table of {nw} words")
    log("  word_gather refuses tables of 2^16 and 24 words")
    for size in (1, 100, 1 << 15, (1 << 15) + 1, 65536, 1 << 18,
                 (1 << 18) + 1, 1 << 20, 1 << 24):
        n = (1 << 22) + 5
        values = rng.integers(-3, size + 40, n).astype(np.int32)
        valid = rng.random(n) < 0.8
        values[7000:7000 + (1 << 17)] = min(2, size - 1)  # 2^17 identical
        valid[7000:7000 + (1 << 17)] = True
        x, m = to_tensor(values, dev), to_tensor(valid, dev)
        cases = (
            (x, m),                      # aligned
            (x[1:], m[1:]),              # offset views that line up
            (x[1:-1], m[2:]),            # offset views that do not
            (x[3:], m[:-3]),
            (x, torch.zeros_like(m)),    # all invalid
        )
        forms = FORMS if size > SLICE_BINS else ("sliced", "global",
                                                 "partitioned")
        for form in forms:
            for args in cases:
                e = max_abs_err(histogram_kernel(*args, size, form),
                                histogram_plain(*args, size))
                torch.cuda.synchronize()
                if e:
                    raise AssertionError(
                        f"histogram size={size} form={form}: "
                        f"max |err| {e}")
        if histogram(x, torch.zeros_like(m), size).any():
            raise AssertionError("histogram counted an invalid value")
        e = max_abs_err(histogram(x, m, size), histogram_plain(x, m, size))
        if e:
            raise AssertionError(f"histogram size={size}: max |err| {e}")
        log(f"  histogram size={size}: equal to plain in the "
            f"{', '.join(forms)} forms (n={n:,}, 2^17 identical values, "
            "offset views aligned alike and unlike, all invalid)")
    check_histogram_edges(dev, rng)
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
    for cb in (2, 4):
        for k, nw in ((4, None), (8, None), (8, 1 << 14)):
            nw = nw or (1 << (2 * k)) // (32 // cb)  # 2^13 words at k=8
            words = to_tensor(rng.integers(-(2 ** 31), 2 ** 31, nw,
                                           dtype=np.int64).astype(np.int32),
                              dev)
            for block in (256, 768, 1024, 3072, 8192, 16384, 32768):
                # many blocks a CTA; and fewer blocks than CTAs
                for nblocks in (max(3, (1 << 20) // block), 3):
                    aug = aug_case(rng, nblocks * block, k)
                    aug[block:2 * block] &= ~(1 << 17)  # no scored position
                    aug[2 * block:3 * block] = (1 << 17) | (1 << 16) | 5
                    args = (words, to_tensor(aug, dev), thr_q, cb, block)
                    got = fused_screen_scan(*args)
                    want = fused_screen_scan_plain(*args)
                    torch.cuda.synchronize()
                    e = max_abs_err(got, want)
                    if e:
                        raise AssertionError(
                            f"fused_screen_scan k={k} class_bits={cb} "
                            f"words={nw} block={block} nblocks={nblocks}: "
                            f"max |err| {e}")
                    if got[1][1].item() > -(1 << 29):
                        raise AssertionError("no-scored sentinel lost")
            log(f"  fused_screen_scan class_bits={cb} k={k} table={nw} "
                "words: equal to plain (blocks 256 to 32768, a block with "
                "no scored position, fewer blocks than CTAs)")
    try:
        x = to_tensor(aug_case(rng, 4 * 1024 + 1, 8), dev)
        fused_screen_scan(words, x[1:], thr_q, 4, 1024)
    except ValueError:
        log("  fused_screen_scan refuses aug off a 16-byte boundary")
    else:
        raise AssertionError("fused_screen_scan took a misaligned aug")
    return err


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes)}


def in_turns(label: str, kern, plain, library=None, extra=()) -> dict:
    """Time plain, library, kernel(s) in turns on one card: plain, library,
    kernel, extra..., extra..., kernel, library, plain.  Returns mean ms."""
    p1 = time_ms(plain, 3)
    l1 = time_ms(library, 5) if library else None
    t1 = time_ms(kern, 5)
    x1 = [time_ms(f, 5) for _, f in extra]
    x2 = [time_ms(f, 5) for _, f in reversed(extra)][::-1]
    t2 = time_ms(kern, 5)
    l2 = time_ms(library, 5) if library else None
    p2 = time_ms(plain, 3)
    out = {"ms": (t1 + t2) / 2, "plain_ms": (p1 + p2) / 2,
           "library_ms": (l1 + l2) / 2 if library else None}
    for (name, _), a, b in zip(extra, x1, x2):
        out[name] = (a + b) / 2
    more = "".join(f", {name[:-3]} {a:.4f}/{b:.4f} ms"
                   for (name, _), a, b in zip(extra, x1, x2))
    lib = f", library {l1:.4f}/{l2:.4f} ms" if library else ""
    log(f"  {label}: kernel {t1:.4f}/{t2:.4f} ms{more}, plain "
        f"{p1:.4f}/{p2:.4f} ms{lib}")
    return out


def shape_entry(shape: str, timing: dict, bnd: dict) -> dict:
    entry = {"shape": shape, **timing, **bnd}
    log(f"    bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
        f"{bnd['bytes']:,} bytes)")
    return entry


def main_entry(shapes: list) -> dict:
    """A kernel's JSON numbers: those of its first (main-path) shape, with
    every shape beside them."""
    return {**{k: v for k, v in shapes[0].items() if k not in ("shape",
                                                               "err")},
            "shapes": shapes}


def time_kernels(dev, nbases_dev) -> dict:
    """Phase 6, K1 and K2 on the k = 8 path's aug words."""
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
    n = flat.numel()
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
    # the library yardstick of K1: one bincount of the codes already masked
    code = flat & 0xFFFF
    premasked = code[(((flat >> 16) & 1) == 1) & (code < (1 << 16))]
    del code
    k1 = in_turns(f"count_aug (k = 8, {n:,} positions)",
                  lambda: count_aug(flat, 8), lambda: count_aug_plain(flat, 8),
                  lambda: torch.bincount(premasked, minlength=1 << 16))
    del premasked
    out = {"count_aug": main_entry([shape_entry(
        "k = 8 aug words, 4^8 bins", k1, bound(n * 4 + (1 << 16) * 4, n))])}
    shapes = []
    for cb in (4, 2):
        t = in_turns(f"fused_screen_scan ({cb}-bit classes, {n:,} "
                     "positions)", lambda: fused_screen_scan(*k2[cb]),
                     lambda: fused_screen_scan_plain(*k2[cb]))
        words = k2[cb][0].numel()
        shapes.append(shape_entry(
            f"k = 8 aug words, {cb}-bit classes, block {BLOCK}", t,
            bound(n * 4 + words * 4 + 4 * (n // BLOCK) * 4, n)))
    # the JSON line's numbers are the main path's 4-bit classes
    out["fused_screen_scan"] = main_entry(shapes)
    return out


def hist_entry(label: str, values, valid, size: int, more=(),
               kind: str = "dense", forms=None) -> dict:
    """Phase 6, K3 at one shape: the wrapper (with its form rule for input
    of this ``kind``), each form (above 2^15 bins, or all of them with
    ``more``; or ``forms``), the plain version and bincount on the input
    already masked, in turns, with ``more`` (name, fn) timed beside them;
    the bound; max |err| against plain."""
    import torch

    from kmer_spans_tpu_torch.ops import histogram as hist

    want = hist.histogram_plain(values, valid, size)
    err = max_abs_err(hist.histogram(values, valid, size, kind), want)
    extra = ()
    if forms is None and (size > hist.SLICE_BINS or more):
        forms = hist.FORMS
    if forms:
        extra = tuple(
            (f"{form}_ms", lambda form=form: hist.histogram_kernel(
                values, valid, size, form))
            for form in forms)
        for _, f in extra:
            err = max(err, max_abs_err(f(), want))
    extra += tuple(more)
    if err:
        raise AssertionError(f"histogram differs from plain at {label}: "
                             f"max |err| {err}")
    premasked = values[valid & (values >= 0) & (values < size)]
    n = values.numel()
    t = in_turns(f"histogram ({label}, {int(valid.sum()):,} of {n:,} "
                 f"valid, {size} bins; form "
                 f"{hist.histogram_form(size, kind, values.numel())})",
                 lambda: hist.histogram(values, valid, size, kind),
                 lambda: hist.histogram_plain(values, valid, size),
                 lambda: torch.bincount(premasked, minlength=size), extra)
    return {**shape_entry(f"{label}, {size} bins", t,
                          bound(n * 5 + size * 4, n)), "err": err}


def partitioned_passes(label: str, values, valid, size: int) -> None:
    """Phase 6: the device time of each CUDA kernel of K3's partitioned
    form (pass A, the scan, pass B, pass C) over three calls, from
    torch.profiler; "not measured" where the profiler sees no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kmer_spans_tpu_torch.ops import histogram as hist

    def call():
        return hist.histogram_kernel(values, valid, size, "partitioned")

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            call()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = (getattr(e, "device_time_total", 0)
             or getattr(e, "cuda_time_total", 0))
        for name in ("part_count", "part_scan", "part_scatter",
                     "part_items"):
            if name in e.key and t:
                rows.append(f"{name} {t / e.count / 1e3:.4f}")
    log(f"  partitioned passes ({label}, {size} bins), ms a call: "
        + (", ".join(rows) if rows else "not measured"))


def time_histogram(dev, nbases_dev) -> dict:
    """Phase 6, K3: the k = 13 pm screen's value histogram, on that
    screen's own inputs."""
    import torch

    from kmer_spans_tpu_torch.ops.blocked import blocked_codes
    from kmer_spans_tpu_torch.ops.pmscreen import pm_params, sorted_runs

    k = 13
    n = nbases_dev.shape[0]
    nb = n // BLOCK
    codes, kv = blocked_codes((nbases_dev & 3).reshape(nb, BLOCK),
                              (nbases_dev < 4).reshape(nb, BLOCK), k)
    _, _, head, v, real = sorted_runs(codes.reshape(-1), kv.reshape(-1), k)
    del codes, kv
    nbins = pm_params(k, None, n=n)[3]
    vals, valid = torch.clamp(v, max=nbins - 1), head & real
    del head, v, real
    return hist_entry("k = 13 pm run lengths", vals, valid, nbins,
                      kind="runs")


def time_word_gather(dev, nbases_dev) -> tuple[dict, list]:
    """Phase 6, K4 at the k = 9 class screen's codes (32768 words) and the
    k = 12 sort screen's entries (16384 words), each on its path's own
    table; and K3 at those paths' shapes (the k = 9 count, the sort
    screen's two run histograms)."""
    import torch

    from kmer_spans_tpu_torch.ops import gather, sortscreen
    from kmer_spans_tpu_torch.ops.blocked import blocked_codes
    from kmer_spans_tpu_torch.ops.histogram import count_spectrum
    from kmer_spans_tpu_torch.ops.pmscreen import sorted_runs
    from kmer_spans_tpu_torch.parallel.pipeline import _rank_mass

    n = nbases_dev.shape[0]
    nb = n // BLOCK
    b2, v2 = (nbases_dev & 3).reshape(nb, BLOCK), \
        (nbases_dev < 4).reshape(nb, BLOCK)
    thr_q = gather.screen_thr_q(
        torch.tensor(THR, dtype=torch.float32, device=dev))
    shapes, k3 = [], []
    for k in (9, 12):
        codes, kv = blocked_codes(b2, v2, k)
        codes, kv = codes.reshape(-1), kv.reshape(-1)
        if k == 9:
            k3.append(hist_entry("k = 9 codes", codes, kv, 1 << 18))
            partitioned_passes("k = 9 codes", codes, kv, 1 << 18)
            counts = count_spectrum(codes, kv, k)
            words = gather.class_table_from_mass(
                _rank_mass(counts), counts.sum().to(torch.float32))
            entry = codes
        else:
            skey, _, head, v, real = sorted_runs(codes, kv, k)
            hb = (skey >> (2 * k - 8)) & 255
            vmax, v2_ = sortscreen.VMAX, sortscreen.V2
            mask = head & real
            k3.append(hist_entry("k = 12 sort screen, runs by value",
                                 torch.clamp(v, max=vmax - 1), mask, vmax,
                                 kind="runs"))
            k3.append(hist_entry("k = 12 sort screen, runs by value and "
                                 "high byte",
                                 torch.clamp(v, max=v2_ - 1) * 256 + hb,
                                 mask & (v < v2_), v2_ * 256, kind="runs"))
            words = sortscreen.rank_ub_tables(
                *sortscreen.rank_ub_histograms(v, hb, mask, vmax, v2_),
                kv.sum(dtype=torch.int32), vmax, v2_)
            entry = sortscreen.rank_ub_entries(v, hb, vmax, v2_)
            del skey, head, v, real, hb, mask
        del codes, kv
        err = max_abs_err(gather.word_gather(words, entry, thr_q),
                          gather.word_gather_plain(words, entry, thr_q))
        if err:
            raise AssertionError(f"word_gather differs from plain at full "
                                 f"size, k={k}: max |err| {err}")
        t = in_turns(
            f"word_gather (k = {k} {'codes' if k == 9 else 'sort entries'}"
            f", {entry.numel():,} entries, {words.numel()} words)",
            lambda: gather.word_gather(words, entry, thr_q),
            lambda: gather.word_gather_plain(words, entry, thr_q))
        m = entry.numel()
        shapes.append(shape_entry(
            f"k = {k} {'codes' if k == 9 else 'sort entries'}, "
            f"{words.numel()} words", t, bound(m * 8 + words.numel() * 4, m)))
        del entry, words
    # the JSON line reports the k = 9 class screen's shape
    return main_entry(shapes), k3


def time_spectra(dev, nbases_dev) -> list:
    """Phase 6, K3 at the exact path's shapes on the genome's codes: the
    4^8 spectrum and the k = 8 scan histogram (the codes at scored
    positions), and the 4^10, 4^12, 4^14 and 4^15 spectra (with the 4^9
    one of time_word_gather, the shapes that set the form rule; at 4^14
    and 4^15 the global and partitioned forms only: the sliced form would
    read the input 2^13 and 2^15 times)."""
    import torch

    from kmer_spans_tpu_torch.ops.blocked import blocked_codes, blocked_scored

    n = nbases_dev.shape[0]
    nb = n // BLOCK
    b2, v2 = (nbases_dev & 3).reshape(nb, BLOCK), \
        (nbases_dev < 4).reshape(nb, BLOCK)
    out = []
    for k in (8, 10, 12, 14, 15):
        codes, kv = blocked_codes(b2, v2, k)
        out.append(hist_entry(f"k = {k} spectrum", codes.reshape(-1),
                              kv.reshape(-1), 1 << (2 * k),
                              forms=("global", "partitioned") if k > 13
                              else None))
        if k == 12:
            partitioned_passes("k = 12 spectrum", codes.reshape(-1),
                               kv.reshape(-1), 1 << 24)
        torch.cuda.empty_cache()
        if k == 8:
            scored = blocked_scored(v2, kv).reshape(-1)
            masked = codes.reshape(-1).masked_fill_(~kv.reshape(-1), 0)
            out.append(hist_entry("k = 8 scan histogram", masked, scored,
                                  1 << 16))
            del scored, masked
        del codes, kv
    return out


def cohort(nbases: np.ndarray, seed: int = 3):
    """The reference's mclapply workload (test.R:553-567): 154 scaffolds
    with bench.py's power-law lengths (multiples of 65536, about
    len(nbases) bases in all), consecutive slices of the genome.

    Returns (scaffolds, cat, seg): the slices, their concatenation with
    single-N separators padded with N to a multiple of BLOCK, and each
    position's scaffold id (int32)."""
    n = nbases.shape[0]
    rng = np.random.default_rng(seed)
    raw = np.sort(rng.pareto(1.2, size=154) + 0.05)[::-1]
    lengths = np.maximum(
        (raw / raw.sum() * n / 65536).astype(np.int64), 1) * 65536
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    if starts[-1] + lengths[-1] > n:
        raise ValueError("the cohort is longer than the genome")
    scaffolds = [nbases[s:s + L] for s, L in zip(starts, lengths)]
    total = int(lengths.sum()) + len(lengths) - 1
    cat = np.full(-(-total // BLOCK) * BLOCK, 4, np.uint8)
    seg = np.full(cat.shape[0], len(lengths) - 1, np.int32)
    pos = 0
    for i, s in enumerate(scaffolds):
        cat[pos:pos + s.shape[0]] = s
        seg[pos:pos + s.shape[0] + 1] = i
        pos += s.shape[0] + 1
    return scaffolds, cat, seg


def cohort_counts_inputs(dev, cat: np.ndarray, seg: np.ndarray):
    """The cohort on the card: codes, k-mer validity and validity of its
    dimers ([nb, BLOCK]), and the scaffold ids."""
    from kmer_spans_tpu_torch.ops.blocked import blocked_codes
    from kmer_spans_tpu_torch.ops.convert import to_tensor

    x = to_tensor(cat, dev)
    b2, v2 = (x & 3).reshape(-1, BLOCK), (x < 4).reshape(-1, BLOCK)
    codes, kv = blocked_codes(b2, v2, 2)
    return codes, kv, v2, to_tensor(seg, dev).reshape(-1, BLOCK)


def time_window_k3(dev, nbases_dev, nbases: np.ndarray) -> tuple:
    """Phase 6, K3 at the window path's shapes: the histogram of the 16
    dimers' counts over the first chunk's 2^22 window starts (window 200,
    3328 bins) and over the 154-scaffold cohort's first group of 2^22
    starts (154 * 3232 bins), each beside the mask it needs (the window
    validity made contiguous over the 16 rows).  Also logs the device
    time of a chunk's other stages at that shape, and times the window
    counts kernel there against its plain chain (window_group and
    dist_values), with and without counts, beside its bound.  Returns (K3's
    entries, the window counts kernel's)."""
    import torch

    from kmer_spans_tpu_torch.ops.blocked import blocked_codes
    from kmer_spans_tpu_torch.ops.window import (
        GROUP,
        dist_values,
        window_group,
        window_values,
        window_values_plain,
    )

    tracked = torch.arange(16, dtype=torch.int32, device=dev)
    x = nbases_dev[:GROUP + BLOCK]
    b2, v2 = (x & 3).reshape(-1, BLOCK), (x < 4).reshape(-1, BLOCK)
    codes, kv = blocked_codes(b2, v2, 2)
    v = (x < 4)
    cnt, wv = window_group(codes.reshape(-1), kv.reshape(-1), v, tracked, 2,
                           200, 0, GROUP)
    group = (codes.reshape(-1), kv.reshape(-1), v, tracked, 2, 200, 0, GROUP)
    stages = {
        "codes": lambda: blocked_codes(b2, v2, 2),
        "counts and validity": lambda: window_group(*group),
        "K3 input with its mask": lambda: dist_values(cnt, wv, 200),
        "the window counts kernel for both": lambda: window_values(*group)}
    log("  window chunk stages (2^22 starts, 16 dimers), ms: " + ", ".join(
        f"{name} {time_ms(fn, 3):.3f}" for name, fn in stages.items()))
    shapes = []
    for want_counts in (False, True):
        err = window_values_err(group, want_counts)
        if err:
            raise AssertionError(f"window_values differs from plain at 2^22 "
                                 f"starts: max |err| {err}")
        label = ("16 dimers, w = 200, 2^22 starts"
                 + (", with counts" if want_counts else ""))
        t = in_turns(f"window_values ({label})",
                     lambda c=want_counts: window_values(*group,
                                                         want_counts=c),
                     lambda c=want_counts: window_values_plain(
                         *group, want_counts=c))
        # a code, a k-mer and a base flag read a position; values and mask
        # written a row a start, the window validity a start, and the
        # counts a row a start with them
        nbytes = (GROUP + 200) * 6 + GROUP * (16 * (9 if want_counts else 5)
                                              + 1)
        shapes.append({**shape_entry(label, t, bound(nbytes, 2 * 16 * GROUP)),
                       "err": err})
    out = []
    values, valid, size = dist_values(cnt, wv, 200)
    out.append(hist_entry(
        "window counts, 16 dimers, w = 200, 2^22 starts", values, valid,
        size, more=(("mask_ms", lambda: wv[None, :].expand(
            16, -1).contiguous()),), kind="repeats"))
    del b2, v2, codes, kv, v, cnt, wv, values, valid
    _, cat, seg = cohort(nbases)
    codes, kv, v2, seg2 = cohort_counts_inputs(
        dev, cat[:GROUP + BLOCK], seg[:GROUP + BLOCK])
    cnt, wv = window_group(codes.reshape(-1), kv.reshape(-1),
                           v2.reshape(-1), tracked, 2, 200, 0, GROUP)
    values, valid, size = dist_values(cnt, wv, 200,
                                      seg2.reshape(-1)[:GROUP], 154)
    out.append(hist_entry(
        "cohort window counts, 154 scaffolds, 16 dimers, w = 200, 2^22 "
        "starts", values, valid, size,
        more=(("mask_ms", lambda: wv[None, :].expand(16, -1).contiguous()),),
        kind="repeats"))
    return out, main_entry(shapes)


def golden_phase(dev, k: int, mode: str = "fast") -> None:
    """Phase 4: the golden genome through the port's api."""
    from kmer_spans_tpu_torch import api
    from kmer_spans_tpu_torch.oracle import (
        count_spectrum,
        find_regions,
        golden_genome,
        weighted_ranks,
    )

    seq = golden_genome()
    api.exact_fallbacks = 0
    res = api.kmer_low_comp_regions(seq, k=k, min_w=MIN_W, min_score=MIN_S,
                                    thr=THR, mode=mode, device=dev)
    counts, n = count_spectrum(seq, k)
    want = find_regions(seq, 0, MIN_W, MIN_S,
                        weighted_ranks(counts, float(n)), k, THR)
    got = [(int(r["beg"]), int(r["end"]), float(r["score"]))
           for r in res.regions]
    if got != [(b, e, s) for _, b, e, s in want] or not got:
        raise AssertionError(f"golden k={k}: regions {got} != oracle {want}")
    if k == 8 and [b for b, _, _ in got] != [20008, 50008, 80007]:
        raise AssertionError(f"golden regions moved: {got}")
    if api.exact_fallbacks:
        raise AssertionError(f"golden k={k}: the api reran the pipeline")
    log(f"  golden k={k} mode={mode}: {got} == oracle chain")


def golden_spans_phase(dev, scoring: str) -> None:
    """Phase 4: kmer_spans at k = 8 on the golden genome, its defaults
    (min_width 100, min_score 20; f_t the weighted median), equal to the
    oracle with the same weights."""
    from kmer_spans_tpu_torch import api
    from kmer_spans_tpu_torch.models.scoring import (
        Log2MedianScoring,
        ThresholdScoring,
    )
    from kmer_spans_tpu_torch.oracle import (
        count_spectrum,
        find_regions,
        golden_genome,
    )
    from kmer_spans_tpu_torch.stats.ranks import spectrum_median_freq

    seq = golden_genome()
    res = api.kmer_spans(seq, 8, scoring=scoring, device=dev)
    counts, _ = count_spectrum(seq, 8)
    model = (ThresholdScoring(counts, spectrum_median_freq(counts))
             if scoring == "threshold" else Log2MedianScoring(counts))
    want = find_regions(seq, 0, 100, 20.0, model.weights, 8, model.threshold)
    got = [(0, int(r["beg"]), int(r["end"]), float(r["score"]))
           for r in res.regions]
    if got != want or not got or not np.array_equal(res.counts, counts):
        raise AssertionError(f"golden kmer_spans {scoring}: {got[:3]} != "
                             f"oracle {want[:3]}")
    log(f"  golden kmer_spans k=8 {scoring}: {len(got)} regions, first "
        f"{got[0][1:]}, == oracle")


@contextlib.contextmanager
def plain_versions(on: bool):
    """While on, the pipelines' kernel calls run their plain PyTorch
    versions on the card (the reference runs of phases 5 and 7)."""
    from kmer_spans_tpu_torch.ops import gather, histogram, screen_scan, window

    saved = (histogram.count_aug, histogram.histogram,
             screen_scan.fused_screen_scan, gather.word_gather,
             window.window_values)
    if on:
        histogram.count_aug = histogram.count_aug_plain
        histogram.histogram = histogram.histogram_plain
        screen_scan.fused_screen_scan = screen_scan.fused_screen_scan_plain
        gather.word_gather = gather.word_gather_plain
        window.window_values = window.window_values_plain
    try:
        yield
    finally:
        (histogram.count_aug, histogram.histogram,
         screen_scan.fused_screen_scan, gather.word_gather,
         window.window_values) = saved


def zero_launch_counts() -> None:
    from kmer_spans_tpu_torch.ops import gather, histogram, screen_scan, window

    histogram.count_aug_launches = 0
    histogram.histogram_launches = 0
    screen_scan.launches = 0
    gather.launches = 0
    window.window_counts_launches = 0


def check_islands(res, n: int) -> int:
    """Every planted island called, no fallback, finite scores."""
    if res.fallback:
        raise AssertionError("candidate capacity overflow (fallback)")
    islands = range(1_000_000, n - 5000, 5_000_000)
    hit = [any(b <= s + 3000 and e >= s for _, b, e, _ in res.regions)
           for s in islands]
    if not all(hit) or not all(np.isfinite(r[3]) for r in res.regions):
        raise AssertionError(f"islands without a region: "
                             f"{[s for s, h in zip(islands, hit) if not h]}")
    return len(hit)


def cand_blocks(n: int) -> int:
    """C, the candidate capacity: bench.py's rule."""
    return min(n // BLOCK, max(256, 5 * (n // 2_500_000)))


def timed_run(fn, nbases_dev, finish, plain: bool):
    """One device step (kernels or plain versions), pull and host finish.

    Returns (packed vector on the card, finished spans, (device s, pull s,
    finish s), peak device bytes of the step).
    """
    import torch

    torch.cuda.reset_peak_memory_stats()
    with plain_versions(plain):
        t0 = time.perf_counter()
        vec = fn(nbases_dev, THR)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    host = vec.cpu().numpy()
    t2 = time.perf_counter()
    res = finish(host)
    t3 = time.perf_counter()
    return vec, res, (t1 - t0, t2 - t1, t3 - t2), \
        torch.cuda.max_memory_allocated()


def compare_runs(name, card, n, runs) -> None:
    """The kernels' runs against the plain run: vector, regions, islands;
    then the times of each run."""
    import torch

    (vec, res, _, _), *_, (vec_p, res_p, _, _) = runs
    hit = check_islands(res, n)
    check_islands(res_p, n)
    if not torch.equal(vec, vec_p):
        raise AssertionError(f"{name}: packed vector differs from the "
                             "plain run")
    if res.regions != res_p.regions:
        raise AssertionError(f"{name}: regions differ from the plain run")
    log(f"  {name}: {len(res.regions)} regions, all {hit} planted islands "
        "called, equal to the plain run")
    for label, (_, _, t, peak) in zip(
            ("kernels, first call", "kernels, second call",
             "plain versions"), runs):
        log(f"  {name}, {label}: device step {t[0] * 1e3:.1f} ms, pull "
            f"{t[1] * 1e3:.1f} ms, host finish {t[2] * 1e3:.1f} ms, peak "
            f"device memory {peak / 2 ** 30:.2f} GiB [{card}]")


def full_size_phase(dev, nbases: np.ndarray, card: str):
    """Phase 5: the k = 8 path at full size.

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
    cand = cand_blocks(n)
    nbases_dev = to_tensor(nbases, dev)
    torch.cuda.synchronize()
    fn = make_span_pipeline(8, block=BLOCK, cand_blocks=cand, packed=True,
                            device=dev)

    def finish(host):
        out = unpack_outputs(host, 8, n, BLOCK, cand,
                             packed_bases=fn.packed_bases, lazy_codes=True)
        return finish_spans(out, n, THR, MIN_W, MIN_S, block=BLOCK)

    zero_launch_counts()
    runs = [timed_run(fn, nbases_dev, finish, plain=False)]
    launches = {"count_aug": histogram.count_aug_launches,
                "fused_screen_scan": screen_scan.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    runs += [timed_run(fn, nbases_dev, finish, plain=p) for p in (False, True)]
    compare_runs(f"k=8 n={n:,} block={BLOCK} cand={cand}", card, n, runs)
    return launches, nbases_dev


def pm_phase(dev, nbases_dev, card: str) -> tuple[int, dict]:
    """Phase 7: the k >= 10 pm path at full size, k = 12 (packed key),
    13 and 15 (strategy from the length).  Returns K3's launches and the
    regions by k (phase 14 holds the sharded scan to k = 13's)."""
    from kmer_spans_tpu_torch.ops import histogram
    from kmer_spans_tpu_torch.spans import pm_finish
    from kmer_spans_tpu_torch.spans.pm_pipeline import make_pm_span_pipeline

    n = nbases_dev.shape[0]
    cand = cand_blocks(n)
    launches, regions = 0, {}
    for k, strategy in ((12, "packed"), (13, None), (15, None)):
        fn, meta = make_pm_span_pipeline(k, block=BLOCK, cand_blocks=cand,
                                         strategy=strategy, device=dev)
        outs = []

        def finish(host):
            out = pm_finish.unpack_pm_outputs(host, n, meta)
            outs.append(out)
            return pm_finish.finish_pm_spans(out, n, meta, THR, MIN_W, MIN_S)

        zero_launch_counts()
        runs = [timed_run(fn, nbases_dev, finish, plain=False)]
        if histogram.histogram_launches < 1:
            raise AssertionError(f"k={k}: the pm path skipped the histogram")
        launches += histogram.histogram_launches
        runs += [timed_run(fn, nbases_dev, finish, plain=p)
                 for p in (False, True)]
        out = outs[0]
        log(f"  k={k}: t_list {out['t_list']}, {out['list_count']} listed "
            f"runs (cap {meta['list_cap']}), {meta['nbins']} value bins, "
            f"total {out['total']:,}")
        compare_runs(f"k={k} n={n:,} block={BLOCK} cand={cand}", card, n,
                     runs)
        regions[k] = runs[0][1].regions
    return launches, regions


def class_sort_phase(dev, nbases: np.ndarray, nbases_dev, card: str):
    """Phase 8: the non-fused class path (k = 9) and the sort path (k = 12)
    at full size.  Returns the launches of K3 and K4 in those runs."""
    import torch

    from kmer_spans_tpu_torch.ops import gather, histogram
    from kmer_spans_tpu_torch.spans.finish import finish_spans, \
        unpack_outputs
    from kmer_spans_tpu_torch.spans.pipeline import make_span_pipeline
    from kmer_spans_tpu_torch.utils import native

    n = nbases_dev.shape[0]
    cand = cand_blocks(n)
    launches = {"histogram": 0, "word_gather": 0}
    want = {9: (1, 1), 12: (2, 1)}  # (K3, K4) launches per call
    for k in (9, 12):
        fn = make_span_pipeline(k, block=BLOCK, cand_blocks=cand, packed=True,
                                packed_counts=k < 10, device=dev)
        counts = None
        if not fn.packed_counts:
            t0 = time.perf_counter()
            counts, _ = native.host_spectrum(nbases, k)
            log(f"  k={k}: host recount {time.perf_counter() - t0:.3f} s")

        def finish(host):
            out = unpack_outputs(host, k, n, BLOCK, cand,
                                 packed_bases=fn.packed_bases,
                                 packed_counts=fn.packed_counts,
                                 lazy_codes=True)
            return finish_spans(out, n, THR, MIN_W, MIN_S, block=BLOCK,
                                counts=counts)

        torch.cuda.empty_cache()
        zero_launch_counts()
        runs = [timed_run(fn, nbases_dev, finish, plain=False)]
        got = (histogram.histogram_launches, gather.launches)
        if got != want[k]:
            raise AssertionError(f"k={k} ({fn.screen} screen): launches "
                                 f"(K3, K4) {got}, expected {want[k]}")
        launches["histogram"] += got[0]
        launches["word_gather"] += got[1]
        runs += [timed_run(fn, nbases_dev, finish, plain=p)
                 for p in (False, True)]
        compare_runs(f"k={k} {fn.screen} screen n={n:,} block={BLOCK} "
                     f"cand={cand}", card, n, runs)
    return launches


@contextlib.contextmanager
def api_stages():
    """While on, the exact api path's stages are timed on the host clock:
    the spectrum count (to its pull), the host staging of each sequence
    (N-padded uint8 bases, in the count and before each device step), each
    device step (to its synchronize), the pull of its outputs, the host
    finish and, inside it, the batched pulls of the candidate blocks the
    top C missed.  Yields the dict of sums in s and the number of
    batches."""
    import torch

    from kmer_spans_tpu_torch import api
    from kmer_spans_tpu_torch.parallel import device as par_device

    st = {"count": 0.0, "count_staging": 0.0, "staging": 0.0,
          "device": 0.0, "pull": 0.0, "finish": 0.0, "batches": 0,
          "batch_s": 0.0}
    saved = (api.device_count_spectrum, api.make_weight_span_pipeline,
             api.finish_weight_spans, api.staged_nbases,
             par_device.staged_nbases)
    count0, make0, finish0, stage0, _ = saved

    def staging(key):
        def stage(*a, **kw):
            t0 = time.perf_counter()
            out = stage0(*a, **kw)
            st[key] += time.perf_counter() - t0
            return out
        return stage

    def count(*a, **kw):
        t0 = time.perf_counter()
        out = count0(*a, **kw)
        st["count"] += time.perf_counter() - t0
        return out

    def make(*a, **kw):
        fn = make0(*a, **kw)

        def step(nbases, w_q):
            t0 = time.perf_counter()
            out = fn(nbases, w_q)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = {key: v.cpu() for key, v in out.items()}
            st["device"] += t1 - t0
            st["pull"] += time.perf_counter() - t1
            return out

        def pull(nbases, idx):
            t0 = time.perf_counter()
            codes, scored = (t.cpu() for t in fn.pull(nbases, idx))
            st["batch_s"] += time.perf_counter() - t0
            st["batches"] += 1
            return codes, scored

        step.pull = pull
        return step

    def finish(*a, **kw):
        t0 = time.perf_counter()
        res = finish0(*a, **kw)
        st["finish"] += time.perf_counter() - t0
        return res

    (api.device_count_spectrum, api.make_weight_span_pipeline,
     api.finish_weight_spans, api.staged_nbases,
     par_device.staged_nbases) = (count, make, finish, staging("staging"),
                                  staging("count_staging"))
    try:
        yield st
    finally:
        (api.device_count_spectrum, api.make_weight_span_pipeline,
         api.finish_weight_spans, api.staged_nbases,
         par_device.staged_nbases) = saved


def valid_kmers(nbases: np.ndarray, k: int) -> int:
    """The number of k-mers with no N, from the N-free stretches' lengths."""
    ns = np.flatnonzero(nbases >= 4)
    lens = np.diff(np.concatenate([[-1], ns, [nbases.shape[0]]])) - 1
    return int(np.maximum(lens - k + 1, 0).sum())


def cpg_table() -> np.ndarray:
    """The CpG-style k = 8 weight table of phases 9 and 15: +1.5 for the
    planted repeat's k-mers, -0.4 for every other."""
    from kmer_spans_tpu_torch.encoding import all_kmers

    island = {"AGAGAGAG", "GAGAGAGA"}
    return np.array([1.5 if km in island else -0.4 for km in all_kmers(8)])


def exact_phase(dev, nbases: np.ndarray, card: str):
    """Phase 9: the exact api path at full size, each call with the
    kernels and again with the plain versions on the card: kmer_counts
    and the default kmer_low_comp_regions(mode="exact") at k = 8 and 12,
    kmer_regions at k = 8 with a CpG-style table on the planted repeat
    (its k-mers +1.5, every other -0.4) at min_score 20 and 0 (the pull
    path).  Returns K3's launches in the kernels' runs, the exact
    regions of kmer_low_comp_regions by k (phase 12 holds the stream to
    them) and the kernels' results and walls by call (phase 15 holds the
    CPU backends to them)."""
    import types

    import torch

    from kmer_spans_tpu_torch import api
    from kmer_spans_tpu_torch.encoding import PackedSeq
    from kmer_spans_tpu_torch.ops import histogram

    n = nbases.shape[0]
    seq = PackedSeq(bases=nbases & 3, valid=nbases < 4)
    launches = 0
    results = {}

    def both(label, call):
        """(kernels' result, plain result), each run timed; the kernels'
        result and wall kept in ``results`` under ``label``."""
        nonlocal launches
        out = []
        for plain in (False, True):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            zero_launch_counts()
            with plain_versions(plain), api_stages() as st:
                t0 = time.perf_counter()
                res = call()
                wall = time.perf_counter() - t0
            if not plain:
                if histogram.histogram_launches < 1:
                    raise AssertionError(f"{label}: the exact path skipped "
                                         "the histogram")
                launches += histogram.histogram_launches
                results[label] = (res, wall)
            rest = wall - st["count"] - st["staging"] - st["device"] - \
                st["pull"] - st["finish"]
            log(f"  {label}, {'plain versions' if plain else 'kernels'}: "
                f"wall {wall:.3f} s; count {st['count'] * 1e3:.1f} ms (of "
                f"which host staging {st['count_staging'] * 1e3:.1f} ms), "
                f"host staging {st['staging'] * 1e3:.1f} ms, "
                f"device step {st['device'] * 1e3:.1f} ms, pull "
                f"{st['pull'] * 1e3:.1f} ms, host finish "
                f"{st['finish'] * 1e3:.1f} ms (of which "
                f"{st['batches']} batched pulls {st['batch_s'] * 1e3:.1f} "
                f"ms), other host (weights, table) {rest * 1e3:.1f} ms; peak "
                f"device memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
                f"[{card}]")
            out.append(res)
        return out

    def same(label, got, want, fields):
        for f in fields:
            if not np.array_equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"{label}: {f} differs from the plain "
                                     "run")

    def islands(res):
        return check_islands(types.SimpleNamespace(
            fallback=False, regions=[tuple(r)[:4] for r in res.regions]), n)

    for k in (8, 12):
        got, want = both(f"kmer_counts k={k}",
                         lambda: api.kmer_counts(seq, k, device=dev))
        same(f"kmer_counts k={k}", got, want, ("n", "counts"))
        if got.n != valid_kmers(nbases, k) or got.n != got.counts.sum():
            raise AssertionError(f"kmer_counts k={k}: n {got.n} is not the "
                                 "number of valid k-mers")
        log(f"  kmer_counts k={k}: n = {int(got.n):,} valid k-mers, equal "
            "to the plain run")
    exact = {}
    for k in (8, 12):
        got, want = both(
            f"kmer_low_comp_regions k={k} exact",
            lambda: api.kmer_low_comp_regions(seq, k, MIN_W, MIN_S, thr=THR,
                                              device=dev))
        same(f"exact k={k}", got, want, ("n", "counts", "regions", "w_rank"))
        exact[k] = [(int(r["seq_id"]), int(r["beg"]), int(r["end"]),
                     float(r["score"])) for r in got.regions]
        log(f"  kmer_low_comp_regions k={k} exact: {len(got.regions)} "
            f"regions, all {islands(got)} planted islands called, equal to "
            "the plain run bit for bit")
    w = cpg_table()
    for min_score in (MIN_S, 0.0):
        got, want = both(
            f"kmer_regions k=8 min_score={min_score}",
            lambda: api.kmer_regions(seq, 8, w, MIN_W, min_score,
                                     device=dev))
        same(f"kmer_regions min_score={min_score}", got, want,
             ("n", "counts", "regions"))
        log(f"  kmer_regions k=8 min_score={min_score}: "
            f"{len(got.regions)} regions, all {islands(got)} planted "
            f"islands called, scan counts sum {int(got.counts.sum()):,}, "
            "equal to the plain run")
    return launches, exact, results


@contextlib.contextmanager
def window_stages():
    """While on, the window path's stages are timed: the staging of each
    sequence on the card (bases and validity copied, merged there; host
    clock to a synchronize) and each chunk's device work (CUDA events, no
    synchronize).  Yields the dict of sums in s and the chunk count."""
    import torch

    from kmer_spans_tpu_torch.parallel import device as par_device
    from kmer_spans_tpu_torch.parallel.window_stream import (
        StreamingWindowEngine,
    )

    st = {"staging": 0.0, "device": 0.0, "chunks": 0}
    events = []
    stage0, chunk0 = par_device.device_nbases, StreamingWindowEngine._chunk

    def stage(*a, **kw):
        t0 = time.perf_counter()
        out = stage0(*a, **kw)
        torch.cuda.synchronize()
        st["staging"] += time.perf_counter() - t0
        return out

    def chunk(self, *a, **kw):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = chunk0(self, *a, **kw)
        e1.record()
        events.append((e0, e1))
        st["chunks"] += 1
        return out

    par_device.device_nbases, StreamingWindowEngine._chunk = stage, chunk
    try:
        yield st
    finally:
        par_device.device_nbases, StreamingWindowEngine._chunk = \
            stage0, chunk0
        torch.cuda.synchronize()
        st["device"] = sum(a.elapsed_time(b) for a, b in events) / 1e3


def both_runs(label, call, card, stages, counted=True):
    """Run ``call`` with the kernels, then with the plain versions, each
    timed; returns (kernels' result, plain result, K3's launches in the
    kernels' run, the window counts kernel's launches in it)."""
    import torch

    from kmer_spans_tpu_torch.ops import histogram, window

    out, launches, n_window = [], 0, 0
    for plain in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        with plain_versions(plain), stages() as st:
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if not plain:
            launches = histogram.histogram_launches
            n_window = window.window_counts_launches
            if counted and launches < 1:
                raise AssertionError(f"{label}: the path skipped K3")
        parts = ", ".join(
            f"{key} {v * 1e3:.1f} ms" if isinstance(v, float) else
            f"{key} {v}" for key, v in st.items())
        log(f"  {label}, {'plain versions' if plain else 'kernels'}: wall "
            f"{wall:.3f} s; {parts}; K3 launches "
            f"{histogram.histogram_launches}, window counts launches "
            f"{window.window_counts_launches}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
        out.append(res)
    return out[0], out[1], launches, n_window


def window_phase(dev, nbases: np.ndarray, card: str) -> tuple[int, int]:
    """Phase 10: windowed distributions at full size, each run with the
    kernels and again with the plain versions, the two equal: the 16
    dimers, window 200, over the whole genome (ret_flag 0) and its first
    48 Mb (ret_flag 1, the int64 positions matrix); the 154-scaffold
    cohort per scaffold (kmer_counts k = 1 and window_kmer_dist) and in
    one windowed_counts_device(seg2d=...) call.  Returns K3's launches and
    the window counts kernel's in the kernels' runs, that kernel launched
    once a chunk (a group of starts)."""
    import torch

    from kmer_spans_tpu_torch import api
    from kmer_spans_tpu_torch.encoding import PackedSeq
    from kmer_spans_tpu_torch.ops.window import GROUP, windowed_counts_device
    from kmer_spans_tpu_torch.parallel import window_stream

    dimers = api.kmer_seq(2)
    launches, n_window = 0, 0

    def runs(label, call, stages):
        """both_runs, and the window counts kernel launched once a chunk
        (a group of starts) in the kernels' run."""
        nonlocal launches, n_window
        c0 = window_stream.chunks
        got, want, n_k3, n_w = both_runs(label, call, card, stages)
        chunks = (window_stream.chunks - c0) // 2
        if n_w != chunks:
            raise AssertionError(f"{label}: {n_w} window counts launches "
                                 f"for {chunks} chunks")
        launches += n_k3
        n_window += n_w
        return got, want, n_k3

    def packed(x):
        return PackedSeq(bases=x & 3, valid=x < 4)

    seq = packed(nbases)
    got, want, n_k3 = runs(
        "window_kmer_dist 16 dimers w=200 ret_flag=0",
        lambda: api.window_kmer_dist(seq, dimers, 200, freq=False,
                                     device=dev), window_stages)
    if not np.array_equal(got.dist, want.dist) or got.scores is not None:
        raise AssertionError("window_kmer_dist differs from the plain run")
    nwin = int(got.dist[:, 0].sum())
    if nwin <= 0 or (got.dist.sum(axis=0) != nwin).any():
        raise AssertionError("window_kmer_dist: columns count different "
                             "numbers of windows")
    log(f"  window_kmer_dist: {nwin:,} valid windows, {n_k3} K3 launches, "
        "equal to the plain run")
    del got, want
    head = packed(nbases[:48_000_000])
    got, want, _ = runs(
        "window_kmer_dist 16 dimers w=200 ret_flag=1, first 48 Mb",
        lambda: api.window_kmer_dist(head, dimers, 200, freq=False,
                                     ret_flag=1, device=dev), window_stages)
    if not (np.array_equal(got.dist, want.dist)
            and np.array_equal(got.scores[0], want.scores[0])):
        raise AssertionError("window_kmer_dist ret_flag=1 differs from the "
                             "plain run")
    cpos = got.scores[0]
    if cpos.shape != (48_000_000, 16) or cpos.dtype != np.int64:
        raise AssertionError(f"positions matrix {cpos.shape} {cpos.dtype}")
    log(f"  ret_flag=1: positions matrix {cpos.shape} int64 "
        f"({cpos.nbytes / 1e9:.2f} GB), max count {int(cpos.max())}, equal "
        "to the plain run")
    del got, want, cpos

    scaffolds, cat, seg = cohort(nbases)
    log(f"  cohort: {len(scaffolds)} scaffolds, {cat.shape[0]:,} positions "
        f"with separators, longest {scaffolds[0].shape[0]:,}")

    def per_scaffold():
        t0 = time.perf_counter()
        mono = [api.kmer_counts(packed(s), 1, with_f=False,
                                device=dev).counts for s in scaffolds]
        t1 = time.perf_counter()
        dists = [api.window_kmer_dist(packed(s), dimers, 200, freq=False,
                                      device=dev).dist for s in scaffolds]
        log(f"    kmer_counts k=1 x {len(scaffolds)}: {t1 - t0:.3f} s; "
            f"window_kmer_dist x {len(scaffolds)}: "
            f"{time.perf_counter() - t1:.3f} s")
        return np.stack(mono), np.stack(dists)

    got, want, _ = runs("cohort, per-scaffold calls", per_scaffold,
                        window_stages)
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("cohort per scaffold differs from the plain run")
    mono, dists = got
    if (mono.sum(axis=1) != [valid_kmers(s, 1) for s in scaffolds]).any():
        raise AssertionError("kmer_counts k=1 miscounted a scaffold")
    tracked = torch.arange(16, dtype=torch.int32, device=dev)

    def one_call():
        t0 = time.perf_counter()
        codes, kv, v2, seg2 = cohort_counts_inputs(dev, cat, seg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        d, _, _ = windowed_counts_device(codes, kv, v2, tracked, 2, 200,
                                         seg2d=seg2, n_seqs=len(scaffolds))
        d = d.cpu().numpy()
        log(f"    one call: staging and codes {t1 - t0:.3f} s, "
            f"windowed_counts_device {time.perf_counter() - t1:.3f} s")
        return d

    got, want, n_k3, n_w = both_runs("cohort, one seg2d call", one_call,
                                     card, lambda: contextlib.nullcontext({}))
    groups = -(-cat.shape[0] // GROUP)
    if n_w != groups:
        raise AssertionError(f"cohort call: {n_w} window counts launches for "
                             f"{groups} groups")
    launches += n_k3
    n_window += n_w
    if not np.array_equal(got, want):
        raise AssertionError("cohort call differs from the plain run")
    if not np.array_equal(got.astype(np.int64), dists):
        raise AssertionError("cohort call differs from the per-scaffold "
                             "calls")
    log(f"  cohort: per-scaffold calls and the one seg2d call equal "
        f"(dist {got.shape}), equal to the plain runs")
    return launches, n_window


@contextlib.contextmanager
def tr_stages():
    """While on, the tr path's stages are timed on the host clock, each
    to a synchronize: the staging of each sequence on the card, the
    summaries, the runstats, the batched candidate pulls (counted) and
    the host replay."""
    import torch

    from kmer_spans_tpu_torch.parallel import device as par_device
    from kmer_spans_tpu_torch.spans import tr_pipeline as tr

    st = {"staging": 0.0, "summaries": 0.0, "runstats": 0.0, "pulls": 0.0,
          "replay": 0.0, "pull batches": 0}
    saved = (par_device.device_nbases, tr.TrPipeline.summaries,
             tr.TrPipeline.runstats, tr._pull_batches, tr._replay_stretches)

    def timed(key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            st[key] += time.perf_counter() - t0
            if key == "pulls":
                st["pull batches"] += out[1]
            return out
        return run

    (par_device.device_nbases, tr.TrPipeline.summaries,
     tr.TrPipeline.runstats, tr._pull_batches, tr._replay_stretches) = (
        timed(key, fn) for key, fn in zip(
            ("staging", "summaries", "runstats", "pulls", "replay"), saved))
    try:
        yield st
    finally:
        (par_device.device_nbases, tr.TrPipeline.summaries,
         tr.TrPipeline.runstats, tr._pull_batches,
         tr._replay_stretches) = saved


def tr_tables(k: int):
    """Phase 11's tables, in 2-bit order: at k = 2 AG and GA seed 2.0 and
    transition 2.0, every other dimer -1.0 / -0.5; at k = 8 AGAGAGAG and
    GAGAGAGA +1.5, every other 8-mer -0.4 (both scores)."""
    from kmer_spans_tpu_torch.encoding import all_kmers

    kmers = all_kmers(k)
    if k == 2:
        hot = ("AG", "GA")
        ks = [2.0 if km in hot else -1.0 for km in kmers]
        ts = [2.0 if km in hot else -0.5 for km in kmers]
    else:
        hot = ("AGAGAGAG", "GAGAGAGA")
        ks = ts = [1.5 if km in hot else -0.4 for km in kmers]
    return kmers, ks, ts


def lr_phase(dev, nbases: np.ndarray, card: str) -> None:
    """Phase 11: api.lr_regions on the whole genome at min_length 100, at
    k = 2 and k = 8, with the kernels and again with the plain versions
    (no kernel is on this path: the two must be equal all the same);
    every planted island called; the first 2^20 bases held against the
    sequential oracle, positions and f64 scores equal."""
    import types

    from kmer_spans_tpu_torch import api
    from kmer_spans_tpu_torch.encoding import PackedSeq
    from kmer_spans_tpu_torch.oracle import find_tr_regions

    n = nbases.shape[0]
    seq = PackedSeq(bases=nbases & 3, valid=nbases < 4)
    head = PackedSeq(bases=nbases[:1 << 20] & 3, valid=nbases[:1 << 20] < 4)
    for k in (2, 8):
        kmers, ks, ts = tr_tables(k)
        api.exact_fallbacks = 0
        got, want, _, _ = both_runs(
            f"lr_regions k={k} min_length=100",
            lambda: api.lr_regions(seq, (k, 100), kmers, ks, ts, device=dev),
            card, tr_stages, counted=False)
        if not (np.array_equal(got.regions, want.regions)
                and np.array_equal(got.kmer_scores, want.kmer_scores)):
            raise AssertionError(f"lr_regions k={k} differs from the plain "
                                 "run")
        hit = check_islands(types.SimpleNamespace(
            fallback=False, regions=[tuple(r)[:4] for r in got.regions]), n)
        # exact_fallbacks counted the batches beyond the first in both runs
        log(f"  lr_regions k={k}: {len(got.regions)} regions, all {hit} "
            f"planted islands called, {api.exact_fallbacks // 2} pull "
            "batches beyond the first, equal to the plain run")
        t0 = time.perf_counter()
        res = api.lr_regions(head, (k, 100), kmers, ks, ts, device=dev)
        t1 = time.perf_counter()
        want = find_tr_regions(head, 1, k, res.kmer_scores[:, 0],
                               res.kmer_scores[:, 1], 100)
        got = [tuple(r)[:4] for r in res.regions]
        if got != want or not got:
            raise AssertionError(f"lr_regions k={k}, first 2^20 bases: "
                                 f"{got[:3]} != oracle {want[:3]}")
        log(f"  lr_regions k={k}, first 2^20 bases: {len(got)} regions == "
            f"the oracle's, positions and f64 scores ({t1 - t0:.3f} s on the "
            f"card, {time.perf_counter() - t1:.3f} s the oracle)")


STREAM_CHUNK = 1 << 25
STREAM_C = 128


def time_stream_shapes(dev, nbases_dev) -> tuple[dict, dict, list]:
    """Phase 6 at the stream's chunk shapes, on the genome's first 2^25
    bases: K2 on the chunk's k = 8 aug words, K4 on its k = 9 codes (each
    with the table of the chunk's own spectrum), and K3 on its k = 8, 9
    and 12 codes (4^8, 4^9 and 4^12 bins).  Returns (K2 shape, K4 shape,
    K3 shapes)."""
    import torch

    from kmer_spans_tpu_torch.ops import gather, histogram
    from kmer_spans_tpu_torch.ops.blocked import blocked_codes
    from kmer_spans_tpu_torch.ops.screen_scan import (
        fused_screen_scan,
        fused_screen_scan_plain,
    )
    from kmer_spans_tpu_torch.parallel.pipeline import _rank_mass
    from kmer_spans_tpu_torch.spans.pipeline import aug_words

    x = nbases_dev[:STREAM_CHUNK]
    nb = STREAM_CHUNK // BLOCK
    b2, v2 = (x & 3).reshape(nb, BLOCK), (x < 4).reshape(nb, BLOCK)
    thr_q = gather.screen_thr_q(
        torch.tensor(THR, dtype=torch.float32, device=dev))
    k3 = []
    for k in (8, 9, 12):
        codes, kv = blocked_codes(b2, v2, k)
        codes, kv = codes.reshape(-1), kv.reshape(-1)
        k3.append(hist_entry(f"stream chunk, k = {k} codes", codes, kv,
                             1 << (2 * k)))
        if k == 9:
            counts = histogram.count_spectrum(codes, kv, k)
            words = gather.class_table_from_mass(
                _rank_mass(counts), counts.sum().to(torch.float32))
            if max_abs_err(gather.word_gather(words, codes, thr_q),
                           gather.word_gather_plain(words, codes, thr_q)):
                raise AssertionError("word_gather differs from plain at the "
                                     "stream chunk shape")
            t = in_turns(f"word_gather (stream chunk, k = 9 codes, "
                         f"{codes.numel():,} entries)",
                         lambda: gather.word_gather(words, codes, thr_q),
                         lambda: gather.word_gather_plain(words, codes,
                                                          thr_q))
            n = codes.numel()
            k4 = shape_entry("stream chunk, k = 9 codes, 32768 words", t,
                             bound(n * 8 + words.numel() * 4, n))
        del codes, kv
    aug, _ = aug_words(x, 8, BLOCK)
    flat = aug.reshape(-1)
    counts = histogram.count_spectrum(flat & 0xFFFF,
                                      ((flat >> 16) & 1) == 1, 8)
    words = gather.class_table_from_mass(_rank_mass(counts),
                                         counts.sum().to(torch.float32))
    args = (words, flat, thr_q, 4, BLOCK)
    if max_abs_err(fused_screen_scan(*args), fused_screen_scan_plain(*args)):
        raise AssertionError("fused_screen_scan differs from plain at the "
                             "stream chunk shape")
    t = in_turns(f"fused_screen_scan (stream chunk, {flat.numel():,} aug "
                 "words)", lambda: fused_screen_scan(*args),
                 lambda: fused_screen_scan_plain(*args))
    n = flat.numel()
    k2 = shape_entry(f"stream chunk, k = 8 aug words, block {BLOCK}", t,
                     bound(n * 4 + words.numel() * 4 + 4 * (n // BLOCK) * 4,
                           n))
    return k2, k4, k3


def time_wide_shapes(dev, nbases_dev) -> tuple[list, dict]:
    """Phase 6 at the wide paths' shapes, k = 17 over the genome (4^17 >>
    n: nearly every k-mer is unique, so nearly every run has v = 1 and
    every valid position is a run head): K3 on the wide pm screen's run
    lengths (256 bins, one hot bin; every form) and on the wide sort
    screen's two run histograms (65536 bins each, the same skew), each
    beside the mask it needs; K4 on the wide sort screen's entries (16384
    words).  Returns (K3 shapes, K4 shape)."""
    import torch

    from kmer_spans_tpu_torch.ops import gather, sortscreen
    from kmer_spans_tpu_torch.ops.blocked import blocked_codes_wide
    from kmer_spans_tpu_torch.ops.pmscreen import pm_params, sorted_runs

    k = 17
    n = nbases_dev.shape[0]
    nb = n // BLOCK
    codes, kv = blocked_codes_wide((nbases_dev & 3).reshape(nb, BLOCK),
                                   (nbases_dev < 4).reshape(nb, BLOCK), k)
    skey, _, head, v, real = sorted_runs(codes.reshape(-1), kv.reshape(-1),
                                         k)
    total = kv.sum(dtype=torch.int32)
    del codes, kv
    hb = ((skey >> (2 * k - 8)) & 255).to(torch.int32)
    del skey
    mask = head & real
    nbins = pm_params(k, None, n=n, wide=True)[3]
    runs = int(mask.sum())
    log(f"  wide k = 17 runs: {runs:,} of {int(total):,} valid k-mers, "
        f"{int((mask & (v == 1)).sum()):,} of them with v = 1 (one hot bin)")
    k3 = [hist_entry("wide k = 17 pm run lengths", torch.clamp(
        v, max=nbins - 1), mask, nbins, more=(("mask_ms",
                                                lambda: head & real),),
        kind="repeats")]
    del head, real
    vmax, v2_ = sortscreen.VMAX, sortscreen.V2
    k3.append(hist_entry("wide k = 17 sort screen, runs by value",
                         torch.clamp(v, max=vmax - 1), mask, vmax,
                         kind="repeats"))
    k3.append(hist_entry("wide k = 17 sort screen, runs by value and high "
                         "byte", torch.clamp(v, max=v2_ - 1) * 256 + hb,
                         mask & (v < v2_), v2_ * 256, kind="repeats"))
    words = sortscreen.rank_ub_tables(
        *sortscreen.rank_ub_histograms(v, hb, mask, vmax, v2_), total, vmax,
        v2_)
    entry = sortscreen.rank_ub_entries(v, hb, vmax, v2_)
    del v, hb, mask
    thr_q = gather.screen_thr_q(
        torch.tensor(THR, dtype=torch.float32, device=dev))
    if max_abs_err(gather.word_gather(words, entry, thr_q),
                   gather.word_gather_plain(words, entry, thr_q)):
        raise AssertionError("word_gather differs from plain at the wide "
                             "sort screen's entries")
    t = in_turns(f"word_gather (wide k = 17 sort entries, {entry.numel():,} "
                 f"entries, {words.numel()} words)",
                 lambda: gather.word_gather(words, entry, thr_q),
                 lambda: gather.word_gather_plain(words, entry, thr_q))
    m = entry.numel()
    k4 = shape_entry(f"wide k = 17 sort entries, {words.numel()} words", t,
                     bound(m * 8 + words.numel() * 4, m))
    return k3, k4


def record_chunks(pipe) -> list:
    """Keep each chunk's block summaries and top C (the leading arguments
    of the pipeline's host finish)."""
    rec = []
    orig = pipe._finish_chunk

    def keep(*a, **kw):
        rec.append([np.array(v) for v in a[:5]])
        return orig(*a, **kw)

    pipe._finish_chunk = keep
    return rec


def stream_run(dev, k, chunks, scoring=None, plain=False, timed=False,
               **kw):
    """One StreamingSpanPipeline.run at chunk 2^25, block 8192, C = 128,
    with the kernels (launches counted from 0 here) or the plain versions;
    ``timed`` keeps each chunk's stage times (pipe.chunk_times).  Returns
    (result, per-chunk records, launches, metrics, peak bytes, wall s,
    pipeline)."""
    import torch

    from kmer_spans_tpu_torch.ops import gather, histogram, screen_scan
    from kmer_spans_tpu_torch.parallel.stream import StreamingSpanPipeline
    from kmer_spans_tpu_torch.utils.metrics import Metrics

    pipe = StreamingSpanPipeline(k, chunk_bases=STREAM_CHUNK, block=BLOCK,
                                 cand_blocks=STREAM_C, device=dev)
    rec = record_chunks(pipe)
    if timed:
        pipe.chunk_times = []
    metrics = Metrics()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    with plain_versions(plain):
        t0 = time.perf_counter()
        res = pipe.run(chunks, THR, MIN_W, MIN_S, metrics=metrics,
                       scoring=scoring, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"histogram": histogram.histogram_launches,
                "fused_screen_scan": screen_scan.launches,
                "word_gather": gather.launches}
    return (res, rec, launches, metrics, torch.cuda.max_memory_allocated(),
            wall, pipe)


def stream_walls(metrics) -> str:
    by = {}
    for p in metrics.phases:
        name = "scan" if p.name == "scan_chunk" else p.name
        by[name] = by.get(name, 0.0) + p.seconds
    return ", ".join(f"{name} {sec:.3f} s" for name, sec in by.items())


def chunk_stage_times(times: list) -> str:
    """Per-chunk device stage times (CUDA events) and host finish, as the
    median over the chunks of each pass and the pass's sum."""
    out = []
    for phase in ("count", "scan"):
        rows = [t for t in times if t["phase"] == phase]
        names = [key for key in rows[0] if key != "phase"]
        out.append(f"{phase} ({len(rows)} chunks): " + ", ".join(
            f"{name} {np.median([r[name] for r in rows]):.3f} ms "
            f"(sum {sum(r[name] for r in rows):.1f})" for name in names))
    return "; ".join(out)


def islands_called(regions, n: int) -> int:
    import types

    return check_islands(types.SimpleNamespace(fallback=False,
                                               regions=regions), n)


def stream_phase(dev, nbases: np.ndarray, exact: dict, seed: int,
                 card: str) -> dict:
    """Phase 12: StreamingSpanPipeline on the card, chunk 2^25, block 8192,
    C = 128: at k = 8, 9 and 12 with rank scoring and at k = 8 with
    threshold scoring over the genome (8 chunks), each with the kernels
    and again with the plain versions (spectra, per-chunk summaries and
    regions equal), every island called, nothing unresolved, the k = 8
    and 12 regions equal to phase 9's exact ones bit for bit; a resume
    after chunk 3; then k = 12 over a 2^30-base genome (32 chunks), its
    peak memory and per-chunk stage times.  Returns the kernels' launches
    in the kernels' runs."""
    import tempfile

    from kmer_spans_tpu_torch.models.scoring import ThresholdScoring
    from kmer_spans_tpu_torch.ops import _build

    n = nbases.shape[0]
    nchunks = n // STREAM_CHUNK

    def chunks():
        for i in range(0, n, STREAM_CHUNK):
            yield nbases[i:i + STREAM_CHUNK]

    def threshold(counts, total):
        return ThresholdScoring(counts, 1e-4)

    total = {"histogram": 0, "fused_screen_scan": 0, "word_gather": 0}
    runs = (("k=8 rank", 8, None, "fused_screen_scan"),
            ("k=9 rank", 9, None, "word_gather"),
            ("k=12 rank", 12, None, None),
            ("k=8 threshold f_t=1e-4", 8, threshold, None))
    full8 = None
    for label, k, scoring, screen in runs:
        got, rec, launches, metrics, peak, wall, pipe = stream_run(
            dev, k, chunks, scoring)
        want = {"histogram": nchunks, "fused_screen_scan": 0,
                "word_gather": 0}
        if screen:
            want[screen] = nchunks
        if launches != want:
            raise AssertionError(f"stream {label}: launches {launches}, "
                                 f"expected {want}")
        for name in total:
            total[name] += launches[name]
        ref, ref_rec, _, ref_metrics, ref_peak, ref_wall, _ = stream_run(
            dev, k, chunks, scoring, plain=True)
        if not np.array_equal(got.counts_host, ref.counts_host):
            raise AssertionError(f"stream {label}: spectrum differs from "
                                 "the plain run")
        if len(rec) != nchunks or not all(
                np.array_equal(a, b) for r, w in zip(rec, ref_rec)
                for a, b in zip(r, w)):
            raise AssertionError(f"stream {label}: chunk summaries differ "
                                 "from the plain run")
        if got.regions != ref.regions or got.unresolved or ref.unresolved:
            raise AssertionError(f"stream {label}: regions differ from the "
                                 f"plain run, or unresolved "
                                 f"{got.unresolved[:3]}")
        hit = islands_called(got.regions, n)
        if scoring is None and k in exact:
            if got.regions != exact[k]:
                raise AssertionError(f"stream {label}: regions differ from "
                                     "the exact api path's")
            same = ", equal to phase 9's exact regions bit for bit"
        else:
            same = ""
        if k == 8 and scoring is None:
            full8 = got
        log(f"  stream {label}: {len(got.regions)} regions, all {hit} "
            f"islands called, {pipe.pull_batches} pull batches, launches "
            f"{launches}, equal to the plain run{same}")
        log(f"    kernels: wall {wall:.3f} s ({stream_walls(metrics)}); "
            f"peak device memory {peak / 2 ** 30:.2f} GiB [{card}]")
        log(f"    plain versions: wall {ref_wall:.3f} s "
            f"({stream_walls(ref_metrics)}); peak device memory "
            f"{ref_peak / 2 ** 30:.2f} GiB")

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        ckpt = f"{tmp}/stream.npz"
        part = stream_run(dev, 8, chunks, checkpoint_path=ckpt,
                          stop_after_chunk=3)[0]
        if len(part.regions) >= len(full8.regions):
            raise AssertionError("the stopped stream ran to the end")
        resumed = stream_run(dev, 8, chunks, checkpoint_path=ckpt,
                             resume=True)[0]
    if resumed.regions != full8.regions or resumed.unresolved:
        raise AssertionError("stream resume after chunk 3 differs from the "
                             "uninterrupted run")
    log(f"  stream k=8, stopped after chunk 3 and resumed: "
        f"{len(resumed.regions)} regions, equal to the uninterrupted run")

    t0 = time.perf_counter()
    big = make_genome(1 << 30, seed)
    nbig = big.shape[0]
    log(f"  made the {nbig:,}-base genome in {time.perf_counter() - t0:.1f} s")

    def big_chunks():
        for i in range(0, nbig, STREAM_CHUNK):
            yield big[i:i + STREAM_CHUNK]

    res, _, launches, metrics, peak, wall, pipe = stream_run(
        dev, 12, big_chunks, timed=True)
    if launches["histogram"] != nbig // STREAM_CHUNK or res.unresolved:
        raise AssertionError(f"2^30 stream: launches {launches}, unresolved "
                             f"{res.unresolved[:3]}")
    total["histogram"] += launches["histogram"]
    hit = islands_called(res.regions, nbig)
    log(f"  stream k=12 over {nbig:,} bases ({nbig // STREAM_CHUNK} "
        f"chunks): {len(res.regions)} regions, all {hit} islands called, "
        f"{pipe.pull_batches} pull batches, wall {wall:.3f} s "
        f"({stream_walls(metrics)}), peak device memory "
        f"{peak / 2 ** 30:.2f} GiB [{card}]")
    log(f"    per-chunk device stages: {chunk_stage_times(pipe.chunk_times)}")
    return total


def wide_phase(dev, nbases: np.ndarray, card: str) -> tuple[dict, list]:
    """Phase 13: wide codes on the genome.  The wide pm pipeline at k = 17
    and 23 (make_wide_pm_pipeline -> unpack_pm_outputs -> finish_pm_spans)
    and the wide sort route at k = 17 (make_wide_span_pipeline,
    device_sparse_spectrum, finish_wide_spans), each with the kernels and
    with the plain versions (vectors and regions equal), launch counts
    read around the kernels' run, every island called, the sort route's
    regions equal to the pm route's; then api.kmer_wide_regions at k = 17
    over the genome (n_words the valid k-mers, regions equal to the
    pipeline's, spectrum equal to the sort route's), over its first 2^20
    bases and over the golden genome, both equal to the sequential oracle
    with a SparseRanks lookup.  Returns the kernels' launches and the
    k = 17 regions (phase 14 holds the wide sharded scan to them)."""
    import torch

    from kmer_spans_tpu_torch import api
    from kmer_spans_tpu_torch.encoding import PackedSeq
    from kmer_spans_tpu_torch.ops import gather, histogram
    from kmer_spans_tpu_torch.ops.blocked import blocked_codes_wide
    from kmer_spans_tpu_torch.ops.convert import to_tensor
    from kmer_spans_tpu_torch.oracle import (
        count_spectrum_sparse,
        find_regions,
        golden_genome,
    )
    from kmer_spans_tpu_torch.parallel.device import device_sparse_spectrum
    from kmer_spans_tpu_torch.spans import finish, pm_finish
    from kmer_spans_tpu_torch.spans.pipeline import make_wide_span_pipeline
    from kmer_spans_tpu_torch.spans.pm_pipeline import make_wide_pm_pipeline
    from kmer_spans_tpu_torch.stats.ranks import SparseRanks

    n = nbases.shape[0]
    cand = cand_blocks(n)
    nbases_dev = to_tensor(nbases, dev)
    b2 = (nbases_dev & 3).reshape(-1, BLOCK)
    v2 = (nbases_dev < 4).reshape(-1, BLOCK)
    launches = {"histogram": 0, "word_gather": 0}

    def kernels_run(fn, finish_fn, label, want):
        """The kernels' run with the counts set to 0 just before it and
        read just after, then the kernels again and the plain versions."""
        torch.cuda.empty_cache()
        zero_launch_counts()
        runs = [timed_run(fn, nbases_dev, finish_fn, plain=False)]
        got = (histogram.histogram_launches, gather.launches)
        if got != want:
            raise AssertionError(f"{label}: launches (K3, K4) {got}, "
                                 f"expected {want}")
        launches["histogram"] += got[0]
        launches["word_gather"] += got[1]
        return runs + [timed_run(fn, nbases_dev, finish_fn, plain=p)
                       for p in (False, True)]

    pm_regions = {}
    for k in (17, 23):
        build = time_ms(lambda: blocked_codes_wide(b2, v2, k), 3)
        fn, meta = make_wide_pm_pipeline(k, block=BLOCK, cand_blocks=cand,
                                         device=dev)
        outs = []

        def finish_pm(host):
            out = pm_finish.unpack_pm_outputs(host, n, meta)
            outs.append(out)
            return pm_finish.finish_pm_spans(out, n, meta, THR, MIN_W, MIN_S)

        label = f"wide pm k={k} n={n:,} block={BLOCK} cand={cand}"
        runs = kernels_run(fn, finish_pm, label, (1, 0))
        out = outs[0]
        if out["total"] != valid_kmers(nbases, k):
            raise AssertionError(f"wide pm k={k}: total {out['total']}")
        log(f"  wide pm k={k}: t_list {out['t_list']}, "
            f"{out['list_count']:,} listed runs (cap {meta['list_cap']}), "
            f"{meta['nbins']} value bins, total {out['total']:,}; code build "
            f"{build:.2f} ms (CUDA events) [{card}]")
        compare_runs(label, card, n, runs)
        pm_regions[k] = runs[0][1].regions

    k = 17
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spectrum = device_sparse_spectrum(nbases_dev, k, dev)
    t_spec = time.perf_counter() - t0
    if spectrum[2] != valid_kmers(nbases, k) or \
            spectrum[1].sum() != spectrum[2]:
        raise AssertionError(f"device_sparse_spectrum k={k}: total "
                             f"{spectrum[2]}")
    log(f"  device_sparse_spectrum k={k}: {spectrum[0].size:,} distinct of "
        f"{spectrum[2]:,} k-mers in {t_spec:.3f} s (to the host), peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB [{card}]")
    fn = make_wide_span_pipeline(k, block=BLOCK, cand_blocks=cand,
                                 device=dev)

    def finish_sort(host):
        out = finish.unpack_wide_outputs(host, n, BLOCK, cand)
        return finish.finish_wide_spans(out, n, k, THR, MIN_W, MIN_S,
                                        spectrum, block=BLOCK)

    label = f"wide sort k={k} n={n:,} block={BLOCK} cand={cand}"
    runs = kernels_run(fn, finish_sort, label, (2, 1))
    compare_runs(label, card, n, runs)
    if runs[0][1].regions != pm_regions[k]:
        raise AssertionError("wide sort route: regions differ from the pm "
                             "route's")
    log(f"  wide sort k={k}: regions equal to the pm route's bit for bit")
    del b2, v2, nbases_dev
    torch.cuda.empty_cache()

    seq = PackedSeq(bases=nbases & 3, valid=nbases < 4)
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    api.exact_fallbacks = 0
    t0 = time.perf_counter()
    res = api.kmer_wide_regions(seq, k, MIN_W, MIN_S, thr=THR, device=dev)
    wall = time.perf_counter() - t0
    if histogram.histogram_launches < 1:
        raise AssertionError("kmer_wide_regions skipped the histogram")
    launches["histogram"] += histogram.histogram_launches
    got = [(int(r["seq_id"]), int(r["beg"]), int(r["end"]), float(r["score"]))
           for r in res.regions]
    if res.n_words != valid_kmers(nbases, k) or got != pm_regions[k] or \
            not np.array_equal(res.spectrum_codes, spectrum[0]) or \
            not np.array_equal(res.spectrum_counts, spectrum[1]):
        raise AssertionError("kmer_wide_regions k=17 differs from the "
                             "pipelines")
    log(f"  kmer_wide_regions k={k} over {n:,} bases: {len(got)} regions, "
        f"n_words {res.n_words:,}, {res.spectrum_codes.size:,} distinct, "
        f"equal to the pipeline and the sparse spectrum; wall {wall:.3f} s, "
        f"{api.exact_fallbacks} reruns, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    for label, x in (("its first 2^20 bases", PackedSeq(
            bases=nbases[:1 << 20] & 3, valid=nbases[:1 << 20] < 4)),
            ("the golden genome", golden_genome())):
        res = api.kmer_wide_regions(x, k, MIN_W, MIN_S, thr=THR, device=dev)
        ucodes, ucounts, nw = count_spectrum_sparse(x, k)
        want = find_regions(x, 0, MIN_W, MIN_S, SparseRanks(ucodes, ucounts),
                            k, THR)
        got = [(int(r["seq_id"]), int(r["beg"]), int(r["end"]),
                float(r["score"])) for r in res.regions]
        if got != want or not got or res.n_words != nw or \
                not np.array_equal(res.spectrum_codes, ucodes):
            raise AssertionError(f"kmer_wide_regions k={k} over {label}: "
                                 f"{got[:3]} != oracle {want[:3]}")
        log(f"  kmer_wide_regions k={k} over {label}: {len(got)} regions, "
            f"first {got[0][1:]}, == oracle with SparseRanks")
    return launches, pm_regions[17]


def cli_phase(dev) -> None:
    """Phases 12 and 13: the port's CLI on the golden FASTA, stream, spans
    and wide, with --device cuda, equal to its output with --device cpu."""
    import io
    import tempfile

    from kmer_spans_tpu_torch import cli
    from kmer_spans_tpu_torch.io.fasta import write_fasta
    from kmer_spans_tpu_torch.ops import _build
    from kmer_spans_tpu_torch.oracle import golden_genome

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        fa = f"{tmp}/golden.fa"
        write_fasta(fa, [("chr1", golden_genome())])
        for argv in (["stream", fa, "-k", "8", "--chunk", "32768",
                      "--block", "512", "--cand-blocks", "32"],
                     ["stream", fa, "-k", "12", "--chunk", "65536"],
                     ["spans", fa, "-k", "8"],
                     ["wide", fa, "-k", "17"]):
            outs = []
            for device in (str(dev), "cpu"):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(io.StringIO()):
                    cli.main(argv + ["--device", device])
                outs.append(buf.getvalue())
            lines = outs[0].splitlines()
            if outs[0] != outs[1] or len(lines) != 4:
                raise AssertionError(f"cli {' '.join(argv[:1] + argv[2:])}: "
                                     f"card {outs[0]!r} != cpu {outs[1]!r}")
            log(f"  cli {argv[0]} {' '.join(argv[2:])} --device {dev}: "
                f"{lines[1:]}, equal to --device cpu")


MESH_SMALL = 1 << 24


@contextlib.contextmanager
def kernel_inputs():
    """While on, every K3 and K4 call through its module (histogram.
    histogram, gather.word_gather) keeps its positional arguments; yields
    the list of (name, args)."""
    from kmer_spans_tpu_torch.ops import gather, histogram

    seen, saved = [], (histogram.histogram, gather.word_gather)

    def keep(name, fn):
        def call(*a, **kw):
            seen.append((name, a))
            return fn(*a, **kw)
        return call

    histogram.histogram = keep("histogram", saved[0])
    gather.word_gather = keep("word_gather", saved[1])
    try:
        yield seen
    finally:
        histogram.histogram, gather.word_gather = saved


def mesh_steps(grp, nbases_dev, block: int, cand: int, thr=THR):
    """The device steps of phase 14 on this rank's shard: (k = 13 sharded
    count, wide rank step and scan; k = 17 wide scan), each a function of
    no argument returning its outputs."""
    from kmer_spans_tpu_torch.parallel.sharded import make_sharded_count_step
    from kmer_spans_tpu_torch.parallel.sharded_scan import (
        make_sharded_rank_step_wide,
        make_sharded_scan_step,
    )
    from kmer_spans_tpu_torch.parallel.wide_scan import make_wide_sharded_scan

    bases, valid = nbases_dev & 3, nbases_dev < 4
    cstep = make_sharded_count_step(grp, 13, block=block)
    # the AG islands' two 13-mers occur about 1500 times an island, 81,000
    # times at 2^28 bases: past the default vmax (2^14), where the rank
    # step clips and flags them and its caller retries with a larger vmax
    rstep = make_sharded_rank_step_wide(grp, 13, vmax=1 << 17)
    sstep = make_sharded_scan_step(grp, 13, block=block, cand_blocks=cand)
    wstep = make_wide_sharded_scan(grp, 17, block=block, cand_blocks=cand)

    def sharded():
        counts, c_over = cstep(bases, valid)
        mass, clip, vhist = rstep(counts)
        del counts
        out = sstep(bases, valid, mass, int(vhist.sum()), thr)
        return out + (c_over, clip, vhist)

    return sharded, lambda: wstep(bases, valid, thr)


def time_mesh_shapes(dev, grp, nbases_dev) -> tuple[list, list]:
    """Phase 6 at the multi-device paths' shapes, at world size 1 on the
    genome: K3 on the k = 13 shard count's received codes (4^13 bins, the
    global form; half the 2 * n slots of the default bucket cap empty),
    on the wide k = 17 scan's merged runs by value (4096 bins) and by
    value and high byte (65536 bins), one hot bin in both; K4 on the wide
    scan's table (8704 words, padded to 16384).  The inputs are the ones
    the steps pass, kept from one run.  Returns (K3 shapes, K4 shapes)."""
    import torch

    from kmer_spans_tpu_torch.ops import gather

    n = nbases_dev.shape[0]
    sharded, wide = mesh_steps(grp, nbases_dev, BLOCK, cand_blocks(n))
    with kernel_inputs() as seen:
        sharded()
        wide()
    torch.cuda.synchronize()
    (_, count), (_, by_v), (_, by_vh), (_, k4) = seen
    del seen
    k3 = [hist_entry("k = 13 shard count, world 1, received codes", *count),
          hist_entry("wide k = 17 scan, merged runs by value", *by_v,
                     kind="repeats"),
          hist_entry("wide k = 17 scan, merged runs by value and high byte",
                     *by_vh, kind="repeats")]
    words, entry, thr_q = k4
    if max_abs_err(gather.word_gather(words, entry, thr_q),
                   gather.word_gather_plain(words, entry, thr_q)):
        raise AssertionError("word_gather differs from plain at the wide "
                             "sharded scan's entries")
    t = in_turns(f"word_gather (wide k = 17 sharded scan, {entry.numel():,} "
                 f"entries, {words.numel()} words)",
                 lambda: gather.word_gather(words, entry, thr_q),
                 lambda: gather.word_gather_plain(words, entry, thr_q))
    m = entry.numel()
    k4 = shape_entry(f"wide k = 17 sharded scan, {words.numel()} words", t,
                     bound(m * 8 + words.numel() * 4, m))
    return k3, [k4]


def maxplus_f64(s, scored):
    """The recurrence's running score from 0 over s in f64: the (a, b)
    pairs composed by doubling (ops/scan.py scan_pairs), an independent
    form of what the mesh step computes in closed form."""
    import torch

    from kmer_spans_tpu_torch.ops.scan import scan_pairs, score_elements

    A, B = scan_pairs(*score_elements(s.to(torch.float64), scored))
    return torch.maximum(A, B)


def timed_step(label, fn, plain: bool, card: str):
    """One device step with the kernels or the plain versions: (outputs,
    K3 launches, K4 launches), its wall (to a synchronize) and peak
    device memory logged."""
    import torch

    from kmer_spans_tpu_torch.ops import gather, histogram

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    with plain_versions(plain):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"  {label}, {'plain versions' if plain else 'kernels'}: device step "
        f"{wall * 1e3:.1f} ms, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card}]")
    return out, histogram.histogram_launches, gather.launches


def equal_outputs(label, got, want) -> None:
    import torch

    if len(got) != len(want) or not all(
            torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{label}: outputs differ from the plain run")


def host(out) -> tuple:
    return tuple(o.cpu().numpy() for o in out)


def mesh_phase(dev, grp, nbases: np.ndarray, pm13: list, wide17: list,
               seed: int, card: str) -> dict:
    """Phase 14: the multi-device paths at world size 1 under NCCL on the
    genome, each device step with the kernels and again with the plain
    versions (outputs equal): make_pipeline_step at k = 8 (counts equal to
    api.kmer_counts, scored equal to the single-device mask, S within 2e-4
    of an f64 recurrence over the same s), the k = 13 sharded scan (count,
    wide rank step, scan; regions equal to phase 7's pm k = 13 regions,
    every island called) and the wide k = 17 sharded scan (the host finish
    once; regions equal to phase 13's); dryrun_multichip; then the
    2^24-base head of the genome through distributed_low_comp_regions
    (k = 13) and wide_low_comp_regions (k = 17) at world size 1 here and
    in two gloo ranks on this card (launch_local; both ranks' regions
    equal, and equal to world size 1).  Returns K3's and K4's launches in
    the kernels' runs."""
    import tempfile

    import torch

    from kmer_spans_tpu_torch import api
    from kmer_spans_tpu_torch.encoding import PackedSeq
    from kmer_spans_tpu_torch.ops import _build
    from kmer_spans_tpu_torch.ops.blocked import blocked_codes, blocked_scored
    from kmer_spans_tpu_torch.ops.convert import to_tensor
    from kmer_spans_tpu_torch.parallel.multihost import (
        distributed_low_comp_regions,
        dryrun_multichip,
        launch_local,
    )
    from kmer_spans_tpu_torch.parallel.pipeline import (
        _rank_mass,
        make_pipeline_step,
    )
    from kmer_spans_tpu_torch.parallel.sharded_scan import (
        finish_sharded_spans,
    )
    from kmer_spans_tpu_torch.parallel.wide_scan import (
        finish_wide_sharded,
        wide_low_comp_regions,
    )

    n = nbases.shape[0]
    cand = cand_blocks(n)
    launches = {"histogram": 0, "word_gather": 0}
    nbases_dev = to_tensor(nbases, dev)
    bases, valid = nbases_dev & 3, nbases_dev < 4

    # --- the k = 8 mesh step -------------------------------------------
    step = make_pipeline_step(grp, 8, block=BLOCK)
    label = f"mesh step k=8 world 1 n={n:,} block={BLOCK}"
    got, n_k3, n_k4 = timed_step(label, lambda: step(bases, valid, THR), False,
                                 card)
    if (n_k3, n_k4) != (1, 0):
        raise AssertionError(f"{label}: launches (K3, K4) {(n_k3, n_k4)}")
    launches["histogram"] += n_k3
    equal_outputs(label, got, timed_step(label, lambda: step(
        bases, valid, THR), True, card)[0])
    counts, S, scored = got
    want = api.kmer_counts(PackedSeq(bases=nbases & 3, valid=nbases < 4), 8,
                           device=dev).counts
    if not np.array_equal(counts.cpu().numpy(), want):
        raise AssertionError(f"{label}: counts differ from kmer_counts")
    b2, v2 = bases.reshape(-1, BLOCK), valid.reshape(-1, BLOCK)
    code, kv = blocked_codes(b2, v2, 8)
    if not torch.equal(scored, blocked_scored(v2, kv).reshape(-1)):
        raise AssertionError(f"{label}: scored differs from the "
                             "single-device mask")
    total = counts.sum().to(torch.float32)
    s = (_rank_mass(counts)[torch.where(kv, code, 0).reshape(-1)].to(
        torch.float32) - torch.tensor(THR, device=dev) * total) / total
    del code, kv
    t0 = time.perf_counter()
    ref = maxplus_f64(s, scored)
    torch.cuda.synchronize()
    err = (S.to(torch.float64) - ref).abs()
    bad = int((err > 2e-4 + 2e-4 * ref.abs()).sum())
    log(f"  {label}: counts equal to kmer_counts, scored exact, S max |err| "
        f"{float(err.max()):.3e} against the f64 doubling scan ({bad} beyond "
        f"2e-4; the scan {time.perf_counter() - t0:.2f} s), max S "
        f"{float(ref.max()):.1f}")
    if bad:
        raise AssertionError(f"{label}: S beyond 2e-4 of the f64 recurrence")
    del got, counts, S, scored, s, ref, err, step

    # --- the k = 13 sharded scan and the wide k = 17 scan ----------------
    sharded, wide = mesh_steps(grp, nbases_dev, BLOCK, cand)
    for label, fn, want_launch in (
            (f"sharded k=13 world 1 n={n:,} cand={cand}", sharded, (1, 0)),
            (f"wide sharded k=17 world 1 n={n:,} cand={cand}", wide, (2, 1))):
        got, n_k3, n_k4 = timed_step(label, fn, False, card)
        if (n_k3, n_k4) != want_launch:
            raise AssertionError(f"{label}: launches (K3, K4) "
                                 f"{(n_k3, n_k4)}, expected {want_launch}")
        launches["histogram"] += n_k3
        launches["word_gather"] += n_k4
        equal_outputs(label, got, timed_step(label, fn, True, card)[0])
        out = host(got)
        del got
        t0 = time.perf_counter()
        if fn is sharded:
            if bool(out[8]) or bool(out[9]):
                raise AssertionError(f"{label}: bucket overflow {out[8]}, "
                                     f"value clip {out[9]}")
            res = finish_sharded_spans(out[:8], n, int(out[10].sum()), THR,
                                       MIN_W, MIN_S, BLOCK,
                                       value_hist=out[10])
            want = pm13
        else:
            res = finish_wide_sharded(out, n, 17, THR, MIN_W, MIN_S,
                                      (out[9], out[10], int(out[7])), BLOCK)
            want = wide17
        t_fin = time.perf_counter() - t0
        hit = check_islands(res, n)
        if res.overflow or res.regions != want:
            raise AssertionError(f"{label}: regions differ from the single-"
                                 f"device path's, or overflow {res.overflow}")
        log(f"  {label}: {len(res.regions)} regions, all {hit} islands "
            f"called, equal to the single-device path's bit for bit; host "
            f"finish {t_fin:.3f} s")
    del nbases_dev, bases, valid, b2, v2
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dryrun_multichip(grp)
    log(f"  dryrun_multichip at world 1: equal to the oracle "
        f"({time.perf_counter() - t0:.2f} s)")

    # --- the 2^24 head: world 1 here, two gloo ranks on this card --------
    head = nbases[:MESH_SMALL]
    c_small = cand_blocks(MESH_SMALL)
    t0 = time.perf_counter()
    one = mesh_regions(grp, head, c_small)
    log(f"  2^24 head, world 1 (NCCL): k=13 {len(one[0])} regions, k=17 "
        f"{len(one[1])} regions, {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        launch_local([sys.executable, __file__, "--mesh-rank", tmp,
                      "--seed", str(seed)], 2, timeout=600)
        wall = time.perf_counter() - t0
        ranks = [json.loads(open(f"{tmp}/rank{r}.json").read())
                 for r in range(2)]
    if one[2] != [False] * 4 or not one[0] or not one[1]:
        raise AssertionError(f"2^24 head, world 1: flags {one[2]}")
    for r, got in enumerate(ranks):
        log(f"  2^24 head, rank {r} of 2 (gloo, one card): "
            f"{got['seconds']:.2f} s in the rank, peak device memory "
            f"{got['peak_gib']:.2f} GiB")
        regs = ([tuple(x) for x in got["k13"]], [tuple(x) for x in got["k17"]])
        if got["flags"] != [False] * 4 or regs != one[:2]:
            raise AssertionError(f"2^24 head, rank {r} of 2: regions differ "
                                 f"from world 1, or flags {got['flags']}")
    log(f"  2^24 head, two gloo ranks on one card: both ranks' regions "
        f"equal, and equal to world 1 (wall {wall:.2f} s with the ranks' "
        "start)")
    return launches


def mesh_regions(grp, head: np.ndarray, cand: int):
    """The 2^24 head through distributed_low_comp_regions (k = 13) and
    wide_low_comp_regions (k = 17) over ``grp`` (C a rank: cand / world):
    (k = 13 regions, k = 17 regions, their fallback and overflow flags)."""
    from kmer_spans_tpu_torch.parallel.multihost import (
        distributed_low_comp_regions,
    )
    from kmer_spans_tpu_torch.parallel.wide_scan import wide_low_comp_regions

    c = cand // grp.size
    r13 = distributed_low_comp_regions(head, 13, MIN_W, MIN_S, thr=THR,
                                       block=BLOCK, cand_blocks=c,
                                       device=grp.device)
    r17 = wide_low_comp_regions(grp, head, 17, MIN_W, MIN_S, thr=THR,
                                block=BLOCK, cand_blocks=c)
    def plain(regions):
        return [(int(a), int(b), int(c), float(d)) for a, b, c, d in regions]

    return (plain(r13.regions), plain(r17.regions),
            [r13.fallback, r13.overflow, r17.fallback, r17.overflow])


def mesh_rank_main(store_dir: str, seed: int) -> int:
    """One of phase 14's two gloo ranks on the card: the 2^24 head through
    mesh_regions, written to store_dir/rank{r}.json."""
    import torch
    import torch.distributed as dist

    from kmer_spans_tpu_torch.parallel.multihost import (
        global_data_mesh,
        initialize,
    )

    t0 = time.perf_counter()
    initialize(f"file://{store_dir}/store", device="cuda", backend="gloo")
    grp = global_data_mesh("cuda")
    head = make_genome(MESH_SMALL, seed)
    r13, r17, flags = mesh_regions(grp, head, cand_blocks(MESH_SMALL))
    torch.cuda.synchronize()
    with open(f"{store_dir}/rank{grp.rank}.json", "w") as f:
        json.dump({"k13": r13, "k17": r17, "flags": flags,
                   "seconds": time.perf_counter() - t0,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30},
                  f)
    dist.destroy_process_group()
    return 0


def cpu_model() -> str:
    """The host CPU: its model name (/proc/cpuinfo, else lscpu), its
    architecture and the logical cores this process may use."""
    import os
    import platform

    name = None
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.lower().startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if not name:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=10).stdout
        except (OSError, subprocess.SubprocessError):
            out = ""
        for line in out.splitlines():
            if line.lower().startswith("model name"):
                name = line.split(":", 1)[1].strip()
                break
    return (f"{name or 'CPU model not reported'} ({platform.machine()}), "
            f"{len(os.sched_getaffinity(0))} logical cores")


def sequential_scan_f64(s: np.ndarray, scored: np.ndarray) -> np.ndarray:
    """The recurrence S_i = max(S_{i-1} + s_i, 0), reset to 0 at unscored
    positions, one position at a time in f64."""
    out = np.zeros(s.shape[0])
    prev = 0.0
    for i, (v, m) in enumerate(zip(s.tolist(), scored.tolist())):
        prev = max(prev + v, 0.0) if m else 0.0
        out[i] = prev
    return out


def cpu_backends_phase(dev, nbases: np.ndarray, ph9: dict,
                       card: str) -> None:
    """Phase 15: the api's CPU backends beside the card.  backend="native"
    (the host C++ library) on the whole genome: kmer_counts at k = 8 and
    12 and kmer_low_comp_regions at k = 8 and 12, and kmer_regions at
    k = 8 with phase 9's CpG-style table (min_score 20), each equal to
    phase 9's kernels' result (counts, regions with f64 ==, scan counts),
    its wall beside that run's; backend="host" (the sequential oracle) at
    k = 8 on the golden genome and on the genome's first 2^22 bases, and
    kmer_wide_regions(backend="native") at k = 17 on that head, each
    equal to the card's run on the same input; then the dense span scan
    on the card over the 2^28 f32 scores of the k = 8 exact step
    (w_rank - thr at device_codes_scored's codes), against
    span_scan_blocked and a sequential f64 loop on its first 2^20
    positions and on two 2^22-position windows deep in the genome, each
    from an unscored position (rtol = atol = 2e-4, the mesh rule)."""
    import torch

    from kmer_spans_tpu_torch import api
    from kmer_spans_tpu_torch.encoding import PackedSeq
    from kmer_spans_tpu_torch.ops.scan import span_scan, span_scan_blocked
    from kmer_spans_tpu_torch.parallel.device import device_codes_scored
    from kmer_spans_tpu_torch.utils.testgen import golden_genome

    cpu = cpu_model()
    log(f"  host: {cpu}; card: {card}")
    seq = PackedSeq(bases=nbases & 3, valid=nbases < 4)

    def timed(call):
        t0 = time.perf_counter()
        res = call()
        return res, time.perf_counter() - t0

    def same(label, got, want, fields):
        for f in fields:
            if not np.array_equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"{label}: {f} differs from the "
                                     "card's")

    def beside(label, got, wall, key, fields, what):
        want, card_wall = ph9[key]
        same(label, got, want, fields)
        log(f"  {label}: wall {wall:.3f} s [{cpu}], the card's "
            f"{card_wall:.3f} s [{card}]; {what}, equal to the card's")

    for k in (8, 12):
        got, wall = timed(lambda: api.kmer_counts(seq, k, backend="native"))
        beside(f"kmer_counts k={k} native", got, wall, f"kmer_counts k={k}",
               ("n", "counts", "f"), f"n = {int(got.n):,}")
    for k in (8, 12):
        got, wall = timed(lambda: api.kmer_low_comp_regions(
            seq, k, MIN_W, MIN_S, thr=THR, backend="native"))
        beside(f"kmer_low_comp_regions k={k} native", got, wall,
               f"kmer_low_comp_regions k={k} exact",
               ("n", "counts", "regions", "w_rank"),
               f"{len(got.regions)} regions (f64 scores ==)")
    got, wall = timed(lambda: api.kmer_regions(seq, 8, cpg_table(), MIN_W,
                                               MIN_S, backend="native"))
    beside("kmer_regions k=8 native", got, wall,
           f"kmer_regions k=8 min_score={MIN_S}", ("n", "counts", "regions"),
           f"{len(got.regions)} regions, scan counts sum "
           f"{int(got.counts.sum()):,}")

    head = nbases[:1 << 22]
    head_seq = PackedSeq(bases=head & 3, valid=head < 4)
    cases = [
        ("golden genome", "host", golden_genome(),
         lambda s, **kw: api.kmer_low_comp_regions(s, 8, MIN_W, MIN_S,
                                                   thr=THR, **kw),
         ("n", "counts", "regions", "w_rank")),
        ("2^22 head", "host", head_seq,
         lambda s, **kw: api.kmer_low_comp_regions(s, 8, MIN_W, MIN_S,
                                                   thr=THR, **kw),
         ("n", "counts", "regions", "w_rank")),
        ("2^22 head", "native", head_seq,
         lambda s, **kw: api.kmer_wide_regions(s, 17, MIN_W, MIN_S,
                                               thr=THR, **kw),
         ("regions", "spectrum_codes", "spectrum_counts", "n_words")),
    ]
    for where, backend, s, call, fields in cases:
        name = "kmer_wide_regions k=17" if backend == "native" else \
            "kmer_low_comp_regions k=8"
        want, card_wall = timed(lambda: call(s, device=dev))
        got, wall = timed(lambda: call(s, backend=backend))
        same(f"{name} {backend} on the {where}", got, want, fields)
        if len(got.regions) < 1:
            raise AssertionError(f"{name} {backend} on the {where}: no "
                                 "region")
        log(f"  {name} {backend} on the {where}: wall {wall:.3f} s [{cpu}], "
            f"the card's {card_wall:.3f} s [{card}]; {len(got.regions)} "
            "regions, equal to the card's")

    # the dense span scan over the k = 8 exact step's scores
    t0 = time.perf_counter()
    codes, scored = device_codes_scored(seq, 8, dev)
    w_rank = torch.from_numpy(ph9["kmer_low_comp_regions k=8 exact"][0]
                              .w_rank).to(dev)
    codes_t = torch.from_numpy(codes).to(dev)
    scored_t = torch.from_numpy(scored).to(dev)
    s = (w_rank[codes_t] - THR).to(torch.float32)
    del codes, codes_t
    torch.cuda.synchronize()
    prep = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    S, (A, B) = span_scan(s, scored_t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    Sb = span_scan_blocked(s, scored_t, 4096)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    n = s.shape[0]
    if S.shape != (n,) or S.dtype != torch.float32 or \
            not torch.isfinite(S).all() or (S < 0).any():
        raise AssertionError("span_scan: S is not finite, non-negative f32 "
                             f"of shape ({n},)")
    if (S[~scored_t] != 0).any():
        raise AssertionError("span_scan: S is not 0 at unscored positions")
    if not torch.allclose(S, Sb, rtol=2e-4, atol=2e-4):
        raise AssertionError("span_scan differs from span_scan_blocked")
    # the sequential f64 loop on the head and on two windows deep in the
    # genome, each starting at an unscored position (S = 0 there, so the
    # loop needs no carry): the cross-row composition gets a witness that
    # shares no code with span_scan_blocked
    h = 1 << 20
    w = min(1 << 22, n // 4)
    unscored = np.flatnonzero(~scored[w:n - w]) + w
    if not len(unscored):
        raise AssertionError("span_scan: no unscored position to start a "
                             "deep window at")
    windows = [(0, h),
               (int(unscored[np.searchsorted(unscored, n // 2)
                             .clip(max=len(unscored) - 1)]), w),
               (int(unscored[-1]), w)]
    seq_err = {}
    for start, size in windows:
        want = sequential_scan_f64(
            s[start:start + size].double().cpu().numpy(),
            scored[start:start + size])
        got = S[start:start + size].double().cpu().numpy()
        if not np.allclose(got, want, rtol=2e-4, atol=2e-4):
            raise AssertionError(
                f"span_scan differs from the sequential f64 loop on "
                f"[{start:,}, {start + size:,})")
        seq_err[start] = (size, float(np.abs(got - want).max()),
                          float(want.max()))
    if float(S[-1]) != float(torch.maximum(A, B)):
        raise AssertionError("span_scan: the total transform from 0 is not "
                             "the last S")
    log(f"  span_scan k=8 n={n:,} f32: {wall * 1e3:.1f} ms (peak device "
        f"memory {peak:.2f} GiB), span_scan_blocked(block 4096) "
        f"{wall_b * 1e3:.1f} ms, codes and scores {prep * 1e3:.1f} ms "
        f"[{card}]; max S {float(S.max()):.3f}, max |S - blocked| "
        f"{float((S - Sb).abs().max()):.3g}; max |S - sequential f64| "
        + ", ".join(f"{e:.3g} on [{a:,}, {a + z:,}) (max S {m:.3f})"
                    for a, (z, e, m) in seq_err.items()))


def tied_phase(dev, nbases: np.ndarray, seed: int, card: str) -> int:
    """Phase 16: the host span replay (spans/extract.py) on tied decimal
    tables.  The genome's first 2^22 bases through api.kmer_regions at
    k = 2 and k = 8, min_width 20, min_score 2.0, each table drawn from a
    seeded rng in steps of 0.1 from -0.55 to 0.45 (whose sums return to 0
    exactly in the reals, and in f64 to 0 or a few ulps above it; at
    seed 0 the k = 2 table is tests/test_torch_extract.py's), with
    the kernels and again with the plain versions on the card, the two
    equal, and equal to backend="native" (the host library's sequential
    C loop): n, scan counts and regions with f64 ==.  Logs the region
    counts, the host finish and the walls.  Returns K3's launches in the
    kernels' runs."""
    from kmer_spans_tpu_torch import api
    from kmer_spans_tpu_torch.encoding import PackedSeq
    from kmer_spans_tpu_torch.ops import histogram

    head = nbases[:1 << 22]
    seq = PackedSeq(bases=head & 3, valid=head < 4)
    rng = np.random.default_rng(seed + 7)
    # the bases that tests/test_torch_extract.py draws first: at seed 0
    # the k = 2 table is that test's (mean 0, a walk with no drift)
    rng.integers(0, 4, size=1 << 20)
    cpu = cpu_model()
    launches = 0
    for k in (2, 8):
        table = np.round(rng.choice(np.arange(-5, 6), size=4 ** k) / 10.0
                         - 0.05, 2)
        label = f"kmer_regions k={k} tied table"
        runs = []
        for plain in (False, True):
            zero_launch_counts()
            with plain_versions(plain), api_stages() as st:
                t0 = time.perf_counter()
                res = api.kmer_regions(seq, k, table, 20, 2.0, device=dev)
                wall = time.perf_counter() - t0
            if not plain:
                if histogram.histogram_launches < 1:
                    raise AssertionError(f"{label}: the exact path skipped "
                                         "the histogram")
                launches += histogram.histogram_launches
            log(f"  {label}, {'plain versions' if plain else 'kernels'}: "
                f"wall {wall:.3f} s; device step {st['device'] * 1e3:.1f} "
                f"ms, host finish {st['finish'] * 1e3:.1f} ms (of which "
                f"{st['batches']} batched pulls {st['batch_s'] * 1e3:.1f} "
                f"ms) [{card}; host {cpu}]")
            runs.append(res)
        t0 = time.perf_counter()
        want = api.kmer_regions(seq, k, table, 20, 2.0, backend="native")
        wall = time.perf_counter() - t0
        for f in ("n", "counts", "regions"):
            if not np.array_equal(getattr(runs[0], f), getattr(runs[1], f)):
                raise AssertionError(f"{label}: {f} differs from the plain "
                                     "run")
            if not np.array_equal(getattr(runs[0], f), getattr(want, f)):
                raise AssertionError(f"{label}: {f} differs from "
                                     "backend='native'")
        if len(want.regions) < 1:
            raise AssertionError(f"{label}: no region")
        log(f"  {label}: {len(want.regions)} regions, scan counts sum "
            f"{int(want.counts.sum()):,}, equal to the plain run and to "
            f"backend='native' (f64 scores ==; native wall {wall:.3f} s "
            f"[{cpu}])")
    return launches


def world_one(dev):
    """A process group of this process alone on the card: NCCL, a file
    store in a temporary directory of the build directory.  Returns its
    DataGroup and a function that destroys the group and the directory."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from kmer_spans_tpu_torch.ops import _build
    from kmer_spans_tpu_torch.parallel.multihost import (
        global_data_mesh,
        initialize,
    )

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    initialize(f"file://{tmp}/store", world_size=1, rank=0, device=dev)

    def close():
        dist.destroy_process_group()
        shutil.rmtree(tmp)

    return global_data_mesh(dev), close


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bases", type=int, default=1 << 28)
    ap.add_argument("--mesh-rank", metavar="DIR",
                    help="run as one of phase 14's two gloo ranks (launched "
                    "by phase 14 itself), its store and output in DIR")
    args = ap.parse_args(argv)
    if args.bases % BLOCK:
        ap.error(f"--bases must be a multiple of {BLOCK}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.mesh_rank:
        return mesh_rank_main(args.mesh_rank, args.seed)
    dev = torch.device("cuda", 0)
    clock = {"t": time.perf_counter(), "name": None}

    def phase(name):
        """Log the last phase's wall time, then the next phase's name."""
        now = time.perf_counter()
        if clock["name"]:
            log(f"  ({clock['name']}: wall {now - clock['t']:.1f} s)")
        clock.update(t=now, name=name and name.split(":")[0])
        if name:
            log(name)

    phase("phase 1: device")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
        f"{'.'.join(map(str, torch.cuda.nccl.version()))}")

    phase("phase 2: build")
    from kmer_spans_tpu_torch.ops import _build
    from kmer_spans_tpu_torch.utils import native

    t0 = time.perf_counter()
    path, diag = _build.compile_library()
    _build.library()
    log(f"  built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in diag.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the host library did not build or load: "
                             f"{native.build()}")
    log(f"  host library {native.library_path().name} loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    phase("phase 3: kernels against their plain versions")
    err = check_kernels(dev, args.seed)
    nbases = make_genome(args.bases, args.seed)

    phase("phase 4: golden genome through the api")
    for k in (8, 9, 3, 12):
        golden_phase(dev, k)
    golden_phase(dev, 8, mode="exact")
    for scoring in ("threshold", "log2_median"):
        golden_spans_phase(dev, scoring)

    phase("phase 5: full-size k = 8 path")
    launches, nbases_dev = full_size_phase(dev, nbases, card)

    # one process group of this process alone (NCCL, world size 1) for
    # the multi-device paths' shapes in phase 6 and for phase 14
    grp, close_group = world_one(dev)
    phase("phase 6: kernel, plain and library times at the main paths' "
        f"shapes [{card}]")
    times = time_kernels(dev, nbases_dev)
    k3 = [time_histogram(dev, nbases_dev)]
    times["word_gather"], more = time_word_gather(dev, nbases_dev)
    k3 = more[:1] + k3 + more[1:]  # k = 9 count first: the JSON line's
    k3 += time_spectra(dev, nbases_dev)
    more, times["window_counts"] = time_window_k3(dev, nbases_dev, nbases)
    k3 += more
    err["window_counts"] = max(err["window_counts"],
                               *(e["err"] for e in times["window_counts"]
                                 ["shapes"]))
    k2, k4, more = time_stream_shapes(dev, nbases_dev)
    times["fused_screen_scan"]["shapes"].append(k2)
    times["word_gather"]["shapes"].append(k4)
    k3 += more
    torch.cuda.empty_cache()
    more, k4 = time_wide_shapes(dev, nbases_dev)
    times["word_gather"]["shapes"].append(k4)
    k3 += more
    torch.cuda.empty_cache()
    more, k4 = time_mesh_shapes(dev, grp, nbases_dev)
    times["word_gather"]["shapes"] += k4
    k3 += more
    times["histogram"] = main_entry(k3)
    err["histogram"] = max(err["histogram"], *(e["err"] for e in k3))
    torch.cuda.empty_cache()

    phase("phase 7: full-size k >= 10 pm path")
    launches["histogram"], pm_regions = pm_phase(dev, nbases_dev, card)

    phase("phase 8: full-size k = 9 class path and k = 12 sort path")
    for name, count in class_sort_phase(dev, nbases, nbases_dev,
                                        card).items():
        launches[name] = launches.get(name, 0) + count
    del nbases_dev
    torch.cuda.empty_cache()

    phase("phase 9: full-size exact api path")
    n_k3, exact, exact_results = exact_phase(dev, nbases, card)
    launches["histogram"] += n_k3
    torch.cuda.empty_cache()

    phase("phase 10: full-size windowed distributions")
    n_k3, launches["window_counts"] = window_phase(dev, nbases, card)
    launches["histogram"] += n_k3
    torch.cuda.empty_cache()

    phase("phase 11: full-size transition-score caller")
    lr_phase(dev, nbases, card)
    torch.cuda.empty_cache()

    phase("phase 12: the streaming pipeline and the CLI on the card")
    for name, count in stream_phase(dev, nbases, exact, args.seed,
                                    card).items():
        launches[name] += count
    torch.cuda.empty_cache()

    phase("phase 13: wide codes (16 <= k <= 23) and the CLI on the card")
    n_wide, wide17 = wide_phase(dev, nbases, card)
    for name, count in n_wide.items():
        launches[name] += count
    cli_phase(dev)
    torch.cuda.empty_cache()

    phase("phase 14: the multi-device paths on the card")
    for name, count in mesh_phase(dev, grp, nbases, pm_regions[13], wide17,
                                  args.seed, card).items():
        launches[name] += count

    phase("phase 15: the CPU backends beside the card")
    cpu_backends_phase(dev, nbases, exact_results, card)
    del exact_results

    phase("phase 16: the host span replay on tied decimal tables")
    launches["histogram"] += tied_phase(dev, nbases, args.seed, card)

    phase(None)
    close_group()
    if "jax" in sys.modules or any(
            m.split(".")[0] == "kmer_spans_tpu" for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")
    sources = {
        "count_aug": ("kmer_spans_tpu_torch/csrc/count_aug.cu",
                      "kmer_spans_tpu/ops/pallas_kernels.py:145"),
        "fused_screen_scan": ("kmer_spans_tpu_torch/csrc/screen_scan.cu",
                              "kmer_spans_tpu/ops/screen_scan.py:114"),
        "histogram": ("kmer_spans_tpu_torch/csrc/histogram.cu",
                      "kmer_spans_tpu/ops/pallas_kernels.py:83"),
        "word_gather": ("kmer_spans_tpu_torch/csrc/word_gather.cu",
                        "kmer_spans_tpu/ops/gather.py:184"),
        "window_counts": ("kmer_spans_tpu_torch/csrc/window_counts.cu",
                          "none: kmer_spans_tpu/ops/window.py window_group "
                          "is XLA cumsums"),
    }
    log(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name],
         **times[name]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
