"""K1 and K3: dense int32 histograms (CUDA kernels + plain versions).

K1 ``count_aug`` is the dense 4^k spectrum from aug words, counterpart of
``kmer_spans_tpu/ops/pallas_kernels.py`` pallas_count_aug; its kernel is
``csrc/count_aug.cu`` (over ``csrc/histogram.cuh``).  K3 ``histogram`` is
the dense histogram of ``values[valid]``, counterpart of pallas_histogram
(with ``count_spectrum`` for pallas_count_spectrum); its kernel is
``csrc/histogram.cu``, which reads ``values`` and ``valid`` itself: no
torch pass runs over them first, and nothing is copied.  Above 2^15 bins
it takes one of five forms (FORMS): sliced (one read per 2^15 bins),
cluster (one read, adds into other SMs' shared memory), cluster_merged
(the same, a warp's equal bins added once), global (one read, atomics
into the output in global memory) or partitioned (the values split by
their high bits into parts of 2^15 bins, each part counted in shared
memory; partition_plan), by the rule ``histogram_form``: the size, the
input's length and what the caller says it counts (``kind``).

The plain versions are torch.bincount.  A CPU tensor goes to the plain
version, a CUDA tensor to the kernel: there is no fallback between them.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

#: kernel launches since the counts were last set to 0 (read by
#: chip_smoke.py to show that a run went through each kernel); one K3
#: call counts once, though its partitioned form runs four CUDA kernels
#: a chunk of its walk
count_aug_launches = 0
histogram_launches = 0

#: int32 counters one CTA holds (csrc/histogram.cuh kHistBins): a slice of
#: the sliced and cluster forms, a part of the partitioned form
SLICE_BINS = 1 << 15
#: the largest size at which K3 takes its cluster form
CLUSTER_MAX_BINS = 2 * SLICE_BINS
#: the largest size the partitioned form takes (2^15 parts)
PARTITION_MAX_BINS = 1 << 30
#: the largest size at which histogram_form picks the merged cluster form
#: for repeats (the cohort windows' 154 * 3232 bins)
REPEATS_CLUSTER_BINS = 1 << 19
#: the largest size at which histogram_form picks the partitioned form
#: (4^14); the global form above
PARTITION_RULE_BINS = 1 << 28
#: up to this size (4^9) inputs shorter than PARTITION_MIN_N positions (a
#: stream chunk) keep the sliced form
SLICED_MAX_BINS = 1 << 18
PARTITION_MIN_N = 1 << 26
#: the most bytes of scratch the partitioned form holds at once; a longer
#: input is walked in chunks that add into the same output
PARTITION_SCRATCH_CAP = 1 << 30
#: K3's forms, in the order of csrc/histogram.cu's Form
FORMS = ("sliced", "cluster", "global", "partitioned", "cluster_merged")
#: what a caller counts (histogram's ``kind``): "dense", values spread over
#: the bins, neighbours unrelated (the spectra); "runs", run lengths at few
#: valid positions, most of them on a few small bins (the k = 12 sort
#: screen); "repeats", neighbouring values mostly equal (one hot bin: the
#: run lengths of k-mers that occur once, ops/sortscreen.py runs_kind; the
#: window counts)
KINDS = ("dense", "runs", "repeats")


def histogram_form(size: int, kind: str = "dense", n: int | None = None
                   ) -> str:
    """K3's form at ``size`` bins for ``n`` positions (None: a genome's
    worth, 2^28) of input of the given ``kind`` (KINDS).

    Up to SLICE_BINS one CTA holds every counter: "sliced".  Repeats take
    "cluster_merged" up to REPEATS_CLUSTER_BINS (a warp's equal values
    make one remote add).  Up to CLUSTER_MAX_BINS: "cluster" for sparse
    run lengths, "sliced" for dense input (its two L2-served reads beat
    the cluster's remote adds).  Then "partitioned" up to
    PARTITION_RULE_BINS, "global" above; but up to SLICED_MAX_BINS the
    sliced form keeps inputs shorter than PARTITION_MIN_N, where the
    partitioned form's fixed costs (four launches, a flush of 2^15
    counters a work item) outweigh the sliced form's re-reads.

    The rule rests on the times of every form at the main paths' shapes
    (chip_smoke.py phase 6; PERF.md section 6, K3) on an NVIDIA H100
    80GB HBM3 at 700 W, in ms, 2^28 positions unless
    stated: 4^8 dense sliced 0.714 (cluster 1.639, partitioned 1.948);
    65536 sparse runs cluster 0.467 (merged 0.552, sliced 0.614); 65536
    one hot bin merged 0.545 (sliced 0.614, cluster 3.833); the cohort's
    497,792 bins of window counts, 2^26 positions, merged 0.409
    (partitioned 0.655, global 0.762); 4^9 partitioned 2.053 (sliced
    2.426), but at a 2^25-position stream chunk sliced 0.316
    (partitioned 0.375); 4^10 partitioned 2.427 (global 3.188); 4^12
    partitioned 2.928 (global 12.188); 4^14 partitioned 12.481 (global
    20.280); 4^15 global 21.972 (partitioned 28.928).
    """
    if kind not in KINDS:
        raise ValueError(f"histogram: unknown kind {kind!r}")
    if size <= SLICE_BINS:
        return "sliced"
    if kind == "repeats" and size <= REPEATS_CLUSTER_BINS:
        return "cluster_merged"
    if size <= CLUSTER_MAX_BINS:
        return "cluster" if kind == "runs" else "sliced"
    if size <= SLICED_MAX_BINS and n is not None and n < PARTITION_MIN_N:
        return "sliced"
    return "partitioned" if size <= PARTITION_RULE_BINS else "global"


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """The partitioned form's launch plan for one input (partition_plan)."""

    parts: int          # P = ceil(size / SLICE_BINS)
    grid: int           # CTAs of passes A and B (one an SM)
    chunk: int          # positions one launch takes: the walk's step
    item_len: int       # values a work item of pass C holds at most
    max_items: int      # work items of one launch at most
    scratch_bytes: int  # places, item offsets, counter, uint16 bucket


def partition_plan(n: int, size: int, num_sms: int) -> PartitionPlan:
    """Plan K3's partitioned form over ``n`` positions and ``size`` bins on
    a card of ``num_sms`` SMs.

    Pass A counts each CTA's share of the input by part, a scan turns the
    counts into places, pass B writes each counted value's low 15 bits
    into its part's bucket (2 bytes a position at most), pass C counts the
    buckets in work items of at most ``item_len`` values, enough of them
    (8 an SM) that one hot part spreads over the card.  The scratch (int32
    [P * grid + 1] places, [P + 1] item offsets and a counter; from the
    next 16-byte boundary the bucket and 16 spare bytes, as pass C reads 8
    places at a time) stays within PARTITION_SCRATCH_CAP: a longer input
    goes in chunks of ``chunk`` positions (a multiple of 16, so each chunk
    keeps the alignment of the input's start).
    """
    if not 1 <= size <= PARTITION_MAX_BINS:
        raise ValueError(f"the partitioned form takes 1 to 2^30 bins, "
                         f"got {size}")
    cap = PARTITION_SCRATCH_CAP
    parts = -(-size // SLICE_BINS)
    grid = num_sms
    meta = -(-4 * (parts * grid + parts + 3) // 16) * 16
    room = min((cap - meta - 16) // 2, 1 << 30) // 16 * 16
    if room < 16:
        raise ValueError(f"a scratch cap of {cap} bytes holds no chunk")
    pieces = -(-n // room)  # equal chunks, each a multiple of 16
    chunk = max(1, n if pieces <= 1 else -(-n // (16 * pieces)) * 16)
    item_len = 1 << max(12, min(20, (chunk // (8 * num_sms)).bit_length()
                                - 1))
    return PartitionPlan(parts=parts, grid=grid, chunk=chunk,
                         item_len=item_len,
                         max_items=parts + -(-chunk // item_len),
                         scratch_bytes=meta + 2 * chunk + 16)


def _check_aug(aug: torch.Tensor, k: int) -> None:
    if not 4 <= k <= 8:
        raise ValueError(f"count_aug needs 4 <= k <= 8, got k={k}")
    if aug.dtype != torch.int32:
        raise TypeError(f"aug must be int32, got {aug.dtype}")
    if not aug.is_contiguous():
        raise ValueError("aug must be contiguous")


def count_aug_plain(aug: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch K1: int32 [4^k] counts of the valid aug codes."""
    _check_aug(aug, k)
    size = 1 << (2 * k)
    flat = aug.reshape(-1)
    code = flat & 0xFFFF
    keep = (((flat >> 16) & 1) == 1) & (code < size)
    return torch.bincount(code[keep], minlength=size).to(torch.int32)


def count_aug(aug: torch.Tensor, k: int) -> torch.Tensor:
    """Dense int32 [4^k] spectrum from aug words (any shape, contiguous).

    aug word: bit 16 = valid k-mer, bits 0..15 = its code; a word counts
    at its code when bit 16 is set and the code is below 4^k, else
    nowhere.  Exact int32 counts, equal to the reference's
    pallas_count_aug element for element.
    """
    global count_aug_launches
    _check_aug(aug, k)
    if aug.device.type == "cpu":
        return count_aug_plain(aug, k)
    if aug.device.type != "cuda":
        raise ValueError(f"count_aug: unsupported device {aug.device}")
    counts = torch.zeros(1 << (2 * k), dtype=torch.int32, device=aug.device)
    lib = _build.library()
    with torch.cuda.device(aug.device):
        props = torch.cuda.get_device_properties(aug.device)
        err = lib.kst_count_aug(
            ctypes.c_void_p(aug.data_ptr()), aug.numel(), k,
            ctypes.c_void_p(counts.data_ptr()), props.multi_processor_count,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, "kst_count_aug")
    count_aug_launches += 1
    return counts


def _check_values(values: torch.Tensor, valid: torch.Tensor,
                  size: int) -> None:
    if not 1 <= size < 1 << 31:
        raise ValueError(f"size must be in [1, 2^31), got {size}")
    if values.dtype != torch.int32:
        raise TypeError(f"values must be int32, got {values.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    if values.shape != valid.shape:
        raise ValueError(
            f"values {tuple(values.shape)} and valid {tuple(valid.shape)} "
            "differ in shape")
    if values.device != valid.device:
        raise ValueError(
            f"values are on {values.device}, valid on {valid.device}")
    if not (values.is_contiguous() and valid.is_contiguous()):
        raise ValueError("values and valid must be contiguous")


def histogram_plain(values: torch.Tensor, valid: torch.Tensor, size: int,
                    kind: str = "dense") -> torch.Tensor:
    """Plain PyTorch K3: int32 [size] counts of the valid values (``kind``
    as histogram's, which the counts do not depend on)."""
    _check_values(values, valid, size)
    keep = valid & (values >= 0) & (values < size)
    return torch.bincount(values[keep], minlength=size).to(torch.int32)


def histogram_kernel(values: torch.Tensor, valid: torch.Tensor, size: int,
                     form: str) -> torch.Tensor:
    """Launch K3 on CUDA tensors in the given form, one of FORMS (counted
    by nobody: ``histogram`` counts its own launches).  The cluster form
    at or below SLICE_BINS bins is the sliced form; the partitioned form
    takes at most PARTITION_MAX_BINS bins, and walks an input longer than
    its plan's chunk in chunks that add into one output."""
    _check_values(values, valid, size)
    if values.device.type != "cuda":
        raise ValueError(f"histogram: unsupported device {values.device}")
    if form not in FORMS:
        raise ValueError(f"histogram: unknown form {form!r}")
    counts = torch.zeros(size, dtype=torch.int32, device=values.device)
    lib = _build.library()
    with torch.cuda.device(values.device):
        num_sms = torch.cuda.get_device_properties(
            values.device).multi_processor_count
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        v, m = values.reshape(-1), valid.reshape(-1)
        n = v.numel()
        plan, scratch, step = None, None, max(n, 1)
        if form == "partitioned":
            plan = partition_plan(n, size, num_sms)
            scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8,
                                  device=values.device)
            step = plan.chunk
        for s in range(0, max(n, 1), step):
            e = min(s + step, n)
            err = lib.kst_histogram(
                ctypes.c_void_p(v[s:].data_ptr()),
                ctypes.c_void_p(m[s:].data_ptr()), e - s, size,
                FORMS.index(form), ctypes.c_void_p(counts.data_ptr()),
                ctypes.c_void_p(scratch.data_ptr() if plan else None),
                plan.scratch_bytes if plan else 0,
                plan.grid if plan else 0, plan.item_len if plan else 0,
                num_sms, stream)
            _build.check(err, "kst_histogram")
    return counts


def histogram(values: torch.Tensor, valid: torch.Tensor, size: int,
              kind: str = "dense") -> torch.Tensor:
    """Dense int32 [size] histogram of ``values`` where ``valid``.

    values: int32, any shape, contiguous; valid: bool, the same shape,
    contiguous.  A value counts at its bin when valid and 0 <= value <
    size, else nowhere; any size in [1, 2^31).  ``kind`` (one of KINDS)
    says what the values are, which picks the kernel's form on the card
    (histogram_form); the counts do not depend on it.  Exact int32
    counts, equal to the reference's pallas_histogram wherever that one is
    defined (sizes that are multiples of 128; below 128 it is a scatter
    that wraps a negative value).
    """
    global histogram_launches
    _check_values(values, valid, size)
    form = histogram_form(size, kind, values.numel())
    if values.device.type == "cpu":
        return histogram_plain(values, valid, size)
    counts = histogram_kernel(values, valid, size, form)
    histogram_launches += 1
    return counts


def count_spectrum(codes: torch.Tensor, valid: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Dense int32 [4^k] spectrum from codes and their validity (K3)."""
    return histogram(codes, valid, 1 << (2 * k))
