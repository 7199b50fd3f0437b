"""K1 and K3: dense int32 histograms (CUDA kernels + plain versions).

K1 ``count_aug`` is the dense 4^k spectrum from aug words, counterpart of
``kmer_spans_tpu/ops/pallas_kernels.py`` pallas_count_aug; its kernel is
``csrc/count_aug.cu`` (over ``csrc/histogram.cuh``).  K3 ``histogram`` is
the dense histogram of ``values[valid]``, counterpart of pallas_histogram
(with ``count_spectrum`` for pallas_count_spectrum); its kernel is
``csrc/histogram.cu``, which reads ``values`` and ``valid`` itself: no
torch pass runs over them first, and nothing is copied.  Above 2^15 bins
it takes the cluster form (one read of the input), the sliced form (one
read per 2^15 bins) or the global form (one read, atomics into the output
in global memory) by the fixed rule ``histogram_form``.

The plain versions are torch.bincount.  A CPU tensor goes to the plain
version, a CUDA tensor to the kernel: there is no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches since the counts were last set to 0 (read by
#: chip_smoke.py to show that a run went through each kernel)
count_aug_launches = 0
histogram_launches = 0

#: int32 counters one CTA holds (csrc/histogram.cuh kHistBins)
SLICE_BINS = 1 << 15
#: the largest size at which K3 takes its cluster form
CLUSTER_MAX_BINS = 2 * SLICE_BINS
#: the largest size at which K3 takes a shared-memory form; the global
#: form above (histogram_form)
GLOBAL_ABOVE_BINS = 1 << 18
#: K3's forms, in the order of csrc/histogram.cu's Form
FORMS = ("sliced", "cluster", "global")


def cluster_form(size: int) -> bool:
    """Whether K3 takes its cluster form at ``size`` bins.

    Up to SLICE_BINS one CTA holds every counter and the question does not
    arise (False).  Above it the cluster form reads the input once but
    sends most adds to another SM's shared memory; the sliced form reads
    it once per SLICE_BINS counters, mostly from L2.  A fixed rule from
    the times on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md, K3): the
    cluster form up to two slices (the sort screen's 65536 bins: 0.489
    against 0.632 ms), the sliced form above (the 4^9 spectrum: 2.531
    against 3.224 ms).
    """
    return SLICE_BINS < size <= CLUSTER_MAX_BINS


def histogram_form(size: int) -> str:
    """K3's form at ``size`` bins: "cluster" where ``cluster_form``, the
    "global" form above GLOBAL_ABOVE_BINS, else "sliced" (one CTA's
    counters up to SLICE_BINS).

    The sliced form re-reads the input once per SLICE_BINS counters (512
    reads at the 4^12 spectrum); the global form reads it once and adds
    into the output in global memory.  A fixed rule from the times on an
    NVIDIA H100 80GB HBM3 at 700 W, the spectra of a 2^28-base genome
    (PERF.md, K3 forms), sliced / cluster / global in ms: 4^9 bins
    2.530 / 3.224 / 3.197, 4^10 bins 8.398 / 4.032 / 3.186, 4^12 bins
    125.3 / 20.99 / 12.21; the crossover lies between 2^18 and 2^20.
    """
    if cluster_form(size):
        return "cluster"
    return "global" if size > GLOBAL_ABOVE_BINS else "sliced"


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


def histogram_plain(values: torch.Tensor, valid: torch.Tensor,
                    size: int) -> torch.Tensor:
    """Plain PyTorch K3: int32 [size] counts of the valid values."""
    _check_values(values, valid, size)
    keep = valid & (values >= 0) & (values < size)
    return torch.bincount(values[keep], minlength=size).to(torch.int32)


def histogram_kernel(values: torch.Tensor, valid: torch.Tensor, size: int,
                     form: str) -> torch.Tensor:
    """Launch K3 on CUDA tensors in the given form, one of FORMS (counted
    by nobody: ``histogram`` counts its own launches).  The cluster form
    at or below SLICE_BINS bins is the sliced form."""
    _check_values(values, valid, size)
    if values.device.type != "cuda":
        raise ValueError(f"histogram: unsupported device {values.device}")
    if form not in FORMS:
        raise ValueError(f"histogram: unknown form {form!r}")
    counts = torch.zeros(size, dtype=torch.int32, device=values.device)
    lib = _build.library()
    with torch.cuda.device(values.device):
        props = torch.cuda.get_device_properties(values.device)
        err = lib.kst_histogram(
            ctypes.c_void_p(values.data_ptr()),
            ctypes.c_void_p(valid.data_ptr()), values.numel(), size,
            FORMS.index(form), ctypes.c_void_p(counts.data_ptr()),
            props.multi_processor_count,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, "kst_histogram")
    return counts


def histogram(values: torch.Tensor, valid: torch.Tensor,
              size: int) -> torch.Tensor:
    """Dense int32 [size] histogram of ``values`` where ``valid``.

    values: int32, any shape, contiguous; valid: bool, the same shape,
    contiguous.  A value counts at its bin when valid and 0 <= value <
    size, else nowhere; any size in [1, 2^31).  Exact int32 counts, equal
    to the reference's pallas_histogram wherever that one is defined
    (sizes that are multiples of 128; below 128 it is a scatter that wraps
    a negative value).
    """
    global histogram_launches
    _check_values(values, valid, size)
    if values.device.type == "cpu":
        return histogram_plain(values, valid, size)
    counts = histogram_kernel(values, valid, size, histogram_form(size))
    histogram_launches += 1
    return counts


def count_spectrum(codes: torch.Tensor, valid: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Dense int32 [4^k] spectrum from codes and their validity (K3)."""
    return histogram(codes, valid, 1 << (2 * k))
