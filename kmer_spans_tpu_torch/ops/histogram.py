"""K1 and K3: dense int32 histograms (CUDA kernels + plain versions).

K1 ``count_aug`` is the dense 4^k spectrum from aug words, counterpart of
``kmer_spans_tpu/ops/pallas_kernels.py`` pallas_count_aug; its kernel is
``csrc/count_aug.cu``.  K3 ``histogram`` is the dense histogram of masked
values, counterpart of pallas_histogram (with ``count_spectrum`` for
pallas_count_spectrum); its kernel is ``csrc/histogram.cu``.  Both kernels
are ``csrc/histogram.cuh`` with a different decode, built by ops/_build.py.

K3 keeps the reference's masked-input contract: the wrapper masks in
torch first, ``where(valid, values, -1)`` (as pallas_kernels.py:101 does
outside its kernel), and the kernel reads that one int32 stream.

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


def _check_aug(aug: torch.Tensor, k: int) -> None:
    if not 4 <= k <= 8:
        raise ValueError(f"count_aug needs 4 <= k <= 8, got k={k}")
    if aug.dtype != torch.int32:
        raise TypeError(f"aug must be int32, got {aug.dtype}")
    if not aug.is_contiguous():
        raise ValueError("aug must be contiguous")


def _launch(entry: str, x: torch.Tensor, size: int, *args) -> torch.Tensor:
    """Run one histogram kernel over the int32 stream x into [size] bins."""
    if x.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {x.device}")
    counts = torch.zeros(size, dtype=torch.int32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        props = torch.cuda.get_device_properties(x.device)
        err = getattr(lib, entry)(
            ctypes.c_void_p(x.data_ptr()), x.numel(), *args,
            ctypes.c_void_p(counts.data_ptr()), props.multi_processor_count,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, entry)
    return counts


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
    counts = _launch("kst_count_aug", aug, 1 << (2 * k), k)
    count_aug_launches += 1
    return counts


def _check_values(values: torch.Tensor, valid: torch.Tensor,
                  size: int) -> None:
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
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


def histogram_plain(values: torch.Tensor, valid: torch.Tensor,
                    size: int) -> torch.Tensor:
    """Plain PyTorch K3: int32 [size] counts of the valid values."""
    _check_values(values, valid, size)
    keep = valid & (values >= 0) & (values < size)
    return torch.bincount(values[keep], minlength=size).to(torch.int32)


def histogram(values: torch.Tensor, valid: torch.Tensor,
              size: int) -> torch.Tensor:
    """Dense int32 [size] histogram of ``values`` where ``valid``.

    values: int32, any shape; valid: bool, the same shape.  A value counts
    at its bin when valid and 0 <= value < size, else nowhere; any
    size >= 1.  Exact int32 counts, equal to the reference's
    pallas_histogram wherever that one is defined (sizes that are
    multiples of 128; below 128 it is a scatter that wraps a negative
    value).
    """
    global histogram_launches
    _check_values(values, valid, size)
    if values.device.type == "cpu":
        return histogram_plain(values, valid, size)
    masked = torch.where(valid, values, -1).reshape(-1)
    counts = _launch("kst_histogram", masked, size, size)
    histogram_launches += 1
    return counts


def count_spectrum(codes: torch.Tensor, valid: torch.Tensor,
                   k: int) -> torch.Tensor:
    """Dense int32 [4^k] spectrum from codes and their validity (K3)."""
    return histogram(codes, valid, 1 << (2 * k))
