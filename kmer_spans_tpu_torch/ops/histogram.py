"""K1: the dense 4^k spectrum from aug words (CUDA kernel + plain version).

Counterpart of ``kmer_spans_tpu/ops/pallas_kernels.py`` pallas_count_aug.
The kernel is ``csrc/count_aug.cu`` (built by ops/_build.py); the plain
version is a torch.bincount.  A CPU tensor goes to the plain version, a
CUDA tensor to the kernel: there is no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches since the count was last set to 0 (read by chip_smoke.py
#: to show that a run went through the kernel)
launches = 0


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
    global launches
    _check_aug(aug, k)
    if aug.device.type == "cpu":
        return count_aug_plain(aug, k)
    if aug.device.type != "cuda":
        raise ValueError(f"count_aug: unsupported device {aug.device}")
    lib = _build.library()
    counts = torch.zeros(1 << (2 * k), dtype=torch.int32, device=aug.device)
    with torch.cuda.device(aug.device):
        props = torch.cuda.get_device_properties(aug.device)
        err = lib.kst_count_aug(
            ctypes.c_void_p(aug.data_ptr()), aug.numel(), k,
            ctypes.c_void_p(counts.data_ptr()), props.multi_processor_count,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, "count_aug")
    launches += 1
    return counts
