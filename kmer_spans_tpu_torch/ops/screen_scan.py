"""K2: fused class gather + integer screen score + per-block summaries.

Counterpart of ``kmer_spans_tpu/ops/screen_scan.py`` fused_screen_scan.
The kernel is ``csrc/screen_scan.cu``; the plain version is the gather,
class_scores_int and blocked_scan_summaries_int in PyTorch.  The table is
the packed class words themselves (ops/gather.py class_table_from_mass),
not the TPU's pre-rolled copies, and the TPU-only tiling parameters
(sub_blocks, the output row padding) are gone: one (tA, tB, maxA, maxB)
per ``block`` positions.  A CPU tensor goes to the plain version, a CUDA
tensor to the kernel: there is no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .blocked import blocked_scan_summaries_int
from .gather import class_scores_int

#: kernel launches since the count was last set to 0
launches = 0

#: a block must be a multiple of this
_THREADS = 256
#: the kernel stages a block's aug words in shared memory (4 bytes a
#: position) beside the class table
MAX_BLOCK = 32768


def _check(words, aug, thr_q, class_bits, block):
    if class_bits not in (2, 4):
        raise ValueError(f"class_bits must be 2 or 4, got {class_bits}")
    if block % _THREADS or not _THREADS <= block <= MAX_BLOCK:
        raise ValueError(
            f"block must be a multiple of {_THREADS} in "
            f"[{_THREADS}, {MAX_BLOCK}], got {block}")
    for name, t in (("words", words), ("aug", aug), ("thr_q", thr_q)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != aug.device:
            raise ValueError(
                f"{name} is on {t.device}, aug on {aug.device}")
    nw = words.numel()
    if words.dim() != 1 or nw < 1 or nw & (nw - 1):
        raise ValueError("words must be a 1-D table of 2^m int32 words")
    if thr_q.numel() != 1:
        raise ValueError("thr_q must hold one value")
    if aug.numel() % block:
        raise ValueError(
            f"aug length {aug.numel()} is not a multiple of block {block}")


def fused_screen_scan_plain(words, aug, thr_q, class_bits: int = 4,
                            block: int = 8192):
    """Plain PyTorch K2: the same four int32 [n / block] vectors."""
    _check(words, aug, thr_q, class_bits, block)
    epw = 32 // class_bits
    flat = aug.reshape(-1)
    c = flat & 0xFFFF
    w = words[(c >> (epw.bit_length() - 1)) & (words.numel() - 1)]
    cls = (w >> ((c & (epw - 1)) * class_bits)) & ((1 << class_bits) - 1)
    s = class_scores_int(cls, thr_q.reshape(()), class_bits)
    scored = ((flat >> 17) & 1) == 1
    return blocked_scan_summaries_int(
        s.reshape(-1, block), scored.reshape(-1, block))


def fused_screen_scan(words, aug, thr_q, class_bits: int = 4,
                      block: int = 8192):
    """aug words [n] -> (tA, tB, maxA, maxB), int32 [n / block] each.

    words: int32 packed class table (2^m words; a code indexes it modulo
    its length, a no-op for tables of 4^k / (32 / class_bits) words).
    aug: int32 [n], bit 17 = scored, bits 0..15 = code; n a multiple of
    block; on the card it must start on a 16-byte boundary.  thr_q:
    int32, one value (ops/gather.py screen_thr_q).  Equal to
    blocked_scan_summaries_int over class_scores_int, element for element.
    """
    global launches
    _check(words, aug, thr_q, class_bits, block)
    if aug.device.type == "cpu":
        return fused_screen_scan_plain(words, aug, thr_q, class_bits, block)
    if aug.device.type != "cuda":
        raise ValueError(f"fused_screen_scan: unsupported device {aug.device}")
    if aug.data_ptr() % 16:
        raise ValueError("aug must start on a 16-byte boundary (the kernel "
                         "copies whole blocks by the bulk-copy engine)")
    nb = aug.numel() // block
    out = torch.empty((4, nb), dtype=torch.int32, device=aug.device)
    if nb == 0:
        return out[0], out[1], out[2], out[3]
    lib = _build.library()
    with torch.cuda.device(aug.device):
        props = torch.cuda.get_device_properties(aug.device)
        err = lib.kst_screen_scan(
            ctypes.c_void_p(aug.data_ptr()), nb, block,
            ctypes.c_void_p(words.data_ptr()), words.numel(), class_bits,
            ctypes.c_void_p(thr_q.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            props.multi_processor_count,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, "fused_screen_scan")
    launches += 1
    return out[0], out[1], out[2], out[3]
