"""Packed rank-class tables, integer screen scores, and K4.

Counterpart of ``kmer_spans_tpu/ops/gather.py``: the table and score
helpers, and K4 ``word_gather``, the class gather of pallas_word_gather
fused with the nibble extract and class_scores_int as both its callers
use it (spans/pipeline.py's class screen, ops/sortscreen.py).  K4's
kernel is ``csrc/word_gather.cu``; a CPU tensor goes to its plain
version, a CUDA tensor to the kernel: there is no fallback between them.
The TPU's pre-rolled table copies (a Mosaic gather-window limit) are not
ported: the kernel takes the packed words themselves.

The screen needs only a SOUND UPPER BOUND on each position's rank: ranks
quantized to 2^class_bits levels pack 32/class_bits classes per int32
word (8192 words at k = 8 with 4-bit classes), and the integer score of
a class's upper edge is never below the true scaled score.  Candidates
are replayed exactly on the host, so the quantization can only add
candidate blocks.

The f32 operation order of the reference is kept step for step: mass ->
f32, / max(total, 1), * levels, truncation, clip; floor(thr * 4096) - 1.
A different order moves integer scores by one unit and the block
summaries stop matching.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .convert import wrap_int32

CLASS_BITS = 4
CLASS_LEVELS = 16

#: integer screening scale: screen scores live in units of 2^-12 rank
SCREEN_SCALE = 4096

#: K4 stages its whole table in shared memory: 2^15 int32 words (128 KiB)
MAX_GATHER_WORDS = 1 << 15

#: K4 kernel launches since the count was last set to 0
launches = 0


def screen_thr_q(thr: torch.Tensor) -> torch.Tensor:
    """Sound integer threshold: thr_q <= SCREEN_SCALE * thr, always.

    thr: float32 tensor.  The f32 product rounds to nearest (error below
    one unit), so floor(thr * 4096) - 1 never exceeds the true product.
    """
    return torch.floor(thr * SCREEN_SCALE).to(torch.int32) - 1


def class_scores_int(cls, thr_q, class_bits: int = CLASS_BITS):
    """Integer upper-bound screen score (units of 2^-12 rank).

    s_int = (cls + 1) * unit + 3 - thr_q >= SCREEN_SCALE * (rank - thr)
    for any true rank in the class, with unit = 4096 / 2^class_bits.
    """
    return (cls + 1) * (SCREEN_SCALE >> class_bits) + 3 - thr_q


def class_table_from_mass(mass: torch.Tensor, total_f32: torch.Tensor,
                          class_bits: int = CLASS_BITS) -> torch.Tensor:
    """Packed rank-upper-bound classes from integer cumulative mass.

    class[c] = min(levels - 1, trunc(f32(mass) / max(total, 1) * levels)),
    levels = 2^class_bits.  Returns int32 [4^k / (32 / class_bits)], entry
    e of a word at bits class_bits * e.
    """
    levels = 1 << class_bits
    epw = 32 // class_bits
    rank = mass.to(torch.float32) / torch.clamp(total_f32, min=1.0)
    cls = torch.clamp((rank * levels).to(torch.int32), 0, levels - 1)
    shifts = torch.arange(epw, device=mass.device) * class_bits
    words = (cls.reshape(-1, epw).to(torch.int64) << shifts).sum(dim=1)
    return wrap_int32(words)


def fine_class_table(mass: torch.Tensor, total_f32: torch.Tensor):
    """int16 4096-level rank-upper-bound table (the fine screen).

    tab[c] = min(4096, trunc(f32(mass) / max(total, 1) * 4096)) + 1, in
    the reference's f32 operation order; gathered in plain torch (the TPU
    used XLA's gather: no kernel).
    """
    rank = mass.to(torch.float32) / torch.clamp(total_f32, min=1.0)
    return (torch.clamp((rank * SCREEN_SCALE).to(torch.int32), 0,
                        SCREEN_SCALE) + 1).to(torch.int16)


def fine_scores_int(tab_vals: torch.Tensor, thr_q: torch.Tensor):
    """Integer screen scores from a fine_class_table gather."""
    return tab_vals.to(torch.int32) + 2 - thr_q


def _check_gather(words, entry, thr_q):
    for name, t in (("words", words), ("entry", entry), ("thr_q", thr_q)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != entry.device:
            raise ValueError(
                f"{name} is on {t.device}, entry on {entry.device}")
    nw = words.numel()
    if words.dim() != 1 or not 2 <= nw <= MAX_GATHER_WORDS or nw & (nw - 1):
        raise ValueError(
            f"words must be a 1-D table of 2^m int32 words, 2 <= 2^m <= "
            f"{MAX_GATHER_WORDS}, got shape {tuple(words.shape)}")
    if not (words.is_contiguous() and entry.is_contiguous()):
        raise ValueError("words and entry must be contiguous")
    if thr_q.numel() != 1:
        raise ValueError("thr_q must hold one value")


def word_gather_plain(words, entry, thr_q):
    """Plain PyTorch K4: the same int32 scores, shaped like entry."""
    _check_gather(words, entry, thr_q)
    w = words[(entry >> 3) & (words.numel() - 1)]
    nib = (w >> ((entry & 7) * CLASS_BITS)) & (CLASS_LEVELS - 1)
    return class_scores_int(nib, thr_q.reshape(()))


def word_gather(words, entry, thr_q):
    """Class-table scores: s = (nibble + 1) * 256 + 3 - thr_q, where the
    nibble is entry & 7 of words[(entry >> 3) mod W].

    words: int32 [W] packed 4-bit classes, W a power of two in
    [2, 2^15]; entry: int32, any shape, contiguous (the class screen's
    codes, or the sort screen's table entries); thr_q: one int32
    (screen_thr_q).  Returns int32 scores shaped like entry, equal to
    the reference's pallas_word_gather followed by the nibble extract
    and class_scores_int.
    """
    global launches
    _check_gather(words, entry, thr_q)
    if entry.device.type == "cpu":
        return word_gather_plain(words, entry, thr_q)
    if entry.device.type != "cuda":
        raise ValueError(f"word_gather: unsupported device {entry.device}")
    out = torch.empty_like(entry)
    if entry.numel() == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(entry.device):
        props = torch.cuda.get_device_properties(entry.device)
        err = lib.kst_word_gather(
            ctypes.c_void_p(entry.data_ptr()), entry.numel(),
            ctypes.c_void_p(words.data_ptr()), words.numel(),
            ctypes.c_void_p(thr_q.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            props.multi_processor_count,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, "word_gather")
    launches += 1
    return out
