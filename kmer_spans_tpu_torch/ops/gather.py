"""Packed rank-class tables and integer screen scores.

Counterpart of the table and score helpers of
``kmer_spans_tpu/ops/gather.py``.  The screen needs only a SOUND UPPER
BOUND on each position's rank: ranks quantized to 2^class_bits levels
pack 32/class_bits classes per int32 word (8192 words at k = 8 with
4-bit classes), and the integer score of a class's upper edge is never
below the true scaled score.  Candidates are replayed exactly on the
host, so the quantization can only add candidate blocks.

The f32 operation order of the reference is kept step for step: mass ->
f32, / max(total, 1), * levels, truncation, clip; floor(thr * 4096) - 1.
A different order moves integer scores by one unit and the block
summaries stop matching.
"""

from __future__ import annotations

import torch

from .convert import wrap_int32

CLASS_BITS = 4
CLASS_LEVELS = 16

#: integer screening scale: screen scores live in units of 2^-12 rank
SCREEN_SCALE = 4096


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
