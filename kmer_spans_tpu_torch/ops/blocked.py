"""Blocked genome ops: the genome as (nb, block) tiles of int32/bool tensors.

Counterpart of ``kmer_spans_tpu/ops/blocked.py`` for the k <= 8 span
pipeline: rolling codes with the k-1 halo, the scored mask, the integer
per-block max-plus summaries (the plain version that K2 fuses) and their
cross-block composition.  Plain PyTorch; every function
runs on whatever device its tensors lie on.
"""

from __future__ import annotations

import torch

#: int32 "-inf" sentinel for B-parts of integer screen summaries: a block
#: with no scored position has B = A - 2^30; anything <= SCREEN_NEG // 2
#: decodes as -inf on the host.
SCREEN_NEG = -(1 << 30)
INT_INF = 1 << 30


def halo_blocks(x: torch.Tensor, h: int, fill=0) -> torch.Tensor:
    """[nb, B] -> [nb, h+B]: row i gets row i-1's last h columns as prefix.

    Row 0's prefix is ``fill`` (the genome start).
    """
    nb, B = x.shape
    first = torch.full((1, h), fill, dtype=x.dtype, device=x.device)
    return torch.cat([torch.cat([first, x[:-1, B - h:]], 0), x], 1)


def blocked_codes(bases2d: torch.Tensor, valid2d: torch.Tensor, k: int):
    """Rolling codes + k-mer validity per block (end-position convention).

    bases2d: [nb, B] 2-bit bases; valid2d: [nb, B] bool (non-N).
    Returns (codes int32 [nb, B], kmer_valid bool [nb, B]).  Codes are the
    RAW rolling codes (an N reads as base 0), as in the reference: every
    consumer masks by kmer_valid or scored.  Built in place on one copy
    of each tile to keep the peak at genome scale down.
    """
    h = k - 1
    eb = halo_blocks(bases2d.to(torch.int32), h)
    ev = halo_blocks(valid2d, h, fill=False)
    B = bases2d.shape[1]
    code = eb[:, h:h + B].clone()
    kv = ev[:, h:h + B].clone()
    for j in range(1, k):
        code |= eb[:, h - j:h - j + B] << (2 * j)
        kv &= ev[:, h - j:h - j + B]
    return code, kv


def blocked_scored(valid2d: torch.Tensor, kmer_valid: torch.Tensor):
    """Scored mask: k-mer valid AND the next byte exists and is non-N.

    The next byte of a block's last column is the next block's first
    column; the genome's last position is never scored (the reference's
    never-score-the-segment's-last-k-mer rule).
    """
    last = torch.zeros((1, 1), dtype=torch.bool, device=valid2d.device)
    nxt = torch.cat(
        [valid2d[:, 1:], torch.cat([valid2d[1:, :1], last], 0)], 1)
    return kmer_valid & nxt


def blocked_scan_summaries_int(s2d: torch.Tensor, scored2d: torch.Tensor):
    """Integer per-block max-plus summaries (tA, tB, maxA, maxB), int32 [nb].

    With a = s at scored positions and 0 elsewhere, A = cumsum(a) along
    the block and Bv = A - cummin(A at scored positions, 2^30 elsewhere):
    the block transform is x -> max(x + tA, tB) with tA = A_end,
    tB = Bv_end, and its running max from x is max(x + maxA, maxB).
    Exact int32 (|sums| < 2^27 for blocks up to 32768 positions).
    """
    a = torch.where(scored2d, s2d, 0).to(torch.int32)
    A = torch.cumsum(a, dim=1, dtype=torch.int32)
    M = torch.cummin(torch.where(scored2d, A, INT_INF), dim=1).values
    Bv = A - M
    return A[:, -1], Bv[:, -1], A.amax(dim=1), Bv.amax(dim=1)


def compose_summaries_int64(tA, tB, maxA, maxB):
    """Exact int64 cross-block composition (orders the top-C pull).

    Returns (block_max, block_last) int64 [nb], for initial state 0: the
    device form of spans/finish.py compose_summaries_exact, equal to it
    element for element.  The composed prefix transform is (CA, CB) with
    CA = cumsum(tA) and CB = CA + cummax(tB - CA).

    The reference composes in f32 through an associative scan, whose
    b-parts never leave the scale of the scores.  The cumsum form
    subtracts and re-adds CA, which reaches ~1e10 at genome scale: in f32
    that cancellation loses whole score units, breaks runs and pushes
    candidate blocks out of the top C.  int64 is exact at any genome
    size, and equals the reference's f32 values wherever those are exact
    (every partial sum an integer below 2^24).
    """
    sent = SCREEN_NEG // 2
    neg = -(1 << 62)
    tA = tA.to(torch.int64)
    tB = torch.where(tB <= sent, neg, tB.to(torch.int64))
    maxB = torch.where(maxB <= sent, neg, maxB.to(torch.int64))
    cA = torch.cumsum(tA, 0)
    block_last = torch.maximum(cA, cA + torch.cummax(tB - cA, 0).values)
    x_in = torch.cat([block_last.new_zeros(1), block_last[:-1]])
    block_max = torch.maximum(x_in + maxA.to(torch.int64), maxB)
    return block_max, block_last
