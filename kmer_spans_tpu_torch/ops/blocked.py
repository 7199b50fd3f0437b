"""Blocked genome ops: the genome as (nb, block) tiles of int32/bool tensors.

Counterpart of ``kmer_spans_tpu/ops/blocked.py`` for the span pipelines
and the spectrum count (1 <= k <= 15; int64 wide codes for 16 <= k <= 23):
rolling codes with the k-1 halo
(of the whole genome, or of chosen blocks alone), the scored mask, the
integer per-block max-plus summaries (the plain version that K2 fuses)
and their cross-block composition.  Plain PyTorch; every function
runs on whatever device its tensors lie on.
"""

from __future__ import annotations

import torch

#: int32 "-inf" sentinel for B-parts of integer screen summaries: a block
#: with no scored position has B = A - 2^30; anything <= SCREEN_NEG // 2
#: decodes as -inf on the host.
SCREEN_NEG = -(1 << 30)
INT_INF = 1 << 30
#: widest k of the wide codes: 2k <= 46 bits (the reference's int32 pair
#: holds bits 16..2k-1 below 2^30)
WIDE_MAX_K = 23


def halo_blocks(x: torch.Tensor, h: int, fill=0, first=None) -> torch.Tensor:
    """[nb, B] -> [nb, h+B]: row i gets row i-1's last h columns as prefix.

    Row 0's prefix is ``first`` ([h]) if given (the bases before a chunk
    of a longer sequence), else ``fill`` (the genome start).
    """
    nb, B = x.shape
    if first is None:
        head = torch.full((1, h), fill, dtype=x.dtype, device=x.device)
    else:
        head = torch.as_tensor(first, device=x.device).reshape(1, h).to(
            x.dtype)
    return torch.cat([torch.cat([head, x[:-1, B - h:]], 0), x], 1)


def blocked_codes(bases2d: torch.Tensor, valid2d: torch.Tensor, k: int,
                  first_bases=None, first_valid=None):
    """Rolling codes + k-mer validity per block (end-position convention).

    bases2d: [nb, B] 2-bit bases; valid2d: [nb, B] bool (non-N).
    first_bases/first_valid ([k-1]) seed row 0's halo: the k-1 bases
    before the tile (a chunk's predecessor); by default invalid, i.e. the
    genome start.
    Returns (codes int32 [nb, B], kmer_valid bool [nb, B]).  Codes are the
    RAW rolling codes (an N reads as base 0), as in the reference: every
    consumer masks by kmer_valid or scored.  Built in place on one copy
    of each tile to keep the peak at genome scale down.
    """
    h = k - 1
    return _rolling(halo_blocks(bases2d.to(torch.int32), h,
                                first=first_bases),
                    halo_blocks(valid2d, h, fill=False, first=first_valid),
                    k, bases2d.shape[1])


def blocked_codes_wide(bases2d: torch.Tensor, valid2d: torch.Tensor, k: int,
                       first_bases=None, first_valid=None):
    """blocked_codes for wide k, 16 <= k <= WIDE_MAX_K: int64 codes.

    A wide code needs 2k > 31 bits.  The reference carries it as an int32
    pair, hi = bits 16..2k-1 and lo = the low 16 bits; here it is one
    int64 code equal to (hi << 16) | lo at every position, the junk of
    invalid positions included (an N reads as base 0).
    Returns (codes int64 [nb, B], kmer_valid bool [nb, B]).
    """
    if not 16 <= k <= WIDE_MAX_K:
        raise ValueError(f"wide codes need 16 <= k <= {WIDE_MAX_K}, got {k}")
    h = k - 1
    return _rolling(halo_blocks(bases2d.to(torch.int64), h,
                                first=first_bases),
                    halo_blocks(valid2d, h, fill=False, first=first_valid),
                    k, bases2d.shape[1])


def _rolling(eb: torch.Tensor, ev: torch.Tensor, k: int, B: int):
    """Codes and validity of the k-mers ending at columns k-1 .. k-2+B of
    int32 bases ``eb`` and validity ``ev`` (rows of k-1 halo columns, then
    the block), each k-mer's bases MSB-first."""
    h = k - 1
    code = eb[:, h:h + B].clone()
    kv = ev[:, h:h + B].clone()
    for j in range(1, k):
        code |= eb[:, h - j:h - j + B] << (2 * j)
        kv &= ev[:, h - j:h - j + B]
    return code, kv


def blocked_scored(valid2d: torch.Tensor, kmer_valid: torch.Tensor,
                   next_valid=None):
    """Scored mask: k-mer valid AND the next byte exists and is non-N.

    The next byte of a block's last column is the next block's first
    column; the tile's last position reads ``next_valid`` (a bool scalar
    or one-element tensor: the first byte of a chunk's successor), by
    default False: the genome's last position is never scored (the
    reference's never-score-the-segment's-last-k-mer rule).
    """
    if next_valid is None:
        last = torch.zeros((1, 1), dtype=torch.bool, device=valid2d.device)
    else:
        last = torch.as_tensor(next_valid, device=valid2d.device).reshape(
            1, 1).to(torch.bool)
    nxt = torch.cat(
        [valid2d[:, 1:], torch.cat([valid2d[1:, :1], last], 0)], 1)
    return kmer_valid & nxt


def block_rows_codes(nbases: torch.Tensor, idx: torch.Tensor, k: int,
                     block: int, first=None, next_byte=None):
    """Codes and scored mask of the blocks ``idx`` alone.

    nbases: uint8 [nb * block], N as 4; idx: integer [C] block indices.
    Returns (codes int32 [C, block], set to 0 where the k-mer is invalid,
    scored bool [C, block]): rows idx of ``blocked_codes`` (masked) and
    ``blocked_scored`` over the whole genome, computed from a gather of
    each block, its k-1 halo and the next position.  Outside nbases the
    bytes are N, unless ``first`` (uint8 [k-1], the bytes before a chunk)
    or ``next_byte`` (a uint8 scalar tensor, the byte after it) is given.
    """
    h = k - 1
    n = nbases.shape[0]
    pos = (idx.to(torch.int64)[:, None] * block
           + torch.arange(-h, block + 1, device=nbases.device))
    ext = nbases
    if first is not None or next_byte is not None:
        four = nbases.new_full((1,), 4)
        head = (four.expand(h) if first is None
                else torch.as_tensor(first, device=nbases.device).reshape(
                    h).to(torch.uint8))
        tail = (four if next_byte is None
                else torch.as_tensor(next_byte, device=nbases.device)
                .reshape(1).to(torch.uint8))
        ext = torch.cat([head, nbases, tail])
        pos = pos + h
        n = ext.shape[0]
    inside = (pos >= 0) & (pos < n)
    x = torch.where(inside, ext[pos.clamp(0, n - 1)], 4)
    v = x < 4
    code, kv = _rolling((x & 3).to(torch.int32), v, k, block)
    return torch.where(kv, code, 0), kv & v[:, h + 1:h + 1 + block]


#: positions a row group of blocked_scan_prefixes holds (bounds its
#: temporaries)
_PREFIX_GROUP = 1 << 24


def blocked_scan_prefixes(s2d: torch.Tensor, scored2d: torch.Tensor):
    """Inclusive max-plus prefix transforms over row-major [nb, B] tiles.

    Counterpart of the reference's blocked_scan_prefixes (the mesh
    pipeline's scan, and the dense span scan of ops/scan.py).  Returns
    (FA, FB, (tA, tB)), float64: S at (i, j) for the state x entering the
    tile is max(x + FA[i, j], FB[i, j]), and (tA, tB) is the whole tile's
    transform, for carries across devices.  A score of -inf at a scored
    position acts as an unscored one, as in the reference's pairs (both
    are (-inf, 0)).

    Each row in closed form (ops/scan.py's pairs, b = 0 everywhere): with
    T the row's cumsum of s over scored positions and the resets the
    unscored positions, A = T before the row's first reset and -inf from
    it on, and B_j = T_j - min(T_u .. T_j), u the last reset at or before
    j (the row start if none).  The position of that running min comes
    from a cummin that restarts at each reset through a segment offset,
    T - seg * C with C above the range of T (a later segment's keys lie
    below every earlier one's); B is then the difference of two of the
    row's f64 cumsum values, so it keeps their precision (a few ulp of
    the row's largest |T|), and the offset's rounding can only pick, in a
    near tie, a minimum within an ulp of seg * C of the true one.  All in
    float64, where an f32 cumsum would cancel (the fault class of
    compose_summaries_int64).  Rows compose with scan_pairs, which never
    subtracts.  The reference's f32 associative scans are within 2e-4 of
    the exact recurrence; this form is closer.
    """
    from .scan import scan_pairs

    nb, B = s2d.shape
    neg = float("-inf")
    FA = torch.empty((nb, B), dtype=torch.float64, device=s2d.device)
    FB = torch.empty_like(FA)
    rows = max(1, _PREFIX_GROUP // B)
    for r0 in range(0, nb, rows):
        s = s2d[r0:r0 + rows].to(torch.float64)
        sc = scored2d[r0:r0 + rows] & (s > neg)
        T = torch.cumsum(torch.where(sc, s, 0.0), dim=1)
        seg = torch.cumsum(~sc, dim=1)
        off = seg.to(torch.float64) * (2.0 * float(T.abs().amax()) + 1.0)
        at = torch.cummin(T - off, dim=1).indices
        FB[r0:r0 + rows] = T - T.gather(1, at)
        FA[r0:r0 + rows] = torch.where(seg == 0, T, neg)
        del s, sc, T, seg, off, at
    cA, cB = scan_pairs(FA[:, -1].clone(), FB[:, -1].clone())
    RA = torch.cat([cA.new_zeros(1), cA[:-1]])
    RB = torch.cat([cB.new_full((1,), neg), cB[:-1]])
    FB = torch.maximum(RB[:, None] + FA, FB)
    FA += RA[:, None]
    return FA, FB, (cA[-1], cB[-1])


def blocked_scan(s2d: torch.Tensor, scored2d: torch.Tensor):
    """Max-plus scan over row-major [nb, B] tiles, initial state 0.

    Counterpart of the reference's blocked_scan.  Returns S [nb, B] (the
    running score at each position, 0 at unscored ones) and the whole
    tile's transform (A, B), all cast from blocked_scan_prefixes' float64
    to ``s2d.dtype``.
    """
    FA, FB, (tA, tB) = blocked_scan_prefixes(s2d, scored2d)
    return torch.maximum(FA, FB).to(s2d.dtype), (tA.to(s2d.dtype),
                                                 tB.to(s2d.dtype))


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


def compose_summaries_int64(tA, tB, maxA, maxB, x0: int = 0):
    """Exact int64 cross-block composition (orders the top-C pull).

    Returns (block_max, block_last) int64 [nb], for initial state x0 (a
    chunk's incoming exact carry; 0 at a genome start): the device form of
    spans/finish.py compose_summaries_exact, equal to it element for
    element.  The composed prefix transform is (CA, CB) with
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
    block_last = torch.maximum(cA + x0, cA + torch.cummax(tB - cA, 0).values)
    x_in = torch.cat([block_last.new_full((1,), x0), block_last[:-1]])
    block_max = torch.maximum(x_in + maxA.to(torch.int64), maxB)
    return block_max, block_last
