"""The span-score recurrence S_i = max(S_{i-1} + s_i, 0) as max-plus pairs.

Counterpart of ``kmer_spans_tpu/ops/scan.py`` (``_combine``,
``score_elements``).  A position is the transform f(x) = max(x + a, b):
a scored position is (s_i, 0), an unscored one (-inf, 0), a reset to 0.
Two transforms compose in closed form,

    (f2 o f1)(x) = max(x + a1 + a2, max(b1 + a2, b2)),

so prefixes, block totals and cross-device carries are all compositions of
pairs.  ``scan_pairs`` is the inclusive prefix of a short 1-D sequence of
pairs (block or device totals) by doubling: it never subtracts, so its
b-parts keep the scale of the scores.

The dense span scan (``span_scan``, ``span_scan_blocked``,
``apply_carry``; the reference's, with the same results) gives the running
score S at every position: the sequence is cut into rows and scanned by
ops/blocked.py blocked_scan_prefixes in float64, then cast back to the
scores' dtype (an f32 closed form would cancel at genome scale).  S is 0
at unscored positions; a -inf score resets like one.  Plain PyTorch on
whatever device the scores lie on.
"""

from __future__ import annotations

import torch


def _combine(left, right):
    """Compose two (a, b) transform pairs: apply left, then right."""
    al, bl = left
    ar, br = right
    return al + ar, torch.maximum(bl + ar, br)


def score_elements(s: torch.Tensor, scored: torch.Tensor):
    """Per-position (a, b) max-plus elements from scores and the scored
    mask."""
    a = torch.where(scored, s, torch.full_like(s, float("-inf")))
    return a, torch.zeros_like(s)


def scan_pairs(a: torch.Tensor, b: torch.Tensor):
    """Inclusive prefix compositions (A, B) of 1-D pairs (a, b): element j
    is the composition of elements 0..j.  Doubling (Hillis-Steele): log2(n)
    rounds of ``_combine``, for the few thousand block totals of a shard,
    not for positions."""
    A, B = a.clone(), b.clone()
    d = 1
    while d < A.shape[0]:
        A[d:], B[d:] = _combine((A[:-d], B[:-d]), (A[d:], B[d:]))
        d *= 2
    return A, B


#: the row length span_scan cuts a sequence into
_SCAN_BLOCK = 8192


def _tiled(s: torch.Tensor, scored: torch.Tensor, block: int):
    """1-D scores and mask -> [nb, block] rows, the tail padded with
    unscored zeros (past the end, so no position's S changes)."""
    pad = (-s.shape[0]) % block
    scored = scored.to(torch.bool)
    if pad:
        s = torch.cat([s, s.new_zeros(pad)])
        scored = torch.cat([scored, scored.new_zeros(pad)])
    return s.reshape(-1, block), scored.reshape(-1, block)


def span_scan(s: torch.Tensor, scored: torch.Tensor):
    """Inclusive scan: returns (S, (A_end, B_end)).

    S[p] is the reference's running score at position p (0 at unscored
    positions); the final (A, B) pair is the whole sequence's composed
    transform, for carrying into a following one:
    S_next = max(S_in + A, B) (``apply_carry``).
    """
    from .blocked import blocked_scan_prefixes

    n = s.shape[0]
    FA, FB, _ = blocked_scan_prefixes(
        *_tiled(s, scored, max(1, min(_SCAN_BLOCK, n))))
    FA, FB = FA.reshape(-1)[:n], FB.reshape(-1)[:n]
    # the inclusive prefix at the last position is the whole transform
    return torch.maximum(FA, FB).to(s.dtype), (FA[-1].to(s.dtype),
                                                FB[-1].to(s.dtype))


def apply_carry(S_in, A: torch.Tensor, B: torch.Tensor):
    """Apply an incoming scalar scan state to a block's composed prefixes."""
    return torch.maximum(S_in + A, B)


def span_scan_blocked(s: torch.Tensor, scored: torch.Tensor, block: int):
    """Blocked scan over rows of ``block`` positions: the same S as
    span_scan (the rows' carries composed by ops/blocked.py
    blocked_scan)."""
    from .blocked import blocked_scan

    S, _ = blocked_scan(*_tiled(s, scored, block))
    return S.reshape(-1)[:s.shape[0]]
