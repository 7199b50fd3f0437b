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
