"""Single-device spectrum count with power-of-two staging.

Counterpart of ``kmer_spans_tpu/parallel/device.py`` (``bucket_size``,
``device_count_spectrum``).  Each sequence is staged on the device padded
to a power-of-two bucket, with N (4) in the padding, so padding counts
nowhere; its codes come from the blocked rolling codes (ops/blocked.py)
and its 4^k spectrum from K3 (ops/histogram.py count_spectrum).  The
reference's flat ``ops/codes.py`` and its scatter and sort counts are not
ported: K3 computes the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..encoding import MAX_K, PackedSeq
from ..ops import histogram
from ..ops.blocked import blocked_codes

_MIN_BUCKET = 4096
#: positions a tile of the blocked codes (every bucket is a multiple of
#: this or smaller than it)
_COUNT_BLOCK = 8192


def bucket_size(n: int) -> int:
    """The power of two >= n, at least 4096."""
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


def staged_nbases(p: PackedSeq, npad: int) -> np.ndarray:
    """uint8 [npad]: the sequence's 2-bit bases with N as 4, N-padded."""
    arr = np.full(npad, 4, np.uint8)
    arr[: p.n] = np.where(p.valid, p.bases, 4)
    return arr


def device_count_spectrum(packed: list[PackedSeq], k: int, device="cuda"):
    """The 4^k spectrum over sequences, counted on ``device``.

    Returns (counts int64 np [4^k], n_words int).  Sequences shorter than k
    are skipped (reference binding behaviour, src/kmer_spans.c:478-479).
    Counts accumulate in int64 on the device; n_words is their sum, the
    number of valid k-mers.
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k should be in [1, {MAX_K}]")
    dev = resolve_device(device)
    total = None
    for p in packed:
        if p.n < k:
            continue
        npad = bucket_size(p.n)
        block = min(npad, _COUNT_BLOCK)
        nbases = torch.from_numpy(staged_nbases(p, npad)).to(dev)
        codes, kv = blocked_codes((nbases & 3).reshape(-1, block),
                                  (nbases < 4).reshape(-1, block), k)
        del nbases
        c = histogram.count_spectrum(codes.reshape(-1), kv.reshape(-1), k)
        del codes, kv
        total = c.to(torch.int64) if total is None else total + c
    if total is None:
        return np.zeros(1 << (2 * k), dtype=np.int64), 0
    counts = total.cpu().numpy()
    return counts, int(counts.sum())
