"""User API of the port: the flagship span caller on one device.

Counterpart of ``kmer_spans_tpu/api.py`` kmer_low_comp_regions in its
device form (mode="fast"), for 4 <= k <= 8.  Results are the reference's
``RegionResult``: region positions and f64 scores are exactly the
sequential reference's (candidates are replayed on the host through the
exact rank chain).  When the device's candidate capacity overflows, the
call reruns the pipeline on the same device with twice the capacity,
until every candidate block is pulled, and counts each rerun in
``exact_fallbacks``.  (The reference instead falls through to its exact
path; the regions are the same either way.)
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from kmer_spans_tpu.api import RegionResult, _as_region_array, _as_seq_list
from kmer_spans_tpu.encoding import MAX_K

from .device import resolve_device
from .spans.finish import finish_spans, host_rank_mass
from .spans.pipeline import make_span_pipeline

#: device reruns after a candidate-capacity overflow
exact_fallbacks = 0


def kmer_low_comp_regions(
    seqs, k: int, min_w: int, min_score: float, thr: float = 0.75,
    mode: str = "fast", device="cuda",
) -> RegionResult:
    """Spectrum -> weighted ranks -> rank-scored spans (reference
    kmer_low_comp_regions, src/kmer_spans.c:548-621), on ``device``.

    mode="fast" is the only mode ported: the sparse device pipeline over
    all sequences at once (concatenated with N separators), exact f64
    replay of candidate blocks.  mode="exact" (the reference's default),
    k = 9 and k >= 10 are still to be ported and raise
    NotImplementedError.
    """
    if mode == "exact":
        raise NotImplementedError(
            "mode='exact' on the device is not ported yet: ROADMAP queue 1 "
            "item 6")
    if mode != "fast":
        raise ValueError(f"unknown mode {mode!r}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k should be in [1, {MAX_K}]")
    if k >= 10:
        raise NotImplementedError(
            f"k={k}: the k >= 10 pm pipeline is not ported yet: ROADMAP "
            "queue 1 item 4")
    if not 4 <= k <= 8:
        raise NotImplementedError(
            f"k={k}: the non-fused class screen is not ported yet: ROADMAP "
            "queue 1 item 5")
    dev = resolve_device(device)
    return _low_comp_fast(_as_seq_list(seqs), k, min_w, min_score, thr, dev)


def _low_comp_fast(packed, k, min_w, min_score, thr, device, block=8192,
                   cand_blocks=128):
    """The device pipeline over all sequences in one call.

    Sequences >= k concatenate with single-N separators (segments never
    span N, so per-sequence semantics are kept exactly); emitted global
    positions map back to (seq_id, local 1-based) coordinates.  On
    candidate-capacity overflow the pipeline reruns with twice the
    capacity; at one candidate per block none can be missed.
    """
    global exact_fallbacks
    if not 0.0 < thr < 1.0:
        raise ValueError("the threshold must be between 0 and 1")
    kept = [(i, p) for i, p in enumerate(packed) if p.n >= k]
    if not kept:
        return RegionResult(
            n=np.array([0.0, 0.0]),
            counts=np.zeros(1 << (2 * k), np.int64),
            regions=_as_region_array([]),
            w_rank=np.zeros(1 << (2 * k)),
        )
    total_len = sum(p.n for _, p in kept) + len(kept) - 1
    npad = max(block, 1 << 13)
    while npad < total_len:
        npad *= 2
    npad = -(-npad // block) * block
    arr = np.full(npad, 4, np.uint8)
    offsets = []  # global 0-based start of each kept sequence
    pos = 0
    for j, (i, p) in enumerate(kept):
        if j:
            pos += 1  # N separator
        offsets.append(pos)
        arr[pos:pos + p.n] = np.where(p.valid, p.bases, 4)
        pos += p.n
    nbases = torch.from_numpy(arr).to(device)
    nb = npad // block
    cand = min(cand_blocks, nb)
    while True:
        fn = make_span_pipeline(k, block=block, cand_blocks=cand,
                                device=device)
        out = {key: v.cpu().numpy() for key, v in fn(nbases, thr).items()}
        res = finish_spans(out, npad, thr, min_w, min_score, block=block)
        if not res.fallback:
            break
        if cand == nb:
            raise AssertionError("every block was pulled, yet a candidate "
                                 "was missed")
        exact_fallbacks += 1
        cand = min(2 * cand, nb)
    counts = out["counts"].astype(np.int64)
    total = int(out["total"])
    regions = []
    for _, beg, end, score in res.regions:
        j = bisect.bisect_right(offsets, beg - 1) - 1
        off = offsets[j]
        regions.append((kept[j][0], beg - off, end - off, score))
    return RegionResult(
        n=np.array([float(total), 0.0]),
        counts=counts,
        regions=_as_region_array(regions),
        w_rank=host_rank_mass(counts).astype(np.float64) / max(total, 1),
    )
