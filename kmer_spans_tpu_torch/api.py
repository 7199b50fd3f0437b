"""User API of the port: the flagship span caller on one device.

Counterpart of ``kmer_spans_tpu/api.py`` kmer_low_comp_regions in its
device form (mode="fast"), for 2 <= k <= 9 (the class screen of
spans/pipeline.py: fused at 4 <= k <= 8, non-fused at k = 2, 3 and 9)
and 10 <= k <= 15 (the exact-mass pm screen, spans/pm_pipeline.py).
Results carry the reference's ``RegionResult`` fields: region positions
and f64 scores are exactly the sequential reference's (candidates are
replayed on the host through the exact rank chain).

Where the device step cannot cover every candidate, the call reruns it on
the same device and counts each rerun in ``exact_fallbacks``: with twice
the candidate capacity, until every candidate block is pulled, or, at
k >= 10, with a list capacity doubled until the high-count run list fits.
(The reference instead falls through to its exact path; the regions are
the same either way.)  At k >= 10 a smallv run-list overflow first retries
once with the packed-key strategy, as the reference does; that retry is
not counted.
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .encoding import MAX_K, PackedSeq, pack
from .ops.pmscreen import pm_params
from .spans.finish import finish_spans, host_rank_mass
from .spans.pipeline import make_span_pipeline
from .spans.pm_finish import finish_pm_spans, unpack_pm_outputs
from .spans.pm_pipeline import make_pm_span_pipeline
from .utils import native

#: device reruns after a candidate- or list-capacity overflow
exact_fallbacks = 0

_REGION_DTYPE = np.dtype(
    [
        ("seq_id", np.int32),
        ("beg", np.int32),
        ("end", np.int32),
        ("score", np.float64),
        ("entropy", np.float64),  # always 0, as in the reference
    ]
)


@dataclasses.dataclass
class RegionResult:
    """What kmer_low_comp_regions returns (the reference's fields)."""

    n: np.ndarray  # the reference's n slot
    counts: np.ndarray | None
    regions: np.ndarray  # structured (seq_id, beg, end, score, entropy)
    w_rank: np.ndarray | None = None


def _as_region_array(regions) -> np.ndarray:
    out = np.zeros(len(regions), dtype=_REGION_DTYPE)
    for i, (sid, beg, end, score) in enumerate(regions):
        out[i] = (sid, beg, end, score, 0.0)
    return out


def _as_seq_list(seqs) -> list[PackedSeq]:
    if isinstance(seqs, (str, bytes, PackedSeq)):
        seqs = [seqs]
    return [pack(s) for s in seqs]


def kmer_low_comp_regions(
    seqs, k: int, min_w: int, min_score: float, thr: float = 0.75,
    mode: str = "fast", device="cuda",
) -> RegionResult:
    """Spectrum -> weighted ranks -> rank-scored spans (reference
    kmer_low_comp_regions, src/kmer_spans.c:548-621), on ``device``.

    mode="fast" is the only mode ported: the sparse device pipeline over
    all sequences at once (concatenated with N separators), exact f64
    replay of candidates, for 2 <= k <= 15.  mode="exact" (the
    reference's default) is still to be ported and raises
    NotImplementedError.  k = 1 raises ValueError: the class table packs
    8 ranks a word and 4^1 fill none (the reference's fast path fails
    there too).
    """
    if mode == "exact":
        raise NotImplementedError(
            "mode='exact' on the device is not ported yet: ROADMAP queue 1 "
            "item 6")
    if mode != "fast":
        raise ValueError(f"unknown mode {mode!r}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k should be in [1, {MAX_K}]")
    if k < 2:
        raise ValueError(
            "mode='fast' needs k >= 2: the class table packs 8 ranks a word")
    dev = resolve_device(device)
    return _low_comp_fast(_as_seq_list(seqs), k, min_w, min_score, thr, dev)


def _low_comp_fast(packed, k, min_w, min_score, thr, device, block=8192,
                   cand_blocks=128):
    """The device pipeline over all sequences in one call.

    Sequences >= k concatenate with single-N separators (segments never
    span N, so per-sequence semantics are kept exactly); emitted global
    positions map back to (seq_id, local 1-based) coordinates.
    """
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
    run = _pm_regions if k >= 10 else _class_regions
    res, counts, total = run(nbases, arr, k, min_w, min_score, thr, device,
                             block, cand_blocks)
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


def _class_regions(nbases, arr, k, min_w, min_score, thr, device, block,
                   cand_blocks):
    """2 <= k <= 9: the class screen; a missed candidate reruns it with
    twice the capacity (at one candidate per block none can be missed).
    Returns (finished spans, counts int64, total)."""
    global exact_fallbacks
    npad = arr.shape[0]
    nb = npad // block
    cand = min(cand_blocks, nb)
    while True:
        fn = make_span_pipeline(k, block=block, cand_blocks=cand,
                                device=device)
        out = {key: v.cpu().numpy() for key, v in fn(nbases, thr).items()}
        res = finish_spans(out, npad, thr, min_w, min_score, block=block)
        if not res.fallback:
            return res, out["counts"].astype(np.int64), int(out["total"])
        if cand == nb:
            raise AssertionError("every block was pulled, yet a candidate "
                                 "was missed")
        exact_fallbacks += 1
        cand = min(2 * cand, nb)


def _pm_regions(nbases, arr, k, min_w, min_score, thr, device, block,
                cand_blocks):
    """10 <= k <= 15: the pm pipeline (reference api.py:427-453).

    A smallv run-list overflow at k <= 14 retries once with the packed
    key; a list still overflowing reruns with its capacity doubled until
    the true run count fits, a missed candidate with twice the candidate
    capacity.  counts come from the host recount, as in the reference:
    the replay needs none, only the result's counts/w_rank fields do.
    Returns (finished spans, counts int64, total).
    """
    global exact_fallbacks
    npad = arr.shape[0]
    nb = npad // block
    cand = min(cand_blocks, nb)
    strategy, list_cap = None, None
    while True:
        fn, meta = make_pm_span_pipeline(
            k, block=block, cand_blocks=cand, list_cap=list_cap,
            strategy=strategy, device=device)
        out = unpack_pm_outputs(fn(nbases, thr).cpu().numpy(), npad, meta)
        res = finish_pm_spans(out, npad, meta, thr, min_w, min_score)
        if not res.fallback:
            break
        overflow = out["list_count"] > meta["list_cap"]
        if (overflow and strategy is None and k <= 14
                and pm_params(k, None, n=npad)[0] == "smallv"):
            strategy = "packed"
            continue
        if overflow:
            list_cap = meta["list_cap"]
            while list_cap < out["list_count"]:
                list_cap *= 2
        elif cand == nb:
            raise AssertionError("every block was pulled, yet a candidate "
                                 "was missed")
        else:
            cand = min(2 * cand, nb)
        exact_fallbacks += 1
    counts, _ = native.host_spectrum(arr, k)
    return res, np.asarray(counts).astype(np.int64), int(out["total"])
