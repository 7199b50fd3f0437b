"""The k <= 8 span pipeline on one device: fused count -> rank -> screen.

Counterpart of ``kmer_spans_tpu/spans/pipeline.py`` make_span_pipeline,
its fused branch (4 <= k <= 8, block >= 1024).  One call computes, on the
device:

  1. rolling codes, k-mer validity and the scored mask, packed into ONE
     aug word per position (code | valid << 16 | scored << 17);
  2. the 4^k spectrum from the aug words (K1, ops/histogram.py);
  3. the integer rank mass and the packed rank-class table;
  4. per-block integer max-plus summaries (tA, tB, maxA, maxB) from the
     class screen (K2, ops/screen_scan.py);
  5. an exact int64 composition of the summaries and a run-aware top-C
     choice of candidate blocks, with their codes and scored flags.

The host then composes the summaries exactly and replays only candidate
blocks in f64 (spans/finish.py finish_spans).

Differences from the reference: ties in the top-C choice go to the lower
block index through a stable descending sort (lax.top_k's rule;
torch.topk promises none), and the summaries are composed exactly in
int64 where the reference composes in f32 (the same values wherever the
f32 ones are exact, i.e. every partial sum an integer below 2^24; see
ops/blocked.py compose_summaries_int64).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.blocked import (
    blocked_codes,
    blocked_scored,
    compose_summaries_int64,
)
from ..ops import histogram, screen_scan
from ..ops.convert import wrap_int32
from ..ops.gather import CLASS_BITS, class_table_from_mass, screen_thr_q
from ..ops.screen_scan import MAX_BLOCK
from ..parallel.pipeline import _rank_mass


def aug_words(nbases: torch.Tensor, k: int, block: int):
    """nbases uint8 [nb * block] -> (aug int32 [nb, block], scored bool).

    ONE aug word per position (code | kmer_valid << 16 | scored << 17)
    feeds the count, the screen and the candidate pull.
    """
    nb = nbases.shape[0] // block
    b2 = (nbases & 3).reshape(nb, block)
    v2 = (nbases < 4).reshape(nb, block)
    aug, kmer_valid = blocked_codes(b2, v2, k)
    scored = blocked_scored(v2, kmer_valid)
    aug |= kmer_valid.to(torch.int32) << 16
    aug |= scored.to(torch.int32) << 17
    return aug, scored


def _top_blocks(tA, tB, maxA, maxB, C: int) -> torch.Tensor:
    """Indices (ascending, int64) of the C blocks of highest run max.

    Blocks chain into a run while the composed score stays positive
    across their boundary; every block of a run gets the run's max.  Ties
    go to the lower block index.
    """
    block_max, block_last = compose_summaries_int64(tA, tB, maxA, maxB)
    nb = block_max.shape[0]
    linked = torch.zeros(nb, dtype=torch.bool, device=block_max.device)
    linked[1:] = block_last[:-1] > 0
    run = torch.cumsum(~linked, 0) - 1
    run_max = torch.full_like(block_max, -(1 << 62)).scatter_reduce(
        0, run, block_max, "amax")[run]
    top = torch.sort(run_max, descending=True, stable=True).indices[:C]
    return torch.sort(top).values


def make_span_pipeline(
    k: int,
    block: int = 8192,
    cand_blocks: int = 128,
    screen: str = "auto",
    packed: bool = False,
    class_bits: int = CLASS_BITS,
    device="cuda",
):
    """Build the device step fn(nbases, thr) for 4 <= k <= 8.

    nbases: uint8 [n] (tensor or numpy; moved to ``device``), N as 4;
    n a multiple of ``block``.  thr: float (or float32 tensor).

    packed=False returns a dict: counts, total, tA, tB, maxA, maxB,
    top_idx, codes (the candidate blocks' codes, aug & 0xFFFF), scored.
    packed=True returns ONE int32 vector in the reference's layout
    (counts, total, tA, tB, maxA, maxB, top_idx, bit-packed scored flags,
    candidate blocks as a seed code + 2-bit bases, 16 a word); decode it
    with spans/finish.py unpack_outputs(..., packed_bases=fn.packed_bases).

    class_bits: 4 (default) or 2 rank-class bits in the screen table.
    K1 and K2 are looked up on their modules at each call
    (``histogram.count_aug``, ``screen_scan.fused_screen_scan``).

    Other k, screens and blocks are still to be ported and raise
    NotImplementedError.
    """
    if not 4 <= k <= 8 or screen not in ("auto", "class") or block < 1024:
        raise NotImplementedError(
            f"k={k}, screen={screen!r}, block={block}: only the fused "
            "class screen (4 <= k <= 8, block >= 1024) is ported; the other "
            "branches are ROADMAP queue 1 item 5")
    if block % 256 or block > MAX_BLOCK:
        raise NotImplementedError(
            f"block={block}: the fused screen kernel takes multiples of 256 "
            f"up to {MAX_BLOCK}")
    if class_bits not in (2, 4):
        raise ValueError(f"class_bits must be 2 or 4, got {class_bits}")
    dev = resolve_device(device)

    def fn(nbases, thr):
        nbases = torch.as_tensor(nbases, device=dev)
        if nbases.dtype != torch.uint8 or nbases.dim() != 1:
            raise TypeError("nbases must be a 1-D uint8 array")
        thr = torch.as_tensor(thr, dtype=torch.float32, device=dev)
        n = nbases.shape[0]
        if n % block or n == 0:
            raise ValueError(f"n={n} is not a positive multiple of {block}")
        nb = n // block
        aug, scored = aug_words(nbases, k, block)
        flat = aug.reshape(-1)
        counts = histogram.count_aug(flat, k)
        mass = _rank_mass(counts)
        total = counts.sum()
        words = class_table_from_mass(
            mass, total.to(torch.float32), class_bits)
        tA, tB, maxA, maxB = screen_scan.fused_screen_scan(
            words, flat, screen_thr_q(thr), class_bits, block)
        top_idx = _top_blocks(tA, tB, maxA, maxB, min(cand_blocks, nb))
        sc_cand = scored[top_idx]
        cand = aug[top_idx] & 0xFFFF
        if not packed:
            return {
                "counts": counts,
                "total": total,
                "tA": tA,
                "tB": tB,
                "maxA": maxA,
                "maxB": maxB,
                "top_idx": top_idx,
                "codes": cand,
                "scored": sc_cand,
            }
        C = top_idx.shape[0]
        bits32 = torch.arange(32, device=dev)
        sc_words = (sc_cand.reshape(C, block // 32, 32).to(torch.int64)
                    << bits32).sum(dim=-1)
        # 2-bit bases, 16 a word, after the block's first full code (its
        # k-1 halo seed); unpack_outputs rebuilds exact codes
        shifts = 2 * torch.arange(16, device=dev)
        b16 = ((cand & 3).to(torch.int64).reshape(C, block // 16, 16)
               << shifts).sum(dim=-1)
        cand_words = torch.cat([cand[:, :1].to(torch.int64), b16], dim=1)
        return torch.cat([
            counts,
            total.reshape(1).to(torch.int32),
            tA, tB, maxA, maxB,
            top_idx.to(torch.int32),
            wrap_int32(sc_words).reshape(-1),
            wrap_int32(cand_words).reshape(-1),
        ])

    # candidate blocks always travel as 2-bit bases (block % 256 == 0)
    fn.packed_bases = True
    return fn
