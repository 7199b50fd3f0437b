"""The k >= 10 span pipeline on one device: no spectrum, device or host.

Counterpart of ``kmer_spans_tpu/spans/pm_pipeline.py``
make_pm_span_pipeline, for narrow codes (10 <= k <= 15), and
make_wide_pm_pipeline, for int64 wide codes (16 <= k <= 23).  One call
computes, on the device:

  1. rolling codes, k-mer validity and the scored mask (ops/blocked.py);
  2. the exact-mass screen (ops/pmscreen.py): every position's exact
     cumulative rank mass pm, the run-value histogram (K3) and the list of
     high-count runs;
  3. integer screen scores from pm and per-block max-plus summaries;
  4. an exact int64 composition of the summaries and a run-aware top-C
     choice of candidate blocks;

and returns them in ONE int32 vector, laid out as the reference's.  The
host decodes it and replays the candidates in exact f64
(spans/pm_finish.py).

Differences from the reference: the top-C choice is spans/pipeline.py
_top_blocks (exact int64 composition, ties to the lower block index),
equal to the reference's f32 choice wherever that one is exact; the
reference's re-tiling of short blocks into 8192-position tiles, a TPU
compile-time measure, is left out (the codes are the same either way);
the wide layout's nbins and list capacity come from pm_params(k,
"smallv", wide=True), where the reference asks pm_params(16, "smallv")
(the same numbers today).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.blocked import (
    WIDE_MAX_K,
    blocked_codes,
    blocked_codes_wide,
    blocked_scan_summaries_int,
    blocked_scored,
)
from ..ops.gather import screen_thr_q
from ..ops.pmscreen import (
    pm_params,
    pm_scores_int,
    pm_sort_screen,
    pm_sort_screen_wide,
)
from .pipeline import _top_blocks, pack_candidates


def make_pm_span_pipeline(
    k: int,
    block: int = 8192,
    cand_blocks: int = 256,
    list_cap: int | None = None,
    strategy: str | None = None,
    device="cuda",
):
    """Build the device step for narrow codes (10 <= k <= 15).

    Returns (fn, meta).  fn(nbases, thr): nbases uint8 [n] (tensor or
    numpy; moved to ``device``), N as 4, n a positive multiple of
    ``block``; thr a float.  It returns ONE int32 vector: total, tA, tB,
    maxA, maxB, top_idx, bit-packed scored flags, candidate blocks as a
    seed code + 2-bit bases, their pm rows, the value histogram, the list
    codes and counts, the true list count and t_list.  Decode it with
    spans/pm_finish.py unpack_pm_outputs(vec, n, meta).

    strategy None picks packed or smallv from n (ops/pmscreen.py
    choose_params); list_cap None takes the per-k default.  K3 is looked
    up on ops/histogram.py at each call.
    """
    if not 10 <= k <= 15:
        raise ValueError(f"the pm pipeline needs 10 <= k <= 15, got k={k}")
    if strategy not in (None, "packed", "smallv"):
        raise ValueError(f"unknown strategy {strategy!r}")
    # nbins and cap are fixed per k, so the unpack layout does not depend
    # on n; the strategy and t_list are chosen from n and ride in the vector
    _, _, _, nbins, cap = pm_params(k, "packed" if k <= 14 else "smallv")
    cap = list_cap or cap

    def screen(codes, kmer_valid):
        scr = pm_sort_screen(codes, kmer_valid, k, list_cap=cap,
                             strategy=strategy)
        return scr, [scr["list_codes"]]

    return _pm_step(k, block, cand_blocks, blocked_codes, screen, device), \
        {"k": k, "block": block, "cand_blocks": cand_blocks,
         "list_cap": cap, "wide": False, "nbins": nbins}


def make_wide_pm_pipeline(
    k: int,
    block: int = 8192,
    cand_blocks: int = 256,
    list_cap: int | None = None,
    device="cuda",
):
    """Build the device step for wide codes (16 <= k <= 23).

    Returns (fn, meta), as make_pm_span_pipeline, over int64 wide codes
    (ops/blocked.py blocked_codes_wide) and the wide screen
    (ops/pmscreen.py pm_sort_screen_wide, smallv always: 4^k >> n makes
    the counts sparse).  The vector is the reference's wide layout: each
    candidate block's seed as two words (code >> 16, code & 0xFFFF), and
    the list as list_hi, list_lo, list_v.  meta takes nbins and the list
    capacity from pm_params(k, "smallv", wide=True).  No spectrum is
    built, on the device or the host.
    """
    if not 16 <= k <= WIDE_MAX_K:
        raise ValueError(f"the wide pm pipeline needs 16 <= k <= "
                         f"{WIDE_MAX_K}, got k={k}")
    _, _, _, nbins, cap = pm_params(k, "smallv", wide=True)
    cap = list_cap or cap

    def screen(codes, kmer_valid):
        scr = pm_sort_screen_wide(codes, kmer_valid, k, list_cap=cap)
        return scr, [scr["list_hi"], scr["list_lo"]]

    return _pm_step(k, block, cand_blocks, blocked_codes_wide, screen,
                    device), \
        {"k": k, "block": block, "cand_blocks": cand_blocks,
         "list_cap": cap, "wide": True, "nbins": nbins}


def _pm_step(k: int, block: int, cand_blocks: int, codes_of, screen, device):
    """The device step of both code widths: codes_of builds the codes,
    screen(codes, kmer_valid) returns the screen's dict and its list
    codes in the vector's layout."""
    if block % 32:
        raise ValueError("block must be a multiple of 32")
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
        b2 = (nbases & 3).reshape(nb, block)
        v2 = (nbases < 4).reshape(nb, block)
        codes, kmer_valid = codes_of(b2, v2, k)
        scored = blocked_scored(v2, kmer_valid)
        del b2, v2
        scr, lists = screen(codes.reshape(-1), kmer_valid.reshape(-1))
        del kmer_valid
        s_int = pm_scores_int(scr["pm"], scr["total"], screen_thr_q(thr))
        tA, tB, maxA, maxB = blocked_scan_summaries_int(
            s_int.reshape(nb, block), scored)
        del s_int
        top_idx = _top_blocks(tA, tB, maxA, maxB, min(cand_blocks, nb))
        return torch.cat([
            scr["total"].reshape(1),
            tA, tB, maxA, maxB,
            top_idx.to(torch.int32),
            *pack_candidates(scored[top_idx], codes[top_idx]),
            scr["pm"].reshape(nb, block)[top_idx].reshape(-1),
            scr["vh"],
            *lists,
            scr["list_v"],
            scr["list_count"].reshape(1),
            torch.tensor([scr["t_list"]], dtype=torch.int32, device=dev),
        ])

    return fn
