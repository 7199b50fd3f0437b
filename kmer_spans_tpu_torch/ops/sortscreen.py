"""Sort-based integer screen for 4 <= k <= 23: no 4^k table on device.

Counterpart of ``kmer_spans_tpu/ops/sortscreen.py`` sort_screen_scores
(the k = 12 pipeline row of bench.py) and sort_screen_scores_wide (int64
wide codes at 16 <= k <= 23, one sort key where the reference sorts an
int32 pair with two).  Positions sort by code; a
position's run length v is its k-mer's exact count.  Two run histograms
(K3) give a sound upper bound on each position's rank mass (the
derivation is the reference's module docstring):

    mass(c) <= below(v) + v * (runs(v, high byte <= h) - 1)   for v < V2
    mass(c) <= cummass(<= v) - v                              for v < VMAX

and count values >= VMAX screen as rank 1.  The bounds become one packed
4-bit class table of VMAX / 8 + V2 * 32 words (16384 at the defaults),
gathered by K4 (ops/gather.py word_gather) into integer scores.  Spans
still come from the host finisher's exact replay.

Differences from the reference: the code sort, run heads and run lengths
are ops/pmscreen.py sorted_runs (its cumsum form, not lax.cummax, which
torch runs as one thread block); scores return to genome order by a
scatter through the sorted positions (a permutation), not a second sort;
K4 takes the flat word table, not the TPU's pre-rolled copies, with the
V2 part addressed as entries vmax and up.
"""

from __future__ import annotations

import torch

from . import gather, histogram
from .blocked import WIDE_MAX_K
from .gather import class_table_from_mass
from .pmscreen import sorted_runs

#: count values >= VMAX screen as rank_ub = 1 (sound)
VMAX = 1 << 16
#: count values < V2 get the (value, high-byte)-refined bound
V2 = 1 << 8


def runs_kind(n: int, k: int) -> str:
    """What the run histograms of n k-mers count (histogram's ``kind``):
    where 4^k >= n most k-mers occur once, so most runs have length 1
    ("repeats": one bin takes almost every count); else "runs"."""
    return "repeats" if n <= 4 ** k else "runs"


def rank_ub_histograms(v, hb, head_mask, vmax: int, v2: int,
                       kind: str = "runs"):
    """(vh_runs [vmax]: runs per count value; h2 [v2 * 256]: runs per
    (value, high byte)), int32, from K3.  head_mask: True once per real
    run; kind: runs_kind of the k-mers."""
    vh_runs = histogram.histogram(torch.clamp(v, max=vmax - 1), head_mask,
                                  vmax, kind=kind)
    idx2 = torch.clamp(v, max=v2 - 1) * 256 + hb
    h2 = histogram.histogram(idx2, head_mask & (v < v2), v2 * 256,
                             kind=kind)
    return vh_runs, h2


def rank_ub_tables(vh_runs, h2, total, vmax: int, v2: int):
    """The packed class words of both bounds: int32 [vmax / 8 + v2 * 32],
    by-value bound first.  All int32 as in the reference (every partial
    is at most 2 * total < 2^31)."""
    i32 = torch.int32
    dev = vh_runs.device
    w = torch.arange(vmax, dtype=i32, device=dev)
    cmass = torch.cumsum(w * vh_runs, 0, dtype=i32)  # cummass(<= v)
    mass_ub1 = cmass - w
    mass_ub1[vmax - 1] = total  # the clipped bucket screens as rank 1
    cumh = torch.cumsum(h2.reshape(v2, 256), 1, dtype=i32)
    below = torch.cat([cmass.new_zeros(1), cmass[:v2 - 1]])
    wv = torch.arange(v2, dtype=i32, device=dev)[:, None]
    mass_ub2 = below[:, None] + wv * (cumh - 1)
    total_f32 = total.to(torch.float32)
    words1 = class_table_from_mass(torch.clamp(mass_ub1, min=0), total_f32)
    words2 = class_table_from_mass(
        torch.clamp(mass_ub2.reshape(-1), min=0), total_f32)
    return torch.cat([words1, words2])


def rank_ub_entries(v, hb, vmax: int, v2: int):
    """Each element's nibble index in the flat class words: vmax +
    min(v, v2 - 1) * 256 + hb for v < v2, else min(v, vmax - 1)."""
    return torch.where(v < v2, torch.clamp(v, max=v2 - 1) * 256 + hb + vmax,
                       torch.clamp(v, max=vmax - 1))


def rank_ub_gather(words, v, hb, thr_q, vmax: int, v2: int):
    """Per-element integer scores from the class words (K4); the table is
    zero-padded to the power of two K4 takes."""
    entry = rank_ub_entries(v, hb, vmax, v2)
    nw = words.numel()
    pad = (1 << (nw - 1).bit_length()) - nw
    if pad:
        words = torch.cat([words, words.new_zeros(pad)])
    return gather.word_gather(words, entry, thr_q)


def _rank_ub_scores(v, hb, head, real, total, thr_q, vmax: int, v2: int,
                    kind: str = "runs"):
    """s_int in the sorted order, from the runs (see module docstring)."""
    vh_runs, h2 = rank_ub_histograms(v, hb, head & real, vmax, v2, kind)
    words = rank_ub_tables(vh_runs, h2, total, vmax, v2)
    return rank_ub_gather(words, v, hb, thr_q, vmax, v2)


def sort_screen_scores(codes, kmer_valid, scored, k: int, thr_q,
                       vmax: int = VMAX, v2: int = V2):
    """Integer upper-bound screen scores for every position, by sorting.

    codes: int32 [n] raw rolling codes (junk where invalid); kmer_valid,
    scored: bool [n] (scored is unused, as in the reference); thr_q: one
    int32.  Returns (s_int int32 [n] in genome order, junk where
    unscored; total int32, the counted k-mers).  4 <= k <= 15 (the high
    byte needs 2k >= 8); vmax a multiple of 8.
    """
    if not 4 <= k <= 15:
        raise ValueError(f"the sort screen needs 4 <= k <= 15, got k={k}")
    return _sorted_scores(codes, kmer_valid, k, thr_q, vmax, v2)


def sort_screen_scores_wide(codes, kmer_valid, k: int, thr_q,
                            vmax: int = VMAX, v2: int = V2):
    """The sort screen for wide codes (16 <= k <= 23): no 4^k anything,
    device memory O(n) (a dense spectrum would take 68 GB at k = 17).

    codes: int64 [n] wide codes (ops/blocked.py blocked_codes_wide, junk
    where invalid).  The same screen as sort_screen_scores, with one
    stable int64 sort where the reference sorts its (hi, lo) int32 pair
    with two keys, and the high byte (code >> (2k - 8)) & 255.  Returns
    (s_int int32 [n] in genome order, total int32).
    """
    if not 16 <= k <= WIDE_MAX_K:
        raise ValueError(f"wide codes need 16 <= k <= {WIDE_MAX_K}, got {k}")
    return _sorted_scores(codes, kmer_valid, k, thr_q, vmax, v2)


def _sorted_scores(codes, kmer_valid, k: int, thr_q, vmax: int, v2: int):
    if vmax % 8 or vmax < 8:
        raise ValueError(f"vmax must be a positive multiple of 8, got {vmax}")
    v2 = min(v2, vmax)
    skey, spos, head, v, real = sorted_runs(codes, kmer_valid, k)
    total = kmer_valid.sum(dtype=torch.int32)
    hb = ((skey >> (2 * k - 8)) & 255).to(torch.int32)
    del skey
    s_sorted = _rank_ub_scores(v, hb, head, real, total, thr_q, vmax, v2,
                               runs_kind(codes.numel(), k))
    del head, v, real, hb
    s_int = torch.empty_like(s_sorted)
    s_int[spos] = s_sorted  # back to genome order (spos is a permutation)
    return s_int, total
