"""Sharded-spectrum span scan: the k >= 13 configuration.

Counterpart of ``kmer_spans_tpu/parallel/sharded_scan.py``.  The spectrum
and its rank mass stay sharded by code (parallel/sharded.py: rank d owns
[d, d + 1) * 4^k / world); no rank holds the 4^k table.  Each position's
mass comes with one all_to_all round:

  1. every rank builds its shard's codes (with the halos);
  2. codes sort stably by owner and ride fixed-capacity buckets through
     all_to_all; each owner gathers the mass of the codes it received;
  3. a second all_to_all returns the values, which go back to genome
     order through the sorted positions.

Screen scores are the integer upper bounds of ops/gather.py computed from
the mass in the reference's f32 order (``mass_rank_f32``); the blocks
give the integer summaries (blocked_scan_summaries_int), and each rank
pulls its top C candidate blocks with their exact int64 mass.  The host
finisher composes the summaries exactly in int64, and replays candidates
in f64 from the mass and the replicated value histogram
(stats/ranks.py chain_ranks_from_mass), bit-identical to the sequential
oracle, without ever holding the spectrum.

Differences from the reference:

  * mass is int64, and travels as one int64 all_to_all where the
    reference sends an (hi, lo) int32 pair in two;
  * the top C is ordered by the exact int64 composition (mesh_top_blocks):
    each rank's whole-shard transform is all-gathered and composed
    exclusively, where the reference composes in f32 (inexact past 2^24:
    ops/blocked.py compose_summaries_int64); the run max stays within the
    rank, as in the reference, so ``fallback`` keeps its meaning, and
    top_idx is the reference's wherever its f32 sums are exact;
  * every rank receives every rank's summaries and candidates (the
    reference's replicate_out=True, always): each rank finishes the same
    region list.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.blocked import SCREEN_NEG, blocked_scan_summaries_int
from ..ops.gather import SCREEN_SCALE, screen_thr_q
from ..spans.extract import extract_spans
from ..spans.finish import compose_summaries_exact
from ..spans.pipeline import _top_blocks
from ..stats.ranks import chain_ranks_from_mass
from .collectives import DataGroup, all_gather, all_to_all, pmax
from .pipeline import shard_codes
from .sharded import (
    _owner_shift,
    _rank_mass_sharded,
    fill_buckets,
    make_sharded_count_step,
    owner_slots,
)

_NEG64 = -(1 << 62)


def make_sharded_rank_step_wide(grp: DataGroup, k: int,
                                vmax: int = 1 << 14):
    """step(shard_counts [4^k / world], this rank's bins) -> (mass int64
    [4^k / world], clip_overflow bool, vhist int64 [vmax]).

    The reference's wide rank step carries mass and the value histogram
    as exact (hi, lo) int32 pairs; here they are int64 (exact to 2^63).
    vhist, replicated, is the mass per count value (vhist[v] = v * the
    k-mers with count v), from which the host rebuilds the exact f64 rank
    chain of candidate positions (chain_ranks_from_mass).  Count values at
    or above vmax are clipped and flagged.
    """
    _owner_shift(k, grp.size)

    def step(shard_counts):
        return _rank_mass_sharded(grp, shard_counts, vmax)

    return step


def mass_rank_f32(pm: torch.Tensor, total_f32: torch.Tensor) -> torch.Tensor:
    """f32 rank of int64 mass in the reference's operation order:
    (f32(m >> 16) * 65536 + f32(m & 0xFFFF)) / max(total, 1), one rounding
    on the add (ops/wide.py to_f32 on the canonical pair).  A plain
    f32(m) is the same below 2^40 (both round m once) and differs above,
    where f32(m >> 16) rounds too; the integer screen score would then
    move by a unit."""
    f = (pm >> 16).to(torch.float32) * 65536.0 + \
        (pm & 0xFFFF).to(torch.float32)
    return f / torch.clamp(total_f32, min=1.0)


def mesh_top_blocks(grp: DataGroup, tA, tB, maxA, maxB, C: int):
    """This rank's top C block indices (ascending, int64), ranked by run
    max in the exact int64 composition.

    The state entering the rank is the lower ranks' whole-shard
    transforms composed from 0, floored at 0 as in the reference: each
    rank's transform (sum tA, sum tA + max(tB - cumsum tA)) is
    all-gathered and composed in Python integers.  Runs are segmented
    within the rank (spans/pipeline.py _top_blocks).
    """
    a = torch.cumsum(tA.to(torch.int64), 0)
    b = torch.where(tB <= SCREEN_NEG // 2, _NEG64, tB.to(torch.int64))
    tr = all_gather(grp, torch.stack([a[-1], a[-1] + (b - a).max()]))
    x, xb = 0, None
    for A, B in tr[:grp.rank].tolist():
        B = None if B <= _NEG64 // 2 else B
        xb = B if xb is None else (xb + A if B is None else max(xb + A, B))
        x += A
    x_in = max(x, 0) if xb is None else max(x, xb, 0)
    return _top_blocks(tA, tB, maxA, maxB, C, x_in=x_in)


def make_sharded_scan_step(grp: DataGroup, k: int, block: int = 512,
                           cand_blocks: int = 8,
                           bucket_cap: int | None = None):
    """step(bases uint8 [n_local], valid bool [n_local], mass int64
    [4^k / world] (this rank's bins), total, thr) -> (tA, tB, maxA, maxB
    int32 [nb_total], top_idx int64 [world * C] (global block ids), pm
    int64 [world * C, block], scored bool [world * C, block], overflow
    bool), the same on every rank.

    total: the counted k-mers (it enters as f32(total)); thr: float.  The
    host decides exact candidacy from the summaries and flags any block
    it needs that no rank sent (finish_sharded_spans: fallback).
    """
    W = grp.size
    shift = _owner_shift(k, W)
    shard = (1 << (2 * k)) // W
    dev = grp.device

    def step(bases, valid, mass, total, thr):
        codes, kv, scored = shard_codes(grp, bases, valid, k, block)
        nb = codes.shape[0]
        flat = torch.where(kv, codes, -1).reshape(-1)
        del codes, kv
        cap = bucket_cap or (2 * flat.shape[0] // W)
        order, dest, overflow = owner_slots(
            grp, torch.where(flat >= 0, flat >> shift, W), cap)
        recv = all_to_all(grp, fill_buckets(grp, flat[order], dest, cap))
        del flat
        li = (recv - grp.rank * shard).reshape(-1)
        ok = (li >= 0) & (li < shard) & (recv.reshape(-1) >= 0)
        mass = torch.as_tensor(mass, device=dev)
        got = torch.where(ok, mass[li.clamp(0, shard - 1)], 0)
        del recv, li, ok
        back = all_to_all(grp, got.reshape(W, cap)).reshape(-1)
        # element i of the sorted order sits at dest[i]; with no owner
        # (an invalid k-mer) or past the cap (flagged) it reads junk
        pm = torch.empty(order.shape[0], dtype=torch.int64, device=dev)
        pm[order] = back[torch.where(dest < W * cap, dest, 0)]
        del back, order, dest
        thr_q = screen_thr_q(torch.as_tensor(thr, dtype=torch.float32,
                                             device=dev))
        rank_f = mass_rank_f32(pm, torch.as_tensor(total, dtype=torch.float32,
                                                   device=dev))
        tabv = torch.clamp((rank_f * SCREEN_SCALE).to(torch.int32), 0,
                           SCREEN_SCALE) + 1
        s_int = (tabv + 2 - thr_q).reshape(nb, block)
        del rank_f, tabv
        tA, tB, maxA, maxB = blocked_scan_summaries_int(s_int, scored)
        top = mesh_top_blocks(grp, tA, tB, maxA, maxB, min(cand_blocks, nb))
        outs = (tA, tB, maxA, maxB, top + grp.rank * nb,
                pm.reshape(nb, block)[top], scored[top])
        return tuple(all_gather(grp, o, tiled=True) for o in outs) + (
            pmax(grp, overflow),)

    return step


@dataclasses.dataclass
class ShardedScanResult:
    regions: list  # (seq_id, beg, end, score) 1-based last-base coords
    fallback: bool  # a needed block wasn't in any rank's top-C pull
    overflow: bool  # a bucket or the value histogram overflowed (retry)


def candidate_blocks(tA, tB, maxA, maxB, top_idx, min_score: float):
    """The host's exact candidacy: (cand, bool [nb], the blocks whose run
    could reach min_score in the exact int64 composition; missing, some
    candidate is in no rank's pull)."""
    block_max, block_last = compose_summaries_exact(tA, tB, maxA, maxB)
    nb = block_max.shape[0]
    linked = np.zeros(nb, bool)
    linked[1:] = block_last[:-1] > 0
    starts = np.nonzero(~linked)[0]
    run_of = np.cumsum(~linked) - 1
    run_max = np.maximum.reduceat(block_max, starts)[run_of]
    cand = run_max >= float(min_score) * SCREEN_SCALE
    have = np.zeros(nb, bool)
    have[np.asarray(top_idx)] = True
    return cand, bool((cand & ~have).any())


def stretches(cand: np.ndarray):
    """(first, last) block of each maximal stretch of candidate blocks."""
    d = np.diff(np.concatenate([[0], cand.astype(np.int8), [0]]))
    return zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0] - 1)


def finish_sharded_spans(out, n: int, total: int, thr: float,
                         min_width: int, min_score: float, block: int,
                         seq_id: int = 0,
                         value_hist=None) -> ShardedScanResult:
    """Exact host finisher over the sharded scan step's outputs (numpy).

    The int64 composition of the integer summaries gives each block's
    sound bound and the run-aware candidacy; candidate stretches replay
    in f64 from their pulled int64 mass.  value_hist (the wide rank
    step's vhist) rebuilds the reference's exact f64 rank chain
    (chain_ranks_from_mass): emitted scores are bit-identical to the
    sequential oracle.  Without it, ranks are mass / total.
    """
    tA, tB, maxA, maxB, top_idx, pm, scored, overflow = out
    overflow = bool(overflow)
    cand, missing = candidate_blocks(tA, tB, maxA, maxB, top_idx, min_score)
    if not cand.any() or missing:
        return ShardedScanResult([], missing, overflow)
    pos_in_pull = {int(b): i for i, b in enumerate(top_idx)}
    sc = np.asarray(scored)
    # only scored positions carry real mass values; the others read 0, a
    # valid mass
    pm = np.where(sc, np.asarray(pm, np.int64), 0)
    if value_hist is not None:
        # one exact-chain fold for every candidate's mass
        rows = sorted({pos_in_pull[b] for b in np.nonzero(cand)[0]})
        uniq = np.unique(pm[rows])
        ranks_u = chain_ranks_from_mass(uniq, value_hist, total)
    regions = []
    for i, j in stretches(cand):
        rows = [pos_in_pull[b] for b in range(i, j + 1)]
        pm_flat = pm[rows].reshape(-1)
        sc_flat = sc[rows].reshape(-1)
        ranks = (pm_flat / total if value_hist is None
                 else ranks_u[np.searchsorted(uniq, pm_flat)])
        regions += extract_spans(np.where(sc_flat, ranks - thr, 0.0),
                                 sc_flat, min_width, min_score,
                                 seq_id=seq_id, base_pos=i * block)
    return ShardedScanResult(regions, False, overflow)


def local_shard(grp: DataGroup, nbases, block: int):
    """This rank's range of the N-padded genome: (uint8 [n_local] on its
    device, N as 4; n, the padded length).  Only that range of nbases is
    read (a numpy memmap stays on disk elsewhere)."""
    n0 = nbases.shape[0]
    step_n = grp.size * block
    n = -(-n0 // step_n) * step_n
    n_local = n // grp.size
    lo = grp.rank * n_local
    local = np.full(n_local, 4, np.uint8)
    part = np.asarray(nbases[lo:min(n0, lo + n_local)], dtype=np.uint8)
    local[:part.shape[0]] = part
    return torch.from_numpy(local).to(grp.device), n


def sharded_low_comp_regions(
    grp: DataGroup, nbases, k: int, min_width: int, min_score: float,
    thr: float = 0.75, block: int = 512, cand_blocks: int = 8,
    bucket_cap: int | None = None, vmax: int = 1 << 14,
) -> ShardedScanResult:
    """Full sharded pipeline: count -> rank mass -> scan -> exact spans.

    nbases: uint8 genome (4 = N), the same on every rank, of which each
    rank reads its own range; padded with N to a multiple of world *
    block (padding creates and destroys no region).  The 4^k spectrum and
    mass stay sharded end to end; every rank gets the summaries and
    candidates and returns the same regions.  The counted k-mers come
    from the value histogram (its mass sums to them).
    """
    cstep = make_sharded_count_step(grp, k, block=block, bucket_cap=bucket_cap)
    rstep = make_sharded_rank_step_wide(grp, k, vmax=vmax)
    sstep = make_sharded_scan_step(grp, k, block=block,
                                   cand_blocks=cand_blocks,
                                   bucket_cap=bucket_cap)
    local, n = local_shard(grp, nbases, block)
    bases, valid = local & 3, local < 4
    del local
    sh_counts, c_over = cstep(bases, valid)
    mass, clip, vhist = rstep(sh_counts)
    del sh_counts
    total = int(vhist.sum())
    out = sstep(bases, valid, mass, total, thr)
    out_h = tuple(o.cpu().numpy() for o in out)
    clip = bool(clip)
    res = finish_sharded_spans(out_h, n, total, thr, min_width, min_score,
                               block,
                               value_hist=None if clip else
                               vhist.cpu().numpy())
    res.overflow = res.overflow or bool(c_over) or clip
    return res
