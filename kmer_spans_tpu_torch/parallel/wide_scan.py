"""Sharded sparse-spectrum span scan for wide codes (16 <= k <= 23).

Counterpart of ``kmer_spans_tpu/parallel/wide_scan.py``.  At k = 17 a
dense spectrum is 4^17 counts; a genome's spectrum is sparse (at most n
distinct codes), so it exists only as sorted runs, sharded by code range
(the owner of a code is its top log2(world) bits):

  1. every rank builds its shard's int64 wide codes (with the halos) and
     sorts them stably: a run's length is its k-mer's local count;
  2. each run head ships (code, local count) to its owner through one
     fixed-capacity all_to_all;
  3. owners sort what they received; a code's global count is the sum of
     its local counts; the owners' run histograms by count value and by
     (value, high byte) (K3, twice: ops/sortscreen.py rank_ub_histograms)
     are psum'd into the global rank-upper-bound tables, vmax + v2 * 256
     entries, never 4^k;
  4. a second all_to_all returns each run's global count; every position
     of the run gathers its integer screen score from the tables (K4:
     rank_ub_gather), back in genome order; then the integer summaries
     and each rank's top C candidate blocks, with their codes.

The owners' merged runs are the global sparse spectrum, sharded by code
range: gathered in rank order they come out sorted, and the host
finisher replays candidates from them, bit-identical to the sequential
oracle over a SparseRanks lookup.

Differences from the reference: one int64 code with one sort key where
the reference sorts an (hi, lo) int32 pair with two (the sentinel 2^46 is
its (2^30, 0) pair); the runs travel as (int64 code, int32 count) in two
buckets, not one [.., 3] int32 bucket; only run heads are sorted by owner,
and only received runs are merged; group starts come from head flags
(ops/pmscreen.py _runs), not a running max; the top C is ordered by the
exact int64 composition (sharded_scan.mesh_top_blocks); the reference
recounts the spectrum on the host (native.host_spectrum_sparse), the
port takes the owners' runs.  The total stays int32, as in the reference:
inputs of 2^31 bases or more raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.blocked import (
    WIDE_MAX_K,
    blocked_codes_wide,
    blocked_scan_summaries_int,
)
from ..ops.gather import SCREEN_SCALE, screen_thr_q
from ..ops.pmscreen import _first_in_run, _runs
from ..ops.sortscreen import (
    rank_ub_gather,
    rank_ub_histograms,
    rank_ub_tables,
    runs_kind,
)
from ..spans.extract import extract_spans
from ..stats.ranks import chain_ranks_from_mass, sparse_mass
from .collectives import (
    DataGroup,
    all_gather,
    all_gather_ragged,
    all_to_all,
    pmax,
    psum,
)
from .pipeline import shard_codes
from .sharded import fill_buckets, owner_slots
from .sharded_scan import (
    candidate_blocks,
    local_shard,
    mesh_top_blocks,
    stretches,
)

#: sorts after every wide code (codes < 4^23 = 2^46)
_SENT = 1 << 46


def make_wide_sharded_scan(grp: DataGroup, k: int, block: int = 512,
                           cand_blocks: int = 8,
                           bucket_cap: int | None = None,
                           vmax: int = 1 << 12, v2: int = 1 << 8):
    """step(bases uint8 [n_local], valid bool [n_local], thr) -> (tA, tB,
    maxA, maxB int32 [nb_total], top_idx int64 [world * C] (global block
    ids), codes int64 [world * C, block], scored bool [world * C, block],
    total int32, overflow bool, spectrum codes int64 [distinct] ascending,
    spectrum counts int64 [distinct]), the same on every rank.

    bucket_cap bounds each (rank, owner) run exchange, by default
    max(64, 2 * n_local / world); an overflow is flagged, never silent:
    retry with a larger cap.
    """
    if not 16 <= k <= WIDE_MAX_K:
        raise ValueError(f"wide codes need 16 <= k <= {WIDE_MAX_K}")
    W = grp.size
    ld = W.bit_length() - 1
    if (1 << ld) != W:
        raise ValueError("device count must be a power of two")
    own_shift = 2 * k - ld
    dev = grp.device

    def step(bases, valid, thr):
        n_local = bases.shape[0]
        # the total and the owners' mass sums are int32, as in the
        # reference: longer inputs go through the chunked stream
        if n_local * W >= (1 << 31):
            raise ValueError(
                "wide sharded scan accumulates mass in int32: total bases "
                f"{n_local * W:,} >= 2^31 could overflow; chunk the genome "
                "(stream) above ~2.1 Gb")
        codes, kv, scored = shard_codes(grp, bases, valid, k, block,
                                        blocked_codes_wide)
        nb = codes.shape[0]
        total = psum(grp, kv.sum(dtype=torch.int32))
        skey, spos = torch.sort(torch.where(kv, codes, _SENT).reshape(-1),
                                stable=True)
        del kv
        # local runs: a run's length is its code's local count; the real
        # runs lead, the invalid positions' run (if any) is last
        run, starts = _runs(_first_in_run(skey))
        lengths = torch.diff(starts, append=starts.new_tensor(
            [skey.shape[0]]))
        real = int((skey[starts] < _SENT).sum())
        # ship the run heads to their owners (owners ascend with the code)
        cap = bucket_cap or max(64, 2 * n_local // W)
        order, dest, overflow = owner_slots(
            grp, (skey[starts[:real]] >> own_shift).to(torch.int32), cap)
        rcode = all_to_all(grp, fill_buckets(grp, skey[starts[order]], dest,
                                             cap))
        rcount = all_to_all(grp, fill_buckets(
            grp, lengths[order].to(torch.int32), dest, cap))
        # owners merge: a code's global count is the sum of its runs'
        got = torch.nonzero(rcode.reshape(-1) >= 0).squeeze(1)
        mkey, morder = torch.sort(rcode.reshape(-1)[got], stable=True)
        mcount = rcount.reshape(-1)[got][morder].to(torch.int64)
        del rcode, rcount
        mhead = _first_in_run(mkey)
        mrun, mstarts = _runs(mhead)
        cs = torch.cumsum(mcount, 0)
        g_run = torch.diff(cs[mstarts] - mcount[mstarts],
                           append=cs[-1:])  # each merged run's total
        g_tot = g_run.to(torch.int32)[mrun]
        # the global tables: each owner's run histograms (K3 x2), psum'd
        hb = ((mkey >> (2 * k - 8)) & 255).to(torch.int32)
        vh_runs, h2 = rank_ub_histograms(g_tot, hb, mhead, vmax, v2,
                                         runs_kind(n_local * W, k))
        words = rank_ub_tables(psum(grp, vh_runs), psum(grp, h2), total,
                               vmax, v2)
        # return each run's global count to the rank that sent it (past
        # the cap, flagged, a run reads junk)
        gret = torch.zeros(W * cap, dtype=torch.int32, device=dev)
        gret[got[morder]] = g_tot
        back = all_to_all(grp, gret.reshape(W, cap)).reshape(-1)
        g_local = torch.zeros(starts.shape[0], dtype=torch.int32, device=dev)
        g_local[order] = back[torch.where(dest < W * cap, dest, 0)]
        del gret, back
        # screen scores in the sorted order (K4), back to genome order
        s_sorted = rank_ub_gather(
            words, g_local[run], ((skey >> (2 * k - 8)) & 255).to(
                torch.int32), screen_thr_q(torch.as_tensor(
                    thr, dtype=torch.float32, device=dev)), vmax, v2)
        s_int = torch.empty_like(s_sorted)
        s_int[spos] = s_sorted
        del s_sorted, spos, skey, run
        tA, tB, maxA, maxB = blocked_scan_summaries_int(
            s_int.reshape(nb, block), scored)
        top = mesh_top_blocks(grp, tA, tB, maxA, maxB, min(cand_blocks, nb))
        outs = (tA, tB, maxA, maxB, top + grp.rank * nb, codes[top],
                scored[top])
        return tuple(all_gather(grp, o, tiled=True) for o in outs) + (
            total, pmax(grp, overflow),
            all_gather_ragged(grp, mkey[mstarts]),
            all_gather_ragged(grp, g_run))

    return step


@dataclasses.dataclass
class WideShardedResult:
    regions: list   # (seq_id, beg, end, score) 1-based last-base coords
    fallback: bool  # a needed block wasn't in any rank's top-C pull
    overflow: bool  # the run exchange's bucket capacity overflowed (retry)


def finish_wide_sharded(out, n: int, k: int, thr: float, min_width: int,
                        min_score: float, spectrum, block: int,
                        seq_id: int = 0) -> WideShardedResult:
    """Exact host finisher: int64 candidacy and the sparse f64 chain.

    out: the wide step's outputs (numpy); spectrum: (ucodes ascending,
    ucounts, total), the owners' runs (or any sparse recount).  Emitted
    scores are bit-identical to the sequential oracle over SparseRanks of
    the same spectrum.
    """
    tA, tB, maxA, maxB, top_idx, codes, scored, total_dev, overflow = out[:9]
    overflow = bool(overflow)
    cand, missing = candidate_blocks(tA, tB, maxA, maxB, top_idx, min_score)
    if not cand.any() or missing:
        return WideShardedResult([], missing, overflow)
    ucodes, ucounts, total = spectrum
    ucodes = np.asarray(ucodes, np.int64)
    if total != int(total_dev):
        raise ValueError(f"spectrum total {total} != the device's "
                         f"{int(total_dev)}")
    pm_all, vhist, _ = sparse_mass(ucodes, ucounts)
    pos_in_pull = {int(b): i for i, b in enumerate(top_idx)}
    codes = np.asarray(codes, np.int64)
    sc = np.asarray(scored)
    rows_all = sorted({pos_in_pull[b] for b in np.nonzero(cand)[0]})
    uniq = np.unique(codes[rows_all][sc[rows_all]])
    idx_u = np.minimum(np.searchsorted(ucodes, uniq),
                       max(len(ucodes) - 1, 0))
    ranks_u = chain_ranks_from_mass(pm_all[idx_u], vhist, total)
    regions = []
    for i, j in stretches(cand):
        rows = [pos_in_pull[b] for b in range(i, j + 1)]
        c_flat = codes[rows].reshape(-1)
        sc_flat = sc[rows].reshape(-1)
        qi = np.minimum(np.searchsorted(uniq, c_flat),
                        max(len(uniq) - 1, 0))
        regions += extract_spans(np.where(sc_flat, ranks_u[qi] - thr, 0.0),
                                 sc_flat, min_width, min_score,
                                 seq_id=seq_id, base_pos=i * block)
    return WideShardedResult(regions, False, overflow)


def wide_low_comp_regions(
    grp: DataGroup, nbases, k: int, min_width: int, min_score: float,
    thr: float = 0.75, block: int = 512, cand_blocks: int = 8,
    bucket_cap: int | None = None,
) -> WideShardedResult:
    """Full sharded wide-k pipeline: the scan over the group, the owners'
    runs as the sparse spectrum, exact spans.  nbases: uint8 genome (4 =
    N), the same on every rank, of which each rank reads its own range;
    padded with N to a multiple of world * block."""
    fn = make_wide_sharded_scan(grp, k, block=block, cand_blocks=cand_blocks,
                                bucket_cap=bucket_cap)
    local, n = local_shard(grp, nbases, block)
    out = tuple(o.cpu().numpy() for o in fn(local & 3, local < 4, thr))
    spectrum = (out[9], out[10], int(out[7]))
    return finish_wide_sharded(out, n, k, thr, min_width, min_score,
                               spectrum, block)
