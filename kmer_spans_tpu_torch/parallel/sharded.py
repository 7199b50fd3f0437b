"""Hash-sharded spectrum: counting and rank mass for k too large to
replicate.

Counterpart of ``kmer_spans_tpu/parallel/sharded.py``.  At k = 13 a dense
spectrum is 4^13 counts on every rank; here rank d owns the codes
[d, d + 1) * 4^k / world (the code's high bits), so no rank holds the
table.

Counting (make_sharded_count_step): each rank builds its shard's codes
(with the halo), stably sorts them by owner, writes each owner's codes
into a fixed-capacity bucket, and one all_to_all delivers every bucket;
each owner counts what it received with K3 into its 4^k / world bins.  A
bucket that overflows sets the overflow flag, as in the reference, and
its extra codes are not counted: the caller retries with a larger cap.

Rank mass (make_sharded_rank_step, _wide): mass[i] = the mass of counts
below c_i globally + the mass of counts equal to c_i on lower ranks + the
mass of counts equal to c_i at a lower index here.  High-bit sharding
makes rank order code order, so this is the reference's stable
(count, index) order.  A value histogram of the mass (psum'd) gives the
first two terms, a stable sort of the shard the third.  Count values at
or above vmax are clipped and flagged (clip_overflow).

Differences from the reference: group starts come from head flags
(nonzero plus a cumsum, ops/pmscreen.py _runs), not a 1-D running max;
the mass and its histogram are int64 where the reference's narrow step
keeps int32 that wraps past 2^31 counted k-mers and its wide step carries
(hi, lo) int32 pairs (ops/wide.py, a TPU measure: the port splits a value
into (m >> 16, m & 0xFFFF) only where a test compares it with a pair).
"""

from __future__ import annotations

import torch

from ..ops import histogram
from ..ops.pmscreen import _first_in_run, _runs
from .collectives import DataGroup, all_gather, all_to_all, pmax, psum
from .pipeline import shard_codes


def _owner_shift(k: int, n_dev: int) -> int:
    ld = n_dev.bit_length() - 1
    if (1 << ld) != n_dev:
        raise ValueError("device count must be a power of two")
    if 2 * k < ld:
        raise ValueError("4^k smaller than device count")
    return 2 * k - ld


def owner_slots(grp: DataGroup, owner: torch.Tensor, cap: int):
    """Slots in fixed-capacity buckets for elements bound to owners.

    owner: int32 [m], the owning rank, or grp.size for an element that
    goes nowhere.  The elements are stably sorted by owner, and element i
    of an owner's group takes slot i of its bucket.  Returns (order, the
    sorted elements' indices; dest, each sorted element's flat index in
    the [world * cap] buckets, world * cap (a sink) past the cap or for
    no owner; overflow, a bool tensor: some owner had more than cap).
    """
    W = grp.size
    owner_s, order = torch.sort(owner, stable=True)
    run, starts = _runs(_first_in_run(owner_s))
    rank = torch.arange(owner_s.shape[0], device=owner.device) - starts[run]
    fits = rank < cap
    real = owner_s < W
    dest = torch.where(fits & real, owner_s.to(torch.int64) * cap + rank,
                       W * cap)
    return order, dest, ((~fits) & real).any()


def fill_buckets(grp: DataGroup, values: torch.Tensor, dest: torch.Tensor,
                 cap: int, fill: int = -1) -> torch.Tensor:
    """[world, cap] buckets holding values[i] at dest[i] (owner_slots),
    ``fill`` where empty; what went to the sink is dropped."""
    buckets = torch.full((grp.size * cap + 1,), fill, dtype=values.dtype,
                         device=values.device)
    buckets[dest] = values
    return buckets[:-1].reshape(grp.size, cap)


def make_sharded_count_step(grp: DataGroup, k: int, block: int = 512,
                            bucket_cap: int | None = None):
    """step(bases uint8 [n_local], valid bool [n_local]) -> (shard_counts
    int32 [4^k / world], this rank's bins; overflow bool, on every rank).

    bucket_cap: the per-destination capacity per rank, by default twice
    the balanced share (2 * n_local / world), the reference's.
    """
    W = grp.size
    shift = _owner_shift(k, W)
    shard = (1 << (2 * k)) // W

    def step(bases, valid):
        codes, kv, _ = shard_codes(grp, bases, valid, k, block)
        flat = torch.where(kv, codes, -1).reshape(-1)
        del codes, kv
        cap = bucket_cap or (2 * flat.shape[0] // W)
        order, dest, overflow = owner_slots(
            grp, torch.where(flat >= 0, flat >> shift, W), cap)
        recv = all_to_all(grp, fill_buckets(grp, flat[order], dest, cap))
        del flat, order, dest
        counts = histogram.histogram(recv - grp.rank * shard, recv >= 0,
                                     shard)
        return counts, pmax(grp, overflow)

    return step


def _rank_mass_sharded(grp: DataGroup, c: torch.Tensor, vmax: int):
    """(mass int64 [shard], clip_overflow bool, value histogram int64
    [vmax], replicated) of one rank's shard of the spectrum."""
    c = torch.as_tensor(c, device=grp.device).to(torch.int64)
    clipped = torch.clamp(c, max=vmax - 1)
    clip = pmax(grp, (c >= vmax).any())
    vh = torch.zeros(vmax, dtype=torch.int64, device=c.device).index_add_(
        0, clipped, c)
    global_vh = psum(grp, vh)
    below = torch.cumsum(global_vh, 0) - global_vh
    earlier = all_gather(grp, vh)[:grp.rank].sum(0)
    # equal values at a lower local index: exclusive cumsum over the
    # stable sort by value, less the cumsum at each value group's head.
    # A zero count's mass is 0 (nothing precedes it but zeros), so only
    # the nonzero counts are sorted: most of a sparse 4^k shard is zero.
    nz = torch.nonzero(c).squeeze(1)
    cz = clipped[nz].to(torch.int32)
    cz, order = torch.sort(cz, stable=True)
    nz = nz[order]
    sc = c[nz]
    excl = torch.cumsum(sc, 0) - sc
    run, starts = _runs(_first_in_run(cz))
    mass = torch.zeros_like(c)
    mass[nz] = below[cz] + earlier[cz] + excl - excl[starts][run]
    return mass, clip, global_vh


def make_sharded_rank_step(grp: DataGroup, k: int, vmax: int = 1 << 14):
    """step(shard_counts [4^k / world], this rank's bins) -> (mass int64
    [4^k / world], clip_overflow bool).

    mass[i]: the counted k-mer instances before k-mer i in the stable
    (count asc, index asc) order, the integer numerator of its rank.
    Exact for count values below vmax; larger values set clip_overflow.
    The reference's int32 mass wraps past 2^31 instances; this one is
    int64, as make_sharded_rank_step_wide's.
    """
    _owner_shift(k, grp.size)

    def step(shard_counts):
        mass, clip, _ = _rank_mass_sharded(grp, shard_counts, vmax)
        return mass, clip

    return step
