"""The multi-device count -> rank -> scan step, and the integer rank mass.

Counterpart of ``kmer_spans_tpu/parallel/pipeline.py``.  The genome is
split into contiguous shards, one a rank (parallel/collectives.py
DataGroup); the k-1 tail of the previous shard and the first validity of
the next one arrive by halo_exchange, so every rank scores exactly the
positions the sequential reference would.  Each rank counts its shard's
k-mers with K3 (ops/histogram.py, the function of the reference's
scatter-add) and the partial spectra are psum'd into the replicated 4^k
table.  Ranks are the integer mass of the stably sorted spectrum
(``_rank_mass``), s is computed in f32 in the reference's operation order,
and the scan is the closed-form blocked prefix of ops/blocked.py
(blocked_scan_prefixes), each rank's total transform all-gathered and
composed exclusively for its incoming state.
"""

from __future__ import annotations

import torch

from ..ops import histogram
from ..ops.blocked import blocked_codes, blocked_scan_prefixes, blocked_scored
from .collectives import DataGroup, all_gather, halo_exchange, psum


def _rank_mass(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative mass of the stably sorted spectrum, scattered
    back to k-mer order: rank[kmer] = mass[kmer] / total, ties broken by
    k-mer index.  int32 in, int32 out (the mass of n positions is below
    2^31 for n < 2^31).
    """
    order = torch.sort(counts, stable=True).indices
    excl = torch.zeros_like(counts)
    excl[1:] = torch.cumsum(counts[order][:-1], 0)
    mass = torch.empty_like(counts)
    mass[order] = excl
    return mass


def shard_inputs(grp: DataGroup, bases, valid):
    """bases (uint8) and valid (bool) of this rank's shard on its device."""
    bases = torch.as_tensor(bases, device=grp.device)
    valid = torch.as_tensor(valid, device=grp.device)
    if bases.dtype != torch.uint8 or valid.dtype != torch.bool or \
            bases.shape != valid.shape or bases.dim() != 1:
        raise TypeError("bases must be uint8 and valid bool, both 1-D of one "
                        "length")
    return bases, valid


def shard_codes(grp: DataGroup, bases, valid, k: int, block: int,
                codes_fn=blocked_codes):
    """This rank's blocked codes with the halos: (codes [nb, block], int32
    from blocked_codes or int64 from ops/blocked.py blocked_codes_wide;
    kmer_valid, scored, bool [nb, block])."""
    bases, valid = shard_inputs(grp, bases, valid)
    n_local = bases.shape[0]
    if n_local % block or n_local == 0:
        raise ValueError(f"shard of {n_local} is not a positive multiple of "
                         f"{block}")
    nb = n_local // block
    hb, hv, next_v = halo_exchange(grp, bases, valid, k - 1)
    v2 = valid.reshape(nb, block)
    codes, kv = codes_fn(bases.reshape(nb, block), v2, k, first_bases=hb,
                         first_valid=hv)
    return codes, kv, blocked_scored(v2, kv, next_valid=next_v)


def make_pipeline_step(grp: DataGroup, k: int, block: int = 512):
    """The multi-device step of the flagship pipeline over ``grp``.

    Returns step(bases uint8 [n_local], valid bool [n_local], thr) ->
    (counts int32 [4^k], the replicated spectrum; S float32 [n_local];
    scored bool [n_local]), each rank passing its own contiguous shard of
    the genome (rank r holds positions r * n_local ..), n_local a multiple
    of ``block``.  S is the running score of the reference's recurrence
    from 0 at the genome start.
    """

    def step(bases, valid, thr):
        code, kmer_valid, scored = shard_codes(grp, bases, valid, k, block)
        code = torch.where(kmer_valid, code, 0)
        counts = psum(grp, histogram.count_spectrum(code, kmer_valid, k))
        del kmer_valid
        # ranks as integer mass; s in f32 (exact sign by the integer
        # comparison), in the reference's order: (f32(mass) - thr*total)
        # / total
        total = counts.sum().to(torch.float32)
        thr_mass = torch.as_tensor(thr, dtype=torch.float32,
                                   device=grp.device) * total
        s = (_rank_mass(counts)[code].to(torch.float32) - thr_mass) / total
        del code
        FA, FB, (tA, tB) = blocked_scan_prefixes(s, scored)
        del s
        # exclusive composition of the lower ranks' transforms, from 0
        tr = all_gather(grp, torch.stack([tA, tB])).tolist()
        s_in = 0.0
        for a, b in tr[:grp.rank]:
            s_in = max(s_in + a, b)
        S = torch.maximum(s_in + FA, FB).to(torch.float32)
        return counts, S.reshape(-1), scored.reshape(-1)

    return step


def data_mesh(n_devices: int | None = None, device="cuda") -> DataGroup:
    """The DataGroup of the default process group on ``device``: the
    port's counterpart of a mesh over the first n devices.  n_devices,
    where given, must equal the world size (a process drives one device).
    """
    grp = DataGroup.of(device)
    if n_devices is not None and n_devices != grp.size:
        raise ValueError(f"the process group holds {grp.size} ranks, not "
                         f"{n_devices}")
    return grp
