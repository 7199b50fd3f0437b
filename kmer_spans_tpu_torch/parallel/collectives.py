"""Collectives of the multi-device paths, on torch.distributed.

The reference runs its mesh paths as one program over many devices
(jax.shard_map over the ``data`` axis).  The port runs one process per
rank, each on one device, and speaks to the others through a process
group: NCCL for CUDA tensors, gloo for CPU tensors (and, where two ranks
share one card, for CUDA tensors too).  ``DataGroup`` takes the place of
the reference's Mesh; the functions here take the places of its
collectives:

    jax.lax.ppermute of the halos   ->  halo_exchange (an all_gather of
                                        the few bytes, both directions)
    jax.lax.psum / pmax             ->  psum / pmax (all_reduce SUM / MAX)
    jax.lax.all_gather              ->  all_gather (the list form, which
                                        every torch version has)
    jax.lax.all_to_all (tiled=False)->  all_to_all (all_to_all_single on
                                        the contiguous [world, cap, ...])

Flags travel as int32, so NCCL and gloo treat them alike.  At world size
1 every function still calls its collective: nothing short-circuits, so
the NCCL path runs on one card as it does on many.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """One rank's view of the data axis: its rank, the world size, its
    device and the process group (None: the default group)."""

    rank: int
    size: int
    device: torch.device
    group: object = None

    @classmethod
    def of(cls, device="cuda", group=None) -> "DataGroup":
        """The group as this process sees it, on ``device``
        (local_device).  A CUDA device without a card raises."""
        if not dist.is_initialized():
            raise RuntimeError("no process group: call "
                               "parallel.multihost.initialize first")
        rank = dist.get_rank(group)
        return cls(rank, dist.get_world_size(group),
                   cls.local_device(device, rank), group)

    @staticmethod
    def local_device(device, rank: int) -> torch.device:
        """``device``, where a bare "cuda" takes the card of the local
        rank (torchrun's LOCAL_RANK, else the rank) modulo the cards
        present: ranks beyond the cards share them."""
        dev = resolve_device(device)
        if dev.type == "cuda" and torch.device(device).index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        return dev


def psum(grp: DataGroup, x: torch.Tensor) -> torch.Tensor:
    """The elementwise sum over the ranks (a new tensor)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=grp.group)
    return out


def pmax(grp: DataGroup, flag: torch.Tensor) -> torch.Tensor:
    """True on every rank where any rank's flag is (a bool tensor)."""
    out = flag.to(torch.int32)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=grp.group)
    return out.to(torch.bool)


def all_gather(grp: DataGroup, x: torch.Tensor,
               tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` in rank order: [world, *x.shape], or
    concatenated along dim 0 when ``tiled``.  bool travels as uint8."""
    flag = x.dtype == torch.bool
    x = (x.to(torch.uint8) if flag else x).contiguous()
    parts = [torch.empty_like(x) for _ in range(grp.size)]
    dist.all_gather(parts, x, group=grp.group)
    out = torch.cat(parts) if tiled else torch.stack(parts)
    return out.to(torch.bool) if flag else out


def all_gather_ragged(grp: DataGroup, x: torch.Tensor) -> torch.Tensor:
    """Every rank's 1-D ``x``, whatever its length, concatenated in rank
    order (lengths gathered first, then the rows padded to the longest)."""
    n = all_gather(grp, torch.tensor([x.shape[0]], dtype=torch.int64,
                                     device=x.device)).reshape(-1).tolist()
    pad = torch.zeros(max(n), dtype=x.dtype, device=x.device)
    pad[:x.shape[0]] = x
    rows = all_gather(grp, pad)
    return torch.cat([rows[r, :n[r]] for r in range(grp.size)])


def all_to_all(grp: DataGroup, x: torch.Tensor) -> torch.Tensor:
    """Row r of ``x`` ([world, ...]) goes to rank r; row r of the result
    came from rank r."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=grp.group)
    return out


def halo_exchange(grp: DataGroup, bases: torch.Tensor, valid: torch.Tensor,
                  h: int):
    """The halos of this rank's shard: the previous rank's last h bases
    and their validity (None when h = 0), and the next rank's first
    validity.  Rank 0 has no predecessor and the last rank no successor:
    their incoming validity is False (at world size 1 rank 0 receives its
    own tail, masked the same way).

    Returns (first_bases int32 [h], first_valid bool [h], next_valid bool
    [1]) for ops/blocked.py blocked_codes and blocked_scored.
    """
    mine = torch.cat([bases[bases.shape[0] - h:].to(torch.int32),
                      valid[valid.shape[0] - h:].to(torch.int32),
                      valid[:1].to(torch.int32)])
    rows = all_gather(grp, mine)
    prev = rows[(grp.rank - 1) % grp.size]
    nxt = rows[(grp.rank + 1) % grp.size]
    next_valid = nxt[2 * h:] > 0
    if grp.rank == grp.size - 1:
        next_valid = torch.zeros_like(next_valid)
    if h == 0:
        return None, None, next_valid
    first_valid = prev[h:2 * h] > 0
    if grp.rank == 0:
        first_valid = torch.zeros_like(first_valid)
    return prev[:h], first_valid, next_valid
