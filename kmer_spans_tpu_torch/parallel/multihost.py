"""Multi-process set-up, the distributed pipeline and its dry run.

Counterpart of ``kmer_spans_tpu/parallel/multihost.py``: where the
reference joins jax.distributed and builds one mesh over every device of
the job, the port joins a torch.distributed process group, one process a
rank and a device (parallel/collectives.py DataGroup).  ``initialize``
takes an explicit init method (a ``file://`` store or ``tcp://host:port``)
or torchrun's environment (MASTER_ADDR, RANK, WORLD_SIZE); with neither
it does nothing, as the reference's does in a single process.  NCCL
serves CUDA tensors, gloo CPU tensors; ``backend="gloo"`` with a CUDA
device lets ranks share one card.

Run the mesh on the CPU in two ranks with torchrun, e.g.

    torchrun --nproc_per_node 2 script.py

where script.py calls ``initialize(device="cpu")`` and then
``distributed_low_comp_regions(nbases, ...)``; or on one host without
torchrun through ``launch_local``.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .collectives import DataGroup


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device="cuda",
               backend: str | None = None) -> bool:
    """Join the process group of a multi-process job.

    Returns True if a process group is active.  Without init_method and
    without torchrun's environment it joins nothing and returns False.
    world_size and rank default to the WORLD_SIZE and RANK environment
    variables.  backend: by default NCCL for a CUDA device, gloo for the
    CPU.  A CUDA device without a card raises.
    """
    if dist.is_initialized():
        return True
    torchrun = all(v in os.environ
                   for v in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    if init_method is None and not torchrun:
        return False
    dev = resolve_device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        torch.cuda.set_device(DataGroup.local_device(dev, rank))
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or "env://", world_size=world_size,
        rank=rank)
    return True


def global_data_mesh(device="cuda") -> DataGroup:
    """The DataGroup over every rank of the job, on this rank's device."""
    return DataGroup.of(device)


def launch_local(argv: list, world_size: int, timeout: float = 120.0,
                 env: dict | None = None) -> list:
    """Run ``argv`` as world_size processes on this host and wait for all.

    Rank r gets RANK=r, WORLD_SIZE and LOCAL_RANK=r in its environment, as
    torchrun sets them (pair with initialize(init_method="file://...")).
    The first rank to fail, or the timeout, kills the others (they would
    wait in a collective for ever) and raises RuntimeError with the end
    of its error output.  Returns each rank's standard output.
    """
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for r in range(world_size):
                renv = dict(os.environ if env is None else env,
                            RANK=str(r), WORLD_SIZE=str(world_size),
                            LOCAL_RANK=str(r))
                with open(f"{tmp}/{r}.out", "wb") as out, \
                        open(f"{tmp}/{r}.err", "wb") as err:
                    procs.append(subprocess.Popen(argv, env=renv, stdout=out,
                                                  stderr=err))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    with open(f"{tmp}/{bad[0]}.err", "rb") as f:
                        tail = f.read()[-4000:].decode(errors="replace")
                    raise RuntimeError(f"rank {bad[0]} of {world_size} "
                                       f"exited {codes[bad[0]]}:\n{tail}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{world_size} ranks still running "
                                       f"after {timeout} s: killed")
                time.sleep(0.02)
            outs = []
            for r in range(world_size):
                with open(f"{tmp}/{r}.out", "rb") as f:
                    outs.append(f.read().decode(errors="replace"))
            return outs
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()


def distributed_low_comp_regions(
    nbases, k: int, min_width: int, min_score: float, thr: float = 0.75,
    block: int = 512, cand_blocks: int = 8, bucket_cap: int | None = None,
    vmax: int = 1 << 14, device="cuda",
):
    """The sharded flagship pipeline over every rank of the job.

    Every rank calls this with the same nbases (uint8, N as 4; a numpy
    memmap serves), of which it reads only its own range.  The spectrum
    and mass stay sharded across the ranks; the summaries and candidates
    are all-gathered, so every rank computes the same exact region list.
    Returns a parallel/sharded_scan.py ShardedScanResult.
    """
    from .sharded_scan import sharded_low_comp_regions

    return sharded_low_comp_regions(
        global_data_mesh(device), nbases, k, min_width, min_score, thr=thr,
        block=block, cand_blocks=cand_blocks, bucket_cap=bucket_cap,
        vmax=vmax)


def dryrun_multichip(grp: DataGroup) -> None:
    """The reference's __graft_entry__.dryrun_multichip over ``grp``.

    The reference's sizes at its 8 devices, whatever the world size: a
    genome of 512 * max(world, 8) bases from seed 1, the k = 5 mesh step
    over it; where the world size is a power of two, the sharded count
    and rank mass, the sharded scan against the sequential oracle (an AG
    island planted, block 128, C = 8 a rank at 8 ranks and as many blocks
    in all at fewer, a bucket cap of the shard's length: the island routes
    most of a shard's codes to one owner) and the wide k = 17 scan against
    the oracle over a SparseRanks lookup.  Raises
    AssertionError on any difference.
    """
    from ..oracle import (
        count_spectrum,
        count_spectrum_sparse,
        find_regions,
        weighted_ranks,
    )
    from ..stats.ranks import SparseRanks
    from .pipeline import make_pipeline_step
    from .sharded import make_sharded_count_step, make_sharded_rank_step
    from .sharded_scan import sharded_low_comp_regions
    from .wide_scan import wide_low_comp_regions
    from .collectives import psum

    W = grp.size
    k = 5
    C = 8 * max(1, 8 // W)
    n = 512 * max(W, 8)
    rng = np.random.default_rng(1)
    bases = rng.integers(0, 4, size=n, dtype=np.uint8)
    valid = rng.random(n) > 0.02
    mine = slice(grp.rank * n // W, (grp.rank + 1) * n // W)
    counts, S, scored = make_pipeline_step(grp, k)(bases[mine], valid[mine],
                                                   0.6)
    assert counts.shape == (1 << (2 * k),)
    assert S.shape == scored.shape == (n // W,)
    assert int(counts.sum()) > 0
    if W & (W - 1):
        return
    sh_counts, overflow = make_sharded_count_step(grp, k)(bases[mine],
                                                          valid[mine])
    mass, _ = make_sharded_rank_step(grp, k)(sh_counts)
    assert sh_counts.shape == mass.shape == ((1 << (2 * k)) // W,)
    assert not bool(overflow)
    assert int(psum(grp, sh_counts.sum())) == int(counts.sum())

    nb2 = np.where(valid, bases, 4).astype(np.uint8)
    i0 = max(64, n // 4)
    reps = min(200, (n - i0) // 4)
    nb2[i0:i0 + 2 * reps] = np.tile(np.array([0, 3], np.uint8), reps)
    seq = np.frombuffer(b"ACTGN", dtype=np.uint8)[np.minimum(nb2, 4)]
    seq = seq.tobytes()
    res = sharded_low_comp_regions(grp, nb2, k, min_width=30, min_score=5.0,
                                   thr=0.7, block=128, cand_blocks=C,
                                   bucket_cap=n // W)
    assert not res.fallback and not res.overflow
    oc, nw = count_spectrum(seq, k)
    want = find_regions(seq, 0, 30, 5.0, weighted_ranks(oc, float(nw)), k,
                        0.7)
    got = [(r[1], r[2], r[3]) for r in res.regions]
    assert got == [(e[1], e[2], e[3]) for e in want] and got, (got, want)

    kw = 17
    res_w = wide_low_comp_regions(grp, nb2, kw, min_width=30, min_score=5.0,
                                  thr=0.7, block=128, cand_blocks=C)
    assert not res_w.fallback and not res_w.overflow
    ucodes, ucounts, _ = count_spectrum_sparse(seq, kw)
    want_w = find_regions(seq, 0, 30, 5.0, SparseRanks(ucodes, ucounts), kw,
                          0.7)
    got_w = [(r[1], r[2], r[3]) for r in res_w.regions]
    assert got_w == [(e[1], e[2], e[3]) for e in want_w] and got_w, (
        got_w, want_w)
