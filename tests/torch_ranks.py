"""Gloo ranks for the port's multi-device tests (not a test file).

A test file of the multi-device paths is also its own rank worker: run as
a script, ``worker(run_case)`` joins a gloo group of 4 CPU processes
through a ``file://`` store in its work directory (no TCP port, so test
workers cannot collide), makes the sub-groups of the first 1 and 2 ranks
(4 is the default group), and in each runs every case of ``cases.json``
on the arrays of ``inputs.npz`` through ``run_case(grp, name, spec,
arrays)``, writing ``w{world}r{rank}.npz``.  The test process starts the
ranks once per file (``start``, in a background thread, so the JAX side
runs meanwhile) and reads the outputs.  The worker imports the port
only, never JAX.
"""

from __future__ import annotations

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
WORLDS = (1, 2, 4)
TIMEOUT = 120.0


def start(test_file, workdir: Path, cases: dict, arrays: dict):
    """Start ``test_file``'s worker in 4 ranks; returns a future of
    {world: [rank 0's outputs, rank 1's, ...]}, each a dict of arrays
    keyed "case/name"."""
    (workdir / "cases.json").write_text(json.dumps(cases))
    np.savez(workdir / "inputs.npz", **arrays)

    def run():
        from kmer_spans_tpu_torch.parallel.multihost import launch_local

        launch_local([sys.executable, str(test_file), str(workdir)],
                     max(WORLDS), TIMEOUT,
                     env=dict(os.environ, PYTHONPATH=str(ROOT),
                              OMP_NUM_THREADS="1"))
        return {w: [dict(np.load(workdir / f"w{w}r{r}.npz"))
                    for r in range(w)] for w in WORLDS}

    pool = ThreadPoolExecutor(1)
    fut = pool.submit(run)
    pool.shutdown(wait=False)
    return fut


def worker(run_case) -> None:
    """The ``__main__`` of a multi-device test file (argv: the work
    directory)."""
    workdir = Path(sys.argv[1])
    import torch.distributed as dist

    from kmer_spans_tpu_torch.parallel.collectives import DataGroup
    from kmer_spans_tpu_torch.parallel.multihost import initialize

    initialize("file://" + str(workdir / "store"), device="cpu")
    cases = json.loads((workdir / "cases.json").read_text())
    with np.load(workdir / "inputs.npz") as f:
        arrays = dict(f)
    for w in WORLDS:
        # the whole job is the default group, as a user's would be
        group = None if w == max(WORLDS) else dist.new_group(list(range(w)))
        if dist.get_rank() >= w:
            continue
        grp = DataGroup.of("cpu", group)
        out = {}
        for name, spec in cases.items():
            if w in spec.get("worlds", WORLDS):
                for key, v in run_case(grp, name, spec, arrays).items():
                    out[f"{name}/{key}"] = np.asarray(v)
        np.savez(workdir / f"w{w}r{grp.rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


def shard(x: np.ndarray, grp) -> np.ndarray:
    """Rank grp.rank's contiguous part of x."""
    n = x.shape[0] // grp.size
    return x[grp.rank * n:(grp.rank + 1) * n]
