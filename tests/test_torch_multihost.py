"""The port's multi-process entry points (kmer_spans_tpu_torch/parallel/
multihost.py) against the JAX mesh and the sequential oracle.

tests/test_multihost.py runs two jax.distributed processes of 4 devices
each over a 16384-base genome; here the same genome goes through
``distributed_low_comp_regions`` in 4 gloo ranks (the job's default
group) and through sharded_low_comp_regions, which it calls, in the
sub-groups of the first 1 and 2 ranks (tests/torch_ranks.py: this file
is its own rank worker).  Every rank reads only its own range and emits
the same regions, equal to the JAX mesh's of the same size and, f64
scores ==, to the oracle's.  Also the port's dryrun_multichip at each
size, and initialize / launch_local on their own.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import torch_ranks
from torch_ranks import WORLDS

K, MIN_W, MIN_S, THR, BLOCK = 5, 30, 5.0, 0.7, 256
#: candidate blocks in all (C a rank), and a bucket cap no shard can
#: overflow: test_multihost.py's 8 a device at 8 devices, its 8192 cap
#: for 2048-base shards
PULLS, CAP = 64, 16_384


def _genome():
    """test_multihost.py's 16384-base genome (4 = N)."""
    rng = np.random.default_rng(5)
    nb = rng.integers(0, 4, 16384, np.uint8)
    nb[3000:3400] = np.tile(np.array([1, 2], np.uint8), 200)
    nb[12000:12600] = np.tile(np.array([0, 3], np.uint8), 300)
    nb[8000:8040] = 4
    return nb


def _run_case(grp, name, spec, arrays):
    """One case on this rank (in the worker)."""
    from kmer_spans_tpu_torch.parallel.multihost import (
        distributed_low_comp_regions,
        dryrun_multichip,
    )
    from kmer_spans_tpu_torch.parallel.sharded_scan import (
        sharded_low_comp_regions,
    )

    if name == "dryrun":
        dryrun_multichip(grp)
        if grp.group is None:  # the job's group, as a user gets it
            from kmer_spans_tpu_torch.parallel.multihost import (
                global_data_mesh,
            )
            from kmer_spans_tpu_torch.parallel.pipeline import data_mesh

            assert global_data_mesh("cpu") == data_mesh(grp.size, "cpu") \
                == grp
            try:
                data_mesh(grp.size + 1, "cpu")
            except ValueError:
                pass
            else:
                raise AssertionError("data_mesh took a wrong world size")
        return {"ok": True}
    # a memmap: the rank reads only its own range of the file
    nbases = np.load(arrays["genome_path"].item(), mmap_mode="r")
    kw = dict(thr=THR, block=BLOCK, cand_blocks=PULLS // grp.size,
              bucket_cap=CAP)
    if grp.group is None:
        res = distributed_low_comp_regions(nbases, K, MIN_W, MIN_S,
                                           device="cpu", **kw)
    else:
        res = sharded_low_comp_regions(grp, nbases, K, MIN_W, MIN_S, **kw)
    return {"beg": [r[1] for r in res.regions],
            "end": [r[2] for r in res.regions],
            "score": np.array([r[3] for r in res.regions], np.float64),
            "flags": [res.fallback, res.overflow]}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    d = tmp_path_factory.mktemp("multihost")
    np.save(d / "genome.npy", _genome())
    return torch_ranks.start(
        Path(__file__), d, {"regions": {}, "dryrun": {}},
        {"genome_path": np.array(str(d / "genome.npy"))})


def _oracle():
    from kmer_spans_tpu_torch.oracle import (
        count_spectrum,
        find_regions,
        weighted_ranks,
    )

    seq = np.frombuffer(b"ACTGN", np.uint8)[np.minimum(_genome(), 4)]
    seq = seq.tobytes()
    counts, nw = count_spectrum(seq, K)
    return [(b, e, s) for _, b, e, s in find_regions(
        seq, 0, MIN_W, MIN_S, weighted_ranks(counts, float(nw)), K, THR)]


@pytest.mark.parametrize("w", WORLDS)
def test_every_rank_emits_the_oracle_and_jax_regions(port, w):
    import jax
    from jax.sharding import Mesh

    from kmer_spans_tpu.parallel.sharded_scan import (
        sharded_low_comp_regions as jax_regions,
    )

    outs = port.result()[w]
    got = [list(zip(o["regions/beg"].tolist(), o["regions/end"].tolist(),
                    o["regions/score"].tolist())) for o in outs]
    assert all(g == got[0] for g in got)  # every rank, the same list
    for o in outs:
        assert o["regions/flags"].tolist() == [False, False]
    want = _oracle()
    assert got[0] == want and len(want) >= 2
    mesh = Mesh(np.array(jax.devices()[:w]), ("data",))
    res = jax_regions(mesh, _genome(), K, MIN_W, MIN_S, thr=THR, block=BLOCK,
                      cand_blocks=PULLS // w, bucket_cap=CAP)
    assert not res.fallback and not res.overflow
    assert [(b, e, s) for _, b, e, s in res.regions] == got[0]


@pytest.mark.parametrize("w", WORLDS)
def test_dryrun_multichip_passes(port, w):
    """The counterpart of __graft_entry__.dryrun_multichip at each size
    (it raises on any difference from the oracle)."""
    assert all(bool(o["dryrun/ok"]) for o in port.result()[w])


def test_initialize_does_nothing_in_a_single_process(monkeypatch):
    import torch.distributed as dist

    from kmer_spans_tpu_torch.parallel.collectives import DataGroup
    from kmer_spans_tpu_torch.parallel.multihost import initialize

    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert not initialize(device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        DataGroup.of("cpu")


def test_a_cuda_group_without_a_card_raises(monkeypatch, tmp_path):
    import torch

    from kmer_spans_tpu_torch.parallel.multihost import initialize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize("file://" + str(tmp_path / "store"), 1, 0)


def test_launch_local_kills_the_ranks_on_timeout_and_failure():
    from kmer_spans_tpu_torch.parallel.multihost import launch_local

    sleep = [sys.executable, "-c", "import time; time.sleep(60)"]
    with pytest.raises(RuntimeError, match="still running"):
        launch_local(sleep, 2, timeout=0.5)
    fail = [sys.executable, "-c",
            "import os, sys, time\n"
            "if os.environ['RANK'] == '1': sys.exit('rank one failed')\n"
            "time.sleep(60)"]
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited 1:\n"
                                           "rank one failed"):
        launch_local(fail, 2, timeout=30)
    out = launch_local([sys.executable, "-c",
                        "import os; print(os.environ['RANK'], "
                        "os.environ['WORLD_SIZE'], os.environ['LOCAL_RANK'])"],
                       3, timeout=30)
    assert out == ["0 3 0\n", "1 3 1\n", "2 3 2\n"]


if __name__ == "__main__":
    sys.path.insert(0, str(torch_ranks.ROOT))
    torch_ranks.worker(_run_case)
