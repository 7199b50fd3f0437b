"""The port's sharded sparse-spectrum scan for wide codes against the JAX
mesh (kmer_spans_tpu/parallel/wide_scan.py).

The same seeded inputs go through the JAX step on a mesh of the first w
of the 8 virtual CPU devices and through the port at world size w under
gloo (tests/torch_ranks.py: this file is its own rank worker), w in
{1, 2, 4}; the cases of tests/test_wide_scan.py (k = 16 and 17, the
single-device comparison, a bucket cap of 16).  Exact: the block
summaries, the total, the flags, the owners' runs (equal to the oracle's
sparse spectrum), the pulled codes at scored positions and the regions,
whose f64 scores equal the sequential oracle's over SparseRanks (==);
top_idx equal to JAX's where its f32 composition is exact.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_ranks
from torch_ranks import WORLDS

#: name: (k, genome seed, bases, thr, bucket_cap)
WIDE = {"k16": (16, 1716, 80_000, 0.75, None),
        "k17": (17, 1717, 80_000, 0.75, None),
        "single": (17, 1723, 80_000, 0.72, None),
        "overflow": (17, 1722, 40_000, 0.75, 16)}
MIN_W, MIN_S, BLOCK = 30, 5.0, 512
#: candidate blocks in all, C a rank: test_wide_scan.py's 16 at 8 devices
PULLS = 128
KEYS = ("tA", "tB", "maxA", "maxB", "top_idx", "codes", "scored", "total",
        "overflow", "spec_codes", "spec_counts")


@functools.cache
def _seq(name):
    """test_wide_scan.py's genome: random, 0.2 % N, three repeats."""
    from conftest import random_seq

    _, seed, n, _, _ = WIDE[name]
    s = list(random_seq(np.random.default_rng(seed), n, n_prob=0.002))
    for beg, unit, reps in ((8_000, "AG", 700), (34_000, "CCTGA", 300),
                            (60_000, "GATTACA", 180)):
        s[beg:beg + len(unit) * reps] = unit * reps
    return "".join(s)


def _nbases(seq):
    from kmer_spans_tpu_torch.encoding import pack

    p = pack(seq)
    return np.where(p.valid, p.bases, 4).astype(np.uint8)


def _cases():
    return ({name: {"kind": "wide", "k": spec[0]}
             for name, spec in WIDE.items()},
            {f"{name}/nbases": _nbases(_seq(name)) for name in WIDE})


def _run_case(grp, name, spec, arrays):
    """One case on this rank (in the worker): wide_low_comp_regions' body,
    keeping the step's outputs."""
    from kmer_spans_tpu_torch.parallel.sharded_scan import local_shard
    from kmer_spans_tpu_torch.parallel.wide_scan import (
        finish_wide_sharded,
        make_wide_sharded_scan,
    )

    k, _, _, thr, cap = WIDE[name]
    local, n = local_shard(grp, arrays[f"{name}/nbases"], BLOCK)
    out = tuple(o.numpy() for o in make_wide_sharded_scan(
        grp, k, block=BLOCK, cand_blocks=PULLS // grp.size, bucket_cap=cap)(
            local & 3, local < 4, thr))
    res = finish_wide_sharded(out, n, k, thr, MIN_W, MIN_S,
                              (out[9], out[10], int(out[7])), BLOCK)
    return {**dict(zip(KEYS, out)),
            "beg": [r[1] for r in res.regions],
            "end": [r[2] for r in res.regions],
            "score": np.array([r[3] for r in res.regions], np.float64),
            "flags": [res.fallback, res.overflow]}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    cases, arrays = _cases()
    return torch_ranks.start(Path(__file__), tmp_path_factory.mktemp("wide"),
                             cases, arrays)


@functools.cache
def _oracle(name):
    """(regions (beg, end, score), sparse spectrum) of the oracle."""
    from kmer_spans_tpu_torch.oracle import (
        count_spectrum_sparse,
        find_regions,
    )
    from kmer_spans_tpu_torch.stats.ranks import SparseRanks

    k, _, _, thr, _ = WIDE[name]
    spec = count_spectrum_sparse(_seq(name), k)
    regions = find_regions(_seq(name), 0, MIN_W, MIN_S,
                           SparseRanks(*spec[:2]), k, thr)
    return [(b, e, s) for _, b, e, s in regions], spec


def _jax_wide(name, w):
    """JAX's wide step on a w-device mesh and its finisher over the
    oracle's sparse spectrum (what wide_low_comp_regions computes)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from kmer_spans_tpu.parallel.wide_scan import (
        finish_wide_sharded,
        make_wide_sharded_scan,
    )

    k, _, _, thr, cap = WIDE[name]
    nb = _nbases(_seq(name))
    n = -(-nb.shape[0] // (w * BLOCK)) * (w * BLOCK)
    nb = np.concatenate([nb, np.full(n - nb.shape[0], 4, np.uint8)])
    mesh = Mesh(np.array(jax.devices()[:w]), ("data",))
    with mesh:
        out = make_wide_sharded_scan(mesh, k, block=BLOCK,
                                     cand_blocks=PULLS // w, bucket_cap=cap)(
            jnp.asarray(nb & 3), jnp.asarray(nb < 4), jnp.float32(thr))
    out = tuple(np.asarray(o) for o in out)
    res = finish_wide_sharded(out, n, k, thr, MIN_W, MIN_S,
                              _oracle(name)[1], BLOCK)
    return out, res


def _f32_exact(tA, tB, maxA, maxB):
    """Whether JAX's f32 composition of these summaries is exact (every
    partial sum an integer below 2^24 in magnitude; a sound bound)."""
    big = np.abs(tA.astype(np.int64)).sum()
    for x in (tB, maxB):
        x = x[x > -(1 << 29)]
        big += int(np.abs(x).max()) if x.size else 0
    return big + int(np.abs(maxA).max()) < (1 << 24)


def _regions(o, name):
    return list(zip(o[f"{name}/beg"].tolist(), o[f"{name}/end"].tolist(),
                    o[f"{name}/score"].tolist()))


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", sorted(WIDE))
def test_wide_scan_equals_jax_mesh_and_oracle(port, name, w):
    outs = port.result()[w]
    o = outs[0]
    for r in outs[1:]:  # every rank holds the same outputs and regions
        assert all(np.array_equal(r[key], o[key]) for key in r
                   if key.startswith(f"{name}/"))
    fallback, overflow = o[f"{name}/flags"].tolist()
    assert overflow == bool(o[f"{name}/overflow"]) == (name == "overflow")
    want, spec = _oracle(name)
    if name != "overflow":
        assert not fallback
        assert _regions(o, name) == want and len(want) >= 3
        # the owners' runs are the sparse spectrum, sorted by code
        assert np.array_equal(o[f"{name}/spec_codes"], spec[0])
        assert np.array_equal(o[f"{name}/spec_counts"], spec[1])
        assert int(o[f"{name}/total"]) == spec[2]
    # JAX's mesh at every size for k = 17, its overflow flag at 4; the
    # single-device case is held to the port's own pipeline below
    if not (name == "k17" or (name == "overflow" and w == 4)):
        return
    jout, jres = _jax_wide(name, w)
    assert bool(jout[9]) == overflow
    if overflow:
        return
    for key, j in zip(KEYS[:4], jout[:4]):
        assert np.array_equal(o[f"{name}/{key}"], j), key
    assert int(jout[8]) == int(o[f"{name}/total"])
    assert [(b, e, s) for _, b, e, s in jres.regions] == want
    if _f32_exact(*jout[:4]):
        assert np.array_equal(o[f"{name}/top_idx"], jout[4])
    jrow = {int(b): i for i, b in enumerate(jout[4])}
    for i, b in enumerate(o[f"{name}/top_idx"].tolist()):
        if b in jrow:
            sc = o[f"{name}/scored"][i]
            assert np.array_equal(sc, jout[7][jrow[b]])
            jcodes = (jout[5][jrow[b]].astype(np.int64) << 16) | (
                jout[6][jrow[b]].astype(np.int64) & 0xFFFF)
            assert np.array_equal(o[f"{name}/codes"][i][sc], jcodes[sc])


@pytest.mark.parametrize("w", WORLDS)
def test_wide_scan_equals_the_single_device_pipeline(port, w):
    """The mesh's regions equal the port's single-device wide pipeline's
    (make_wide_span_pipeline, block 1024, C = 64, finish_wide_spans over
    the same sparse spectrum), k = 17, thr 0.72."""
    from kmer_spans_tpu_torch.spans.finish import (
        finish_wide_spans,
        unpack_wide_outputs,
    )
    from kmer_spans_tpu_torch.spans.pipeline import make_wide_span_pipeline

    k, _, _, thr, _ = WIDE["single"]
    nb = _nbases(_seq("single"))
    block, cand = 1024, 64
    n = -(-nb.shape[0] // block) * block
    arr = np.full(n, 4, np.uint8)
    arr[:nb.shape[0]] = nb
    vec = make_wide_span_pipeline(k, block=block, cand_blocks=cand,
                                  device="cpu")(arr, thr)
    single = finish_wide_spans(unpack_wide_outputs(vec.numpy(), n, block,
                                                   cand),
                               n, k, thr, MIN_W, MIN_S, _oracle("single")[1],
                               block=block)
    assert not single.fallback and len(single.regions) >= 2
    got = _regions(port.result()[w][0], "single")
    assert got == [(b, e, s) for _, b, e, s in single.regions]


def test_wide_scan_refuses_2_to_the_31_bases():
    """The total stays int32, as in the reference: 2^31 bases raise before
    any work (a stride-0 view holds them in one byte)."""
    import torch

    from kmer_spans_tpu_torch.parallel.collectives import DataGroup
    from kmer_spans_tpu_torch.parallel.wide_scan import (
        make_wide_sharded_scan,
    )

    grp = DataGroup(0, 2, torch.device("cpu"))
    step = make_wide_sharded_scan(grp, 17)
    bases = torch.zeros(1, dtype=torch.uint8).expand(1 << 30)
    valid = torch.ones(1, dtype=torch.bool).expand(1 << 30)
    with pytest.raises(ValueError, match="2\\^31"):
        step(bases, valid, 0.75)


if __name__ == "__main__":
    sys.path.insert(0, str(torch_ranks.ROOT))
    torch_ranks.worker(_run_case)
