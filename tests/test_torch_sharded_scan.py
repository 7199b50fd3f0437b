"""The port's sharded-spectrum scan (k >= 13 design) against the JAX mesh
(kmer_spans_tpu/parallel/sharded_scan.py).

The same seeded inputs go through the JAX steps on a mesh of the first w
of the 8 virtual CPU devices and through the port at world size w under
gloo (tests/torch_ranks.py: this file is its own rank worker), w in
{1, 2, 4}; the cases of tests/test_sharded_scan.py.  Exact: the rank mass
(the port's int64 against JAX's (hi << 16) + lo), the value histogram,
the flags, the block summaries, the pulled mass at scored positions and
the regions, whose f64 scores equal the sequential oracle's (==); top_idx
and fallback equal JAX's where its f32 composition is exact.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_ranks
from torch_ranks import WORLDS, shard

#: name: (k, min_width, min_score, thr, block, cand_blocks, bucket_cap)
SCANS = {"golden8": (8, 100, 20.0, 0.75, 512, 12, None),
         "gaps5": (5, 50, 10.0, 0.7, 512, 16, None),
         "fallback": (5, 20, 5.0, 0.5, 512, 1, None),
         "k13": (13, 100, 10.0, 0.75, 1024, 8, None),
         "small": (5, 30, 10.0, 0.85, 256, 4, None)}
#: held against JAX at every world size; "gaps5" and "k13" at 4 too; the
#: others against the oracle (as JAX's own tests hold JAX)
EVERY_WORLD = {"small"}
AT_FOUR = {"gaps5", "k13"}


def _genome(name):
    """uint8 genome (4 = N) of each scan case (test_sharded_scan.py's)."""
    if name == "golden8":
        from kmer_spans_tpu_torch.encoding import pack
        from kmer_spans_tpu_torch.oracle import golden_genome

        p = pack(golden_genome())
        return np.where(p.valid, p.bases, 4).astype(np.uint8)
    rng = np.random.default_rng({"gaps5": 11, "fallback": 12, "k13": 13,
                                 "small": 14}[name])
    if name == "gaps5":
        nb = rng.integers(0, 4, size=40_000, dtype=np.uint8)
        nb[5_000:5_040] = 4
        nb[20_000:21_200] = np.tile(np.array([0, 3], np.uint8), 600)
        nb[33_000:33_007] = 4
    elif name == "fallback":
        nb = rng.integers(0, 4, size=16_384, dtype=np.uint8)
        for s in range(0, 16_384 - 600, 2048):
            nb[s:s + 600] = np.tile(np.array([1, 2], np.uint8), 300)
    elif name == "k13":
        nb = rng.integers(0, 4, size=1 << 17, dtype=np.uint8)
        nb[40_000:40_800] = np.array([0, 1, 2, 3, 0, 3], np.uint8)[
            np.arange(800) % 6]
        nb[90_000:90_020] = 4
    else:
        nb = rng.integers(0, 4, size=4096, dtype=np.uint8)
        nb[1_000:1_400] = np.tile(np.array([0, 3], np.uint8), 200)
        nb[3_000:3_010] = 4
    return nb


def _rank_counts():
    """Spectra for the wide rank step: past int32 (k = 9), a clipped
    value (k = 4) and the golden genome's tie-heavy k = 6 spectrum."""
    from kmer_spans_tpu_torch.utils import native

    rng = np.random.default_rng(2)
    clip = np.full(1 << 8, 5, np.int32)
    clip[3] = 1 << 20
    golden, _ = native.count_spectrum(_genome("golden8"), 6)
    return {"past32": (9, rng.integers(0, 1 << 14, size=1 << 18).astype(
        np.int32)), "clip": (4, clip), "golden6": (6, golden.astype(np.int32))}


def _cases():
    cases, arrays = {}, {}
    for name, (k, *_) in SCANS.items():
        cases[name] = {"kind": "scan", "k": k}
        arrays[f"{name}/nbases"] = _genome(name)
    for name, (k, counts) in _rank_counts().items():
        cases[f"rank_{name}"] = {"kind": "rank", "k": k}
        arrays[f"rank_{name}/counts"] = counts
    return cases, arrays


def _run_case(grp, name, spec, arrays):
    """One case on this rank (in the worker)."""
    from kmer_spans_tpu_torch.parallel.sharded import make_sharded_count_step
    from kmer_spans_tpu_torch.parallel.sharded_scan import (
        finish_sharded_spans,
        local_shard,
        make_sharded_rank_step_wide,
        make_sharded_scan_step,
    )

    k = spec["k"]
    if spec["kind"] == "rank":
        mass, clip, vhist = make_sharded_rank_step_wide(grp, k)(
            shard(arrays[f"{name}/counts"], grp))
        return {"mass": mass, "clip": clip, "vhist": vhist}
    _, min_w, min_s, thr, block, cand, cap = SCANS[name]
    # sharded_low_comp_regions' body, keeping the scan step's outputs
    local, n = local_shard(grp, arrays[f"{name}/nbases"], block)
    bases, valid = local & 3, local < 4
    counts, c_over = make_sharded_count_step(grp, k, block=block,
                                             bucket_cap=cap)(bases, valid)
    mass, clip, vhist = make_sharded_rank_step_wide(grp, k)(counts)
    total = int(vhist.sum())
    out = make_sharded_scan_step(grp, k, block=block, cand_blocks=cand,
                                 bucket_cap=cap)(
        bases, valid, mass, total, thr)
    res = finish_sharded_spans(tuple(o.numpy() for o in out), n, total, thr,
                               min_w, min_s, block,
                               value_hist=vhist.numpy())
    keys = ("tA", "tB", "maxA", "maxB", "top_idx", "pm", "scored", "overflow")
    return {**dict(zip(keys, out)), "c_over": c_over, "clip": clip,
            "beg": [r[1] for r in res.regions],
            "end": [r[2] for r in res.regions],
            "score": np.array([r[3] for r in res.regions], np.float64),
            "flags": [res.fallback, res.overflow]}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    cases, arrays = _cases()
    return torch_ranks.start(Path(__file__),
                             tmp_path_factory.mktemp("sharded_scan"), cases,
                             arrays)


def _jax_mesh(w):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:w]), ("data",))


def _pairs(hi, lo):
    return (np.asarray(hi).astype(np.int64) << 16) + np.asarray(lo)


@functools.cache
def _oracle(name):
    """The sequential oracle's regions of a scan case (beg, end, score)."""
    from kmer_spans_tpu_torch.oracle import find_regions, weighted_ranks
    from kmer_spans_tpu_torch.utils import native

    nb = _genome(name)
    k, min_w, min_s, thr, *_ = SCANS[name]
    seq = np.frombuffer(b"ACTGN", np.uint8)[np.minimum(nb, 4)].tobytes()
    counts, nw = native.count_spectrum(nb, k)
    return [(b, e, s) for _, b, e, s in find_regions(
        seq, 0, min_w, min_s, weighted_ranks(counts, float(nw)), k, thr)]


def _jax_scan(name, w):
    """JAX's sharded_low_comp_regions on a w-device mesh, keeping the scan
    step's outputs: (outputs with pm as int64, result)."""
    import jax.numpy as jnp

    from kmer_spans_tpu.parallel.sharded import make_sharded_count_step
    from kmer_spans_tpu.parallel.sharded_scan import (
        finish_sharded_spans,
        make_sharded_rank_step_wide,
        make_sharded_scan_step,
    )

    k, min_w, min_s, thr, block, cand, cap = SCANS[name]
    nb = _genome(name)
    n = -(-nb.shape[0] // (w * block)) * (w * block)
    nb = np.concatenate([nb, np.full(n - nb.shape[0], 4, np.uint8)])
    v = (nb < 4).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(v)])
    total = int(np.count_nonzero(cs[k:] - cs[:-k] == k))
    mesh = _jax_mesh(w)
    bases, valid = jnp.asarray(nb & 3), jnp.asarray(nb < 4)
    with mesh:
        counts, c_over = make_sharded_count_step(
            mesh, k, block=block, bucket_cap=cap)(bases, valid)
        m_hi, m_lo, clip, vh_hi, vh_lo = make_sharded_rank_step_wide(
            mesh, k)(counts)
        out = make_sharded_scan_step(mesh, k, block=block, cand_blocks=cand,
                                     bucket_cap=cap)(
            bases, valid, m_hi, m_lo, jnp.float32(total), jnp.float32(thr))
    out = tuple(np.asarray(o) for o in out)
    res = finish_sharded_spans(out, n, total, thr, min_w, min_s, block,
                               value_hist=_pairs(vh_hi, vh_lo))
    tA, tB, maxA, maxB, top, p_hi, p_lo, scored, overflow = out
    return (tA, tB, maxA, maxB, top, _pairs(p_hi, p_lo), scored, overflow,
            bool(c_over), bool(clip)), res


def _f32_exact(tA, tB, maxA, maxB):
    """Whether JAX's f32 composition of these summaries is exact: every
    partial sum an integer below 2^24 in magnitude (a sound bound)."""
    big = np.abs(tA.astype(np.int64)).sum()
    for x in (tB, maxB):
        x = x[x > -(1 << 29)]
        big += int(np.abs(x).max()) if x.size else 0
    return big + int(np.abs(maxA).max()) < (1 << 24)


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", sorted(SCANS))
def test_sharded_scan_equals_jax_mesh_and_oracle(port, name, w):
    outs = port.result()[w]
    o = outs[0]
    for r in outs[1:]:  # every rank holds the same outputs and regions
        assert all(np.array_equal(r[key], o[key]) for key in r
                   if key.startswith(f"{name}/"))
    got = list(zip(o[f"{name}/beg"].tolist(), o[f"{name}/end"].tolist(),
                   o[f"{name}/score"].tolist()))
    fallback, overflow = o[f"{name}/flags"].tolist()
    assert not overflow and not o[f"{name}/c_over"] and not o[f"{name}/clip"]
    if name == "fallback":
        assert fallback or got == _oracle(name)
    else:
        assert not fallback and got
        assert got == _oracle(name)
    if not (name in EVERY_WORLD or (name in AT_FOUR and w == 4)):
        return
    jout, jres = _jax_scan(name, w)
    if not (fallback or jres.fallback):
        assert [(b, e, s) for _, b, e, s in jres.regions] == got
    for key, j in zip(("tA", "tB", "maxA", "maxB"), jout[:4]):
        assert np.array_equal(o[f"{name}/{key}"], j), key
    assert bool(jout[7]) == bool(o[f"{name}/overflow"])
    top = o[f"{name}/top_idx"]
    if _f32_exact(*jout[:4]):
        assert np.array_equal(top, jout[4])
        assert jres.fallback == fallback
    assert name != "small" or _f32_exact(*jout[:4])
    # the pulled mass at scored positions of the blocks both pulled
    jrow = {int(b): i for i, b in enumerate(jout[4])}
    for i, b in enumerate(top.tolist()):
        if b in jrow:
            sc = o[f"{name}/scored"][i]
            assert np.array_equal(sc, jout[6][jrow[b]])
            assert np.array_equal(o[f"{name}/pm"][i][sc],
                                  jout[5][jrow[b]][sc])


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", ["past32", "clip", "golden6"])
def test_rank_step_wide_equals_jax_pairs(port, name, w):
    """Mass past 2^31 (int64 here, (hi, lo) pairs in JAX), a clipped value
    flagged, the golden genome's tie-heavy spectrum."""
    from kmer_spans_tpu_torch.stats.ranks import cumulative_mass

    k, counts = _rank_counts()[name]
    outs = port.result()[w]
    mass = np.concatenate([o[f"rank_{name}/mass"] for o in outs])
    clips = {bool(o[f"rank_{name}/clip"]) for o in outs}
    assert clips == {name == "clip"}
    vhist = outs[0][f"rank_{name}/vhist"]
    assert all(np.array_equal(o[f"rank_{name}/vhist"], vhist) for o in outs)
    if name != "clip":
        want = cumulative_mass(counts)
        assert np.array_equal(mass, want)
        assert np.array_equal(vhist, np.bincount(
            counts, weights=counts.astype(np.float64),
            minlength=1 << 14).astype(np.int64))
    if name == "past32":
        assert mass.max() > np.iinfo(np.int32).max
    if w != 4 and name != "past32":
        return
    import jax.numpy as jnp

    from kmer_spans_tpu.parallel.sharded_scan import (
        make_sharded_rank_step_wide,
    )

    mesh = _jax_mesh(w)
    with mesh:
        hi, lo, clip, vh_hi, vh_lo = make_sharded_rank_step_wide(mesh, k)(
            jnp.asarray(counts))
    assert bool(clip) == (name == "clip")
    if name != "clip":
        assert np.array_equal(mass, _pairs(hi, lo))
        assert np.array_equal(vhist, _pairs(vh_hi, vh_lo))


def test_mass_rank_f32_is_the_pair_order():
    """f32(m >> 16) * 65536 + f32(m & 0xFFFF), then / total: equal to JAX's
    to_f32 of the canonical pair bit for bit from 2^24 to 2^46.  A plain
    f32(m) rounds the same below 2^40 and differently above, where
    f32(m >> 16) rounds too."""
    import jax.numpy as jnp
    import torch

    from kmer_spans_tpu.ops.wide import to_f32
    from kmer_spans_tpu_torch.parallel.sharded_scan import mass_rank_f32

    rng = np.random.default_rng(7)
    m = np.concatenate([rng.integers(1 << 24, 1 << 40, size=50_000),
                        rng.integers(1 << 40, 1 << 46, size=50_000)])
    total = np.float32(1 << 41)
    got = mass_rank_f32(torch.from_numpy(m), torch.tensor(total)).numpy()
    want = np.asarray(to_f32(jnp.asarray((m >> 16).astype(np.int32)),
                             jnp.asarray((m & 0xFFFF).astype(np.int32)))
                      / jnp.maximum(jnp.float32(total), 1.0))
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    plain = torch.from_numpy(m).to(torch.float32).numpy() / total
    assert np.array_equal(plain[:50_000], got[:50_000])
    assert (plain[50_000:] != got[50_000:]).any()


if __name__ == "__main__":
    sys.path.insert(0, str(torch_ranks.ROOT))
    torch_ranks.worker(_run_case)
