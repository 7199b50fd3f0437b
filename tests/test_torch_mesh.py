"""The port's mesh step, rank mass and hash-sharded count and rank against
the JAX mesh (kmer_spans_tpu/parallel/pipeline.py, sharded.py).

The same seeded inputs go through the JAX steps on a mesh of the first w
of the 8 virtual CPU devices and through the port at world size w under
gloo (tests/torch_ranks.py: this file is its own rank worker), w in
{1, 2, 4}; the cases of tests/test_multichip.py and test_sharded.py.
Integers exact (spectra, shard counts, mass, flags); the f32 running
score S within rtol = atol = 2e-4 of the JAX mesh's and of the exact host
scan, with the sign agreement of test_multichip.py.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

import torch_ranks
from torch_ranks import WORLDS, shard

# (name: seed, bases, N probability, k, thr) of test_multichip.py
PIPE = {"pipe0": (0, 20_000, 0.01, 4, 0.5),
        "pipe1": (1, 20_000, 0.01, 6, 0.75),
        "pipe2": (2, 20_000, 0.01, 2, 0.3)}
# (name: seed or None for "A" * 8192, bases, N probability, k, vmax, cap)
# of test_sharded.py
COUNT = {"cr0": (0, 30_000, 0.01, 4, 1 << 14, None),
         "cr1": (1, 30_000, 0.01, 6, 1 << 14, None),
         "cr2": (2, 20_000, 0.0, 4, 1 << 14, None),
         "cr3": (3, 20_000, 0.0, 5, 1 << 14, None),
         "overflow": (None, 8192, 0.0, 4, 1 << 14, 16),
         "clip": (5, 40_000, 0.0, 2, 16, None)}
#: the cases held against JAX at every world size; the others against
#: JAX at 4 and the oracle at every size
EVERY_WORLD = {"pipe0", "cr0", "overflow"}
NARROW_K = 9


def _padded(seq, gran=4096):
    from kmer_spans_tpu_torch.encoding import pack

    p = pack(seq)
    n = -(-p.n // gran) * gran
    bases = np.zeros(n, np.uint8)
    bases[:p.n] = p.bases
    valid = np.zeros(n, bool)
    valid[:p.n] = p.valid
    return bases, valid, p


def _seq(seed, n, n_prob):
    from conftest import random_seq

    if seed is None:
        return "A" * n
    return random_seq(np.random.default_rng(seed), n, n_prob=n_prob)


def _narrow_counts():
    rng = np.random.default_rng(2)
    return rng.integers(0, 1 << 14, size=1 << (2 * NARROW_K)).astype(np.int32)


def _cases():
    cases, arrays = {}, {}
    for name, (seed, n, n_prob, k, thr) in PIPE.items():
        bases, valid, _ = _padded(_seq(seed, n, n_prob))
        cases[name] = {"kind": "pipe", "k": k, "thr": thr}
        arrays[f"{name}/bases"], arrays[f"{name}/valid"] = bases, valid
    for name, (seed, n, n_prob, k, vmax, cap) in COUNT.items():
        bases, valid, _ = _padded(_seq(seed, n, n_prob))
        cases[name] = {"kind": "count_rank", "k": k, "vmax": vmax,
                       "cap": cap}
        arrays[f"{name}/bases"], arrays[f"{name}/valid"] = bases, valid
    cases["narrow"] = {"kind": "rank", "k": NARROW_K}
    arrays["narrow/counts"] = _narrow_counts()
    return cases, arrays


def _run_case(grp, name, spec, arrays):
    """One case on this rank (in the worker)."""
    from kmer_spans_tpu_torch.parallel.pipeline import make_pipeline_step
    from kmer_spans_tpu_torch.parallel.sharded import (
        make_sharded_count_step,
        make_sharded_rank_step,
    )

    k = spec["k"]
    if spec["kind"] == "rank":
        mass, clip = make_sharded_rank_step(grp, k)(
            shard(arrays[f"{name}/counts"], grp))
        return {"mass": mass, "clip": clip}
    bases = shard(arrays[f"{name}/bases"], grp)
    valid = shard(arrays[f"{name}/valid"], grp)
    if spec["kind"] == "pipe":
        counts, S, scored = make_pipeline_step(grp, k)(bases, valid,
                                                       spec["thr"])
        return {"counts": counts, "S": S, "scored": scored}
    counts, overflow = make_sharded_count_step(
        grp, k, bucket_cap=spec["cap"])(bases, valid)
    mass, clip = make_sharded_rank_step(grp, k, vmax=spec["vmax"])(counts)
    return {"counts": counts, "overflow": overflow, "mass": mass,
            "clip": clip}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    cases, arrays = _cases()
    return torch_ranks.start(Path(__file__), tmp_path_factory.mktemp("mesh"),
                             cases, arrays)


def _joined(outs, key):
    """A sharded output, the ranks' parts in rank order."""
    return np.concatenate([o[key].reshape(-1) for o in outs])


def _jax_mesh(w):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:w]), ("data",))


def _want_worlds(name):
    return WORLDS if name in EVERY_WORLD else (4,)


def _exact_scan(seq, k, thr, scored, counts_o, n_words):
    from kmer_spans_tpu_torch.encoding import kmer_codes_np, pack
    from kmer_spans_tpu_torch.oracle import weighted_ranks

    p = pack(seq)
    codes, _ = kmer_codes_np(p, k)
    ranks = weighted_ranks(counts_o, float(n_words))
    s = np.where(scored, ranks[codes] - thr, 0.0)
    S = np.zeros(p.n)
    prev = 0.0
    for i in range(p.n):
        prev = max(prev + s[i], 0.0) if scored[i] else 0.0
        S[i] = prev
    return S


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", sorted(PIPE))
def test_pipeline_step_equals_jax_mesh(port, name, w):
    from kmer_spans_tpu_torch.encoding import kmer_codes_np
    from kmer_spans_tpu_torch.oracle import count_spectrum

    seed, n, n_prob, k, thr = PIPE[name]
    seq = _seq(seed, n, n_prob)
    bases, valid, p = _padded(seq)
    outs = port.result()[w]
    counts = outs[0][f"{name}/counts"]
    for o in outs:
        assert np.array_equal(o[f"{name}/counts"], counts)  # replicated
    S = _joined(outs, f"{name}/S")[:p.n]
    scored = _joined(outs, f"{name}/scored")[:p.n]
    oc, n_words = count_spectrum(seq, k)
    assert np.array_equal(counts, oc)
    _, kv = kmer_codes_np(p, k)
    nv = np.zeros(p.n, bool)
    nv[:-1] = p.valid[1:]
    assert np.array_equal(scored, kv & nv)
    S_ref = _exact_scan(seq, k, thr, scored, oc, n_words)
    np.testing.assert_allclose(S, S_ref, rtol=2e-4, atol=2e-4)
    assert ((S > 1e-4) == (S_ref > 1e-4)).mean() > 0.999
    if w not in _want_worlds(name):
        return
    import jax.numpy as jnp

    from kmer_spans_tpu.parallel.pipeline import make_pipeline_step

    mesh = _jax_mesh(w)
    with mesh:
        jc, jS, jsc = make_pipeline_step(mesh, k)(
            jnp.asarray(bases), jnp.asarray(valid), jnp.float32(thr))
    assert np.array_equal(counts, np.asarray(jc))
    assert np.array_equal(scored, np.asarray(jsc)[:p.n])
    jS = np.asarray(jS)[:p.n]
    np.testing.assert_allclose(S, jS, rtol=2e-4, atol=2e-4)
    assert ((S > 1e-4) == (jS > 1e-4)).mean() > 0.999


def test_rank_mass_equals_jax_and_host():
    """_rank_mass of a tie-heavy spectrum (test_multichip.py's k = 3)."""
    import jax.numpy as jnp
    import torch

    from kmer_spans_tpu.parallel.pipeline import _rank_mass as jax_rank_mass
    from kmer_spans_tpu_torch.oracle import count_spectrum
    from kmer_spans_tpu_torch.parallel.pipeline import _rank_mass
    from kmer_spans_tpu_torch.stats.ranks import cumulative_mass

    oc, _ = count_spectrum(_seq(5, 8000, 0.0), 3)
    got = _rank_mass(torch.from_numpy(oc.astype(np.int32))).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, np.asarray(jax_rank_mass(
        jnp.asarray(oc.astype(np.int32)))))
    assert np.array_equal(got, cumulative_mass(oc))


@pytest.mark.parametrize("w", WORLDS)
@pytest.mark.parametrize("name", sorted(COUNT))
def test_sharded_count_and_rank_equal_jax_mesh(port, name, w):
    from kmer_spans_tpu_torch.oracle import count_spectrum
    from kmer_spans_tpu_torch.stats.ranks import cumulative_mass

    seed, n, n_prob, k, vmax, cap = COUNT[name]
    seq = _seq(seed, n, n_prob)
    bases, valid, _ = _padded(seq)
    outs = port.result()[w]
    counts = _joined(outs, f"{name}/counts")
    mass = _joined(outs, f"{name}/mass")
    overflow = {bool(o[f"{name}/overflow"]) for o in outs}
    clip = {bool(o[f"{name}/clip"]) for o in outs}
    assert len(overflow) == len(clip) == 1  # the flags reach every rank
    overflow, clip = overflow.pop(), clip.pop()
    assert counts.shape == (1 << (2 * k),) and mass.dtype == np.int64
    assert overflow == (name == "overflow")
    assert clip == (name == "clip")
    oc, _ = count_spectrum(seq, k)
    if not overflow:
        assert np.array_equal(counts, oc)
    if not (overflow or clip):
        assert np.array_equal(mass, cumulative_mass(oc))
    if w not in _want_worlds(name):
        return
    import jax.numpy as jnp

    from kmer_spans_tpu.parallel.sharded import (
        make_sharded_count_step,
        make_sharded_rank_step,
    )

    mesh = _jax_mesh(w)
    with mesh:
        jc, jo = make_sharded_count_step(mesh, k, bucket_cap=cap)(
            jnp.asarray(bases), jnp.asarray(valid))
        jm, jclip = make_sharded_rank_step(mesh, k, vmax=vmax)(jc)
    assert bool(jo) == overflow and bool(jclip) == clip
    if not overflow:
        assert np.array_equal(counts, np.asarray(jc))
    if not (overflow or clip):
        assert np.array_equal(mass, np.asarray(jm))


@pytest.mark.parametrize("w", WORLDS)
def test_narrow_rank_mass_past_int32(port, w):
    """Mass past 2^31 counted k-mers (k = 9, counts below 2^14): the
    port's int64 mass equals the host's; the JAX narrow step's int32
    partials wrap: its mass is right below 2^31 and wrong at k-mers past
    it (88 of the 4^9 here)."""
    import jax.numpy as jnp

    from kmer_spans_tpu.parallel.sharded import make_sharded_rank_step
    from kmer_spans_tpu_torch.stats.ranks import cumulative_mass

    counts = _narrow_counts()
    want = cumulative_mass(counts)
    assert want.max() > np.iinfo(np.int32).max
    outs = port.result()[w]
    assert np.array_equal(_joined(outs, "narrow/mass"), want)
    assert not any(bool(o["narrow/clip"]) for o in outs)
    mesh = _jax_mesh(w)
    with mesh:
        jm, _ = make_sharded_rank_step(mesh, NARROW_K)(jnp.asarray(counts))
    jm = np.asarray(jm).astype(np.int64)
    big = want >= (1 << 31)
    assert np.array_equal(jm[~big], want[~big])
    assert (jm[big] != want[big]).any()


if __name__ == "__main__":
    sys.path.insert(0, str(torch_ranks.ROOT))
    torch_ranks.worker(_run_case)
