"""Plain PyTorch ops of the k <= 8 span pipeline against the JAX reference.

Same numpy inputs (seeded) through both packages; integers exact.  The
port composes block summaries exactly in int64 where the reference uses
f32: the two are compared where every partial sum is an integer below
2^24 (asserted), the range where the reference's f32 values are exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmer_spans_tpu.ops import blocked as jb
from kmer_spans_tpu.ops import gather as jg
from kmer_spans_tpu.parallel.pipeline import _rank_mass as jax_rank_mass
from kmer_spans_tpu_torch.ops import blocked as tb
from kmer_spans_tpu_torch.ops import gather as tg
from kmer_spans_tpu_torch.ops.convert import to_tensor
from kmer_spans_tpu_torch.parallel.pipeline import _rank_mass
from kmer_spans_tpu_torch.spans.finish import compose_summaries_exact


def _genome_tiles(seed, nb=6, block=1024):
    rng = np.random.default_rng(seed)
    nbases = rng.integers(0, 4, nb * block).astype(np.uint8)
    nbases[rng.random(nb * block) < 0.01] = 4
    nbases[block - 3:block + 2] = 4  # an N run across a block boundary
    nbases[-1] = 4
    return (nbases & 3).reshape(nb, block), (nbases < 4).reshape(nb, block)


@pytest.mark.parametrize("k", [4, 6, 8])
def test_blocked_codes_and_scored(k):
    b2, v2 = _genome_tiles(k)
    jc, jkv = jb.blocked_codes(jnp.asarray(b2.astype(np.int32)),
                               jnp.asarray(v2), k)
    js = jb.blocked_scored(jnp.asarray(v2), jkv)
    tc, tkv = tb.blocked_codes(torch.from_numpy(b2), torch.from_numpy(v2), k)
    ts = tb.blocked_scored(torch.from_numpy(v2), tkv)
    assert tc.dtype == torch.int32
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(tkv.numpy(), np.asarray(jkv))
    assert np.array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("k", [4, 6, 8])
def test_rank_mass(k):
    rng = np.random.default_rng(k)
    counts = rng.integers(0, 30, 1 << (2 * k)).astype(np.int32)
    counts[rng.integers(0, counts.size, 50)] = 7  # many ties
    want = np.asarray(jax_rank_mass(jnp.asarray(counts)))
    got = _rank_mass(torch.from_numpy(counts))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("class_bits", [2, 4])
@pytest.mark.parametrize("k", [4, 8])
def test_class_table_from_mass(k, class_bits):
    rng = np.random.default_rng(20 + k)
    counts = rng.integers(0, 60, 1 << (2 * k)).astype(np.int32)
    mass = np.asarray(jax_rank_mass(jnp.asarray(counts))).astype(np.int32)
    total = np.float32(counts.sum())
    want = jg.class_table_from_mass(jnp.asarray(mass), jnp.float32(total),
                                    class_bits)
    got = tg.class_table_from_mass(torch.from_numpy(mass),
                                   torch.tensor(total), class_bits)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_screen_thr_q_and_class_scores():
    thrs = np.array([0.01, 0.3, 0.5, 0.6, 0.7, 0.72, 0.75, 0.9, 0.99,
                     1 / 3, 0.123456789], np.float32)
    for thr in thrs:
        want = int(jg.screen_thr_q(jnp.float32(thr)))
        got = tg.screen_thr_q(torch.tensor(thr))
        assert got.dtype == torch.int32 and got.item() == want, thr
    cls = np.arange(16, dtype=np.int32)
    want = np.asarray(jg.class_scores_int(jnp.asarray(cls), jnp.int32(3071)))
    got = tg.class_scores_int(torch.from_numpy(cls),
                              torch.tensor(3071, dtype=torch.int32))
    assert np.array_equal(got.numpy(), want)


def _summaries_case(seed, nb=8, block=1024):
    rng = np.random.default_rng(seed)
    s = rng.integers(-3000, 1200, (nb, block)).astype(np.int32)
    scored = rng.random((nb, block)) < 0.9
    scored[2] = False  # no scored position: the B sentinel
    scored[4, :300] = False
    return s, scored


@pytest.mark.parametrize("seed", [0, 1])
def test_blocked_scan_summaries_int(seed):
    s, scored = _summaries_case(seed)
    want = jb.blocked_scan_summaries_int(jnp.asarray(s), jnp.asarray(scored))
    got = tb.blocked_scan_summaries_int(to_tensor(s, "cpu"),
                                        to_tensor(scored, "cpu"))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compose_summaries_int64(seed):
    """Equal to the reference's f32 composition where that one is exact
    (every partial sum an integer below 2^24, asserted)."""
    s, scored = _summaries_case(seed, nb=12)
    s = (s // 4).astype(np.int32)  # keep partial sums below 2^24
    tA, tB, maxA, maxB = (np.asarray(x) for x in jb.blocked_scan_summaries_int(
        jnp.asarray(s), jnp.asarray(scored)))
    sent = tb.SCREEN_NEG // 2
    bound = (np.abs(tA.astype(np.int64)).sum()
             + np.abs(tB[tB > sent].astype(np.int64)).max()
             + np.abs(maxA.astype(np.int64)).max()
             + np.abs(maxB[maxB > sent].astype(np.int64)).max())
    assert bound < 1 << 24
    want = jb.compose_summaries_f32(*(jnp.asarray(x) for x in
                                      (tA, tB, maxA, maxB)))
    got = tb.compose_summaries_int64(*(to_tensor(x, "cpu") for x in
                                       (tA, tB, maxA, maxB)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_compose_summaries_int64_exact_at_genome_scale():
    """At 2^28-position scale (partial sums ~1e10) the device composition
    still equals the host's exact int64 one."""
    rng = np.random.default_rng(7)
    nb = 32768
    tA = rng.integers(-4_000_000, 3_000_000, nb).astype(np.int32)
    tB = rng.integers(0, 3_000_000, nb).astype(np.int32)
    maxA = rng.integers(-100_000, 3_000_000, nb).astype(np.int32)
    maxB = rng.integers(0, 3_000_000, nb).astype(np.int32)
    none = rng.random(nb) < 0.05
    tB[none] = tA[none] - (1 << 30)
    maxB[none] = maxA[none] - (1 << 30)
    want = compose_summaries_exact(tA, tB, maxA, maxB)
    got = tb.compose_summaries_int64(*(to_tensor(x, "cpu") for x in
                                       (tA, tB, maxA, maxB)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
