"""The port's dense span scan (ops/scan.py span_scan, span_scan_blocked,
apply_carry; ops/blocked.py blocked_scan; parallel/device.py
device_codes_scored) against the JAX package's, on the same seeded
inputs, as tests/test_ops_device.py holds the JAX scan.

Tolerances: f64 inputs within rtol = atol = 1e-12 of JAX's x64 scan and
of a sequential f64 loop (the port's prefixes are f64 cumsum differences,
the reference's an associative scan: both round, in different orders);
f32 inputs within rtol = atol = 2e-4 of JAX's f32 scan (the mesh rule:
the port computes in f64 and casts, the reference scans in f32).  Masks,
totals and codes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmer_spans_tpu_torch
from kmer_spans_tpu import encoding as ref_encoding
from kmer_spans_tpu.ops import blocked as jb
from kmer_spans_tpu.ops import scan as js
from kmer_spans_tpu.parallel.device import (
    device_codes_scored as ref_codes_scored,
)
from kmer_spans_tpu_torch import ops
from kmer_spans_tpu_torch.encoding import pack
from kmer_spans_tpu_torch.ops import blocked as tb
from kmer_spans_tpu_torch.ops import scan as ts
from kmer_spans_tpu_torch.parallel.device import device_codes_scored

from conftest import random_seq

F64 = dict(rtol=1e-12, atol=1e-12)
F32 = dict(rtol=2e-4, atol=2e-4)


def _sequential(s, scored):
    """S_i = max(S_{i-1} + s_i, 0), reset to 0 at unscored positions."""
    S = np.zeros(s.shape[0])
    prev = 0.0
    for i in range(s.shape[0]):
        prev = max(prev + s[i], 0.0) if scored[i] else 0.0
        S[i] = prev
    return S


def _inputs(seed, n, p_unscored=0.2, drift=0.0):
    rng = np.random.default_rng(seed)
    return rng.normal(drift, 1.0, n), rng.random(n) > p_unscored


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("n", [1, 4096, 10_000, 20_000])
def test_span_scan_f64_equals_jax_and_the_sequential_loop(n):
    s, scored = _inputs(n, n)
    S, (A, B) = ts.span_scan(_t(s), _t(scored))
    jS, (jA, jB) = js.span_scan(jnp.asarray(s), jnp.asarray(scored))
    assert S.dtype == torch.float64 and S.shape == (n,)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), **F64)
    np.testing.assert_allclose(S.numpy(), _sequential(s, scored), **F64)
    assert np.all(S.numpy()[~scored] == 0.0)
    np.testing.assert_allclose([float(A), float(B)],
                               [float(jA), float(jB)], **F64)


def test_span_scan_totals_with_no_reset():
    """A fully scored stretch: A_end is the sum of the scores (finite), B_end
    its best suffix; both equal the reference's."""
    s, _ = _inputs(3, 9000, drift=-0.1)
    scored = np.ones(9000, bool)
    _, (A, B) = ts.span_scan(_t(s), _t(scored))
    _, (jA, jB) = js.span_scan(jnp.asarray(s), jnp.asarray(scored))
    assert np.isfinite(float(A))
    np.testing.assert_allclose([float(A), float(B)],
                               [float(jA), float(jB)], **F64)


@pytest.mark.parametrize("seed", [0, 1])
def test_span_scan_f32_equals_jax_f32(seed):
    s, scored = _inputs(seed, 30_000, drift=-0.05)
    s32 = s.astype(np.float32)
    S, (A, B) = ts.span_scan(_t(s32), _t(scored))
    jS, _ = js.span_scan(jnp.asarray(s32), jnp.asarray(scored))
    assert S.dtype == torch.float32 and A.dtype == torch.float32
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), **F32)
    np.testing.assert_allclose(S.numpy(), _sequential(s32.astype(np.float64),
                                                      scored), **F32)


def test_span_scan_takes_neg_inf():
    """-inf at a scored position resets the running score, as in the
    reference's pairs; no NaN anywhere."""
    s, scored = _inputs(5, 12_000, p_unscored=0.05)
    rng = np.random.default_rng(6)
    s[rng.random(12_000) < 0.01] = -np.inf
    S, (A, B) = ts.span_scan(_t(s), _t(scored))
    jS, (jA, jB) = js.span_scan(jnp.asarray(s), jnp.asarray(scored))
    assert not torch.isnan(S).any()
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), **F64)
    np.testing.assert_allclose(S.numpy(), _sequential(s, scored), **F64)
    assert float(A) == float(jA) == -np.inf
    np.testing.assert_allclose(float(B), float(jB), **F64)


@pytest.mark.parametrize("block", [100, 1024, 8192])
def test_span_scan_blocked_equals_jax(block):
    n = 10_000  # not a multiple of any block
    s, scored = _inputs(block, n, p_unscored=0.3)
    got = ts.span_scan_blocked(_t(s), _t(scored), block)
    want = jax.jit(js.span_scan_blocked, static_argnums=2)(
        jnp.asarray(s), jnp.asarray(scored), block)
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)
    S, _ = ts.span_scan(_t(s), _t(scored))
    np.testing.assert_allclose(got.numpy(), S.numpy(), **F64)


def test_apply_carry_composes_two_halves():
    """Scanning a stream in two halves and carrying the first half's
    state into the second's prefixes equals one scan, as in the
    reference."""
    s, _ = _inputs(7, 2048)
    scored = np.ones(2048, bool)
    scored[1500] = False
    S_full, _ = ts.span_scan(_t(s), _t(scored))
    S1, (A1, B1) = ts.span_scan(_t(s[:1000]), _t(scored[:1000]))
    assert float(S1[-1]) == float(ts.apply_carry(0.0, A1, B1))
    FA, FB, _ = tb.blocked_scan_prefixes(_t(s[1000:])[None],
                                         _t(scored[1000:])[None])
    S2 = ts.apply_carry(S1[-1], FA[0], FB[0])
    np.testing.assert_allclose(S2.numpy(), S_full[1000:].numpy(), **F64)
    jS2 = js.apply_carry(float(S1[-1]), jnp.asarray(FA[0].numpy()),
                         jnp.asarray(FB[0].numpy()))
    assert np.array_equal(S2.numpy(), np.asarray(jS2))


@pytest.mark.parametrize("shape", [(6, 1024), (1, 333), (40, 256)])
def test_blocked_scan_equals_jax(shape):
    s, scored = _inputs(shape[1], shape[0] * shape[1], p_unscored=0.1)
    s, scored = s.reshape(shape), scored.reshape(shape)
    S, (A, B) = tb.blocked_scan(_t(s), _t(scored))
    jS, (jA, jB) = jb.blocked_scan(jnp.asarray(s), jnp.asarray(scored))
    assert S.shape == shape and S.dtype == torch.float64
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), **F64)
    np.testing.assert_allclose([float(A), float(B)],
                               [float(jA), float(jB)], **F64)
    S32, (A32, _) = tb.blocked_scan(_t(s.astype(np.float32)), _t(scored))
    assert S32.dtype == A32.dtype == torch.float32
    np.testing.assert_allclose(S32.numpy(), np.asarray(jS), **F32)


@pytest.mark.parametrize("k", [1, 4, 8, 12])
def test_device_codes_scored_equals_jax(k):
    rng = np.random.default_rng(k)
    seq = random_seq(rng, 9_000, n_prob=0.01) + "ACGTN" + "ACG" * 7
    codes, scored = device_codes_scored(pack(seq), k, "cpu")
    want_codes, want_scored = ref_codes_scored(ref_encoding.pack(seq), k)
    assert codes.shape == scored.shape == (len(seq),)
    assert codes.dtype == want_codes.dtype and scored.dtype == bool
    assert np.array_equal(codes, want_codes)
    assert np.array_equal(scored, want_scored)


def test_exports():
    assert ops.span_scan is ts.span_scan
    assert ops.span_scan_blocked is ts.span_scan_blocked
    from kmer_spans_tpu_torch import encoding

    for name in ("MAX_K", "NUC", "PackedSeq", "all_kmers", "code_to_kmer",
                 "kmer_to_code", "pack"):
        assert getattr(kmer_spans_tpu_torch, name) is getattr(encoding, name)
