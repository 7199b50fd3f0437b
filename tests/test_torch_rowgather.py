"""The port's row-gather screen (ops/rowgather.py) against the JAX
package's: row tables and affine decodes byte for byte, and the integer
screen scores of a plain torch gather equal to the reference's row fetch
and lane select."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_spans_tpu.ops import rowgather as ref
from kmer_spans_tpu.stats.ranks import cumulative_mass
from kmer_spans_tpu_torch.models.scoring import (
    Log2MedianScoring,
    ThresholdScoring,
    WeightScoring,
)
from kmer_spans_tpu_torch.ops import rowgather


def _counts(k, seed):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(3.0, 1 << (2 * k)).astype(np.int64)
    counts[rng.integers(0, counts.size, 40)] = rng.integers(500, 5000, 40)
    counts[: 1 << max(0, 2 * k - 4)] = 0  # a run of zero-count k-mers
    return counts


def _models(k, counts):
    rng = np.random.default_rng(k)
    return {
        "weights": WeightScoring(rng.normal(-0.3, 1.0, counts.size)),
        "threshold": ThresholdScoring(counts, 1.0 / counts.size),
        "log2_median": Log2MedianScoring(counts),
    }


@pytest.mark.parametrize("k", [10, 11])
def test_rank_row_table_equals_jax(k):
    counts = _counts(k, k)
    mass = cumulative_mass(counts)
    total = int(counts.sum())
    got = rowgather.host_row_table(mass, total)
    want = ref.host_row_table(mass, total)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == ((1 << (2 * k)) // 128, 128)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("model", ["weights", "threshold", "log2_median"])
@pytest.mark.parametrize("k,block", [(2, 512), (2, 8192), (10, 512),
                                     (11, 8192)])
def test_weight_row_table_and_decode_equal_jax(k, block, model):
    counts = _counts(k, 100 + k)
    m = _models(k, counts)[model]
    got = rowgather.host_row_table_weights(m.weights, m.threshold, block)
    want = ref.host_row_table_weights(m.weights, m.threshold, block)
    assert got[0].dtype == want[0].dtype == np.uint8
    assert got[0].shape == want[0].shape  # k = 2 pads one row of 128
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1:] == want[1:]  # step, off, scale


@pytest.mark.parametrize("k", [10, 11])
def test_row_screen_scores_equal_jax(k):
    rng = np.random.default_rng(k)
    counts = _counts(k, 7 * k)
    tab = rowgather.host_row_table(cumulative_mass(counts),
                                   int(counts.sum()))
    codes = rng.integers(0, 1 << (2 * k), 200_003).astype(np.int32)
    codes[:128] = np.arange(128) + (1 << (2 * k)) - 128  # the last row
    for thr_q in (3071, 2866, -5):
        got = rowgather.row_screen_scores(
            torch.from_numpy(tab), torch.from_numpy(codes),
            torch.tensor(thr_q, dtype=torch.int32))
        want = ref.row_screen_scores(jnp.asarray(tab), jnp.asarray(codes),
                                     jnp.int32(thr_q))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("model", ["weights", "threshold", "log2_median"])
@pytest.mark.parametrize("k", [2, 10])
def test_affine_scores_equal_jax(k, model):
    counts = _counts(k, 3 * k)
    m = _models(k, counts)[model]
    tab, step, off, _ = rowgather.host_row_table_weights(
        m.weights, m.threshold, 1024)
    codes = np.random.default_rng(k).integers(
        0, 1 << (2 * k), 100_000).astype(np.int32)
    got = rowgather.row_screen_scores_affine(
        torch.from_numpy(tab), torch.from_numpy(codes), step, off)
    want = ref.row_screen_scores_affine(jnp.asarray(tab), jnp.asarray(codes),
                                        jnp.int32(step), jnp.int32(off))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [2, 5, 9])
def test_stream_class_tables_equal_jax_and_the_device_tables(k):
    """The stream's host tables: the packed 4-bit class words (K2, K4)
    and the int16 fine table, equal to the JAX package's host tables and
    to ops/gather.py's device-side builds of the same tables."""
    from kmer_spans_tpu.parallel import stream as ref_stream
    from kmer_spans_tpu_torch.ops import gather
    from kmer_spans_tpu_torch.parallel import stream

    counts = _counts(k, 50 + k)
    mass = cumulative_mass(counts)
    total = int(counts.sum())
    m_t = torch.from_numpy(mass)
    total_f32 = torch.tensor(float(total), dtype=torch.float32)
    words = stream.host_class_words(mass, total)
    assert np.array_equal(words, ref_stream.host_class_words(mass, total))
    assert np.array_equal(
        words, gather.class_table_from_mass(m_t, total_f32).numpy())
    fine = stream.host_fine_table(mass, total)
    assert np.array_equal(fine, ref_stream.host_fine_table(mass, total))
    assert np.array_equal(fine,
                          gather.fine_class_table(m_t, total_f32).numpy())
