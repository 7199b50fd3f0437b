"""The port's K4 (ops/gather.py word_gather) and fine table against JAX's.

The plain K4 must equal the reference's pallas_word_gather (interpret
mode, as tests/test_gather_kernel.py runs it) followed by the nibble
extract and class_scores_int, exactly: for the class tables at k in
{2, 3, 4, 6, 8, 9} and the sort screen's 16384-word table, on random
entries and entries at the table's edges.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmer_spans_tpu.ops import gather as ref
from kmer_spans_tpu_torch.ops import gather
from kmer_spans_tpu_torch.ops.gather import (
    fine_class_table,
    fine_scores_int,
    word_gather,
    word_gather_plain,
)


def _ref_scores(words, entry, thr_q):
    tabR = ref.prerolled_table(jnp.asarray(words))
    w = ref.pallas_word_gather(tabR, jnp.asarray(entry) >> 3)
    nib = (w >> ((jnp.asarray(entry) & 7) * ref.CLASS_BITS)) \
        & (ref.CLASS_LEVELS - 1)
    return np.asarray(ref.class_scores_int(nib, jnp.int32(thr_q)))


def _entries(rng, n_words):
    top = 8 * n_words
    edges = np.array([0, 1, 7, 8, top - 9, top - 8, top - 2, top - 1])
    edges = edges[(edges >= 0) & (edges < top)]
    return np.concatenate([
        rng.integers(0, top, 5000), edges,
        np.arange(top - 8, top),  # every nibble of the last word
    ]).astype(np.int32)


@pytest.mark.parametrize("n_words", [2, 8, 32, 512, 8192, 32768, 16384],
                         ids=["k2", "k3", "k4", "k6", "k8", "k9", "sort"])
def test_plain_word_gather_matches_pallas(n_words):
    rng = np.random.default_rng(n_words)
    words = rng.integers(-(2 ** 31), 2 ** 31, n_words,
                         dtype=np.int64).astype(np.int32)
    entry = _entries(rng, n_words)
    for thr in (0.5, 0.75):
        thr_q = int(np.floor(np.float32(thr) * np.float32(4096))) - 1
        want = _ref_scores(words, entry, thr_q)
        before = gather.launches
        got = word_gather(torch.from_numpy(words), torch.from_numpy(entry),
                          torch.tensor(thr_q, dtype=torch.int32))
        assert gather.launches == before  # the CPU takes the plain version
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_word_gather_wraps_and_keeps_shape():
    rng = np.random.default_rng(3)
    words = rng.integers(-(2 ** 31), 2 ** 31, 64,
                         dtype=np.int64).astype(np.int32)
    entry = rng.integers(-(2 ** 31), 2 ** 31, (37, 11),
                         dtype=np.int64).astype(np.int32)
    got = word_gather_plain(torch.from_numpy(words), torch.from_numpy(entry),
                            torch.tensor([3071], dtype=torch.int32))
    w = words[(entry >> 3) & 63].astype(np.int64)
    nib = (w >> ((entry & 7) * 4)) & 15
    assert got.shape == entry.shape
    assert np.array_equal(got.numpy(), (nib + 1) * 256 + 3 - 3071)


@pytest.mark.parametrize("k", [2, 5, 10])
def test_fine_table_and_scores_match_jax(k):
    rng = np.random.default_rng(40 + k)
    size = 1 << (2 * k)
    counts = rng.integers(0, 60, size).astype(np.int32)
    counts[rng.random(size) < 0.3] = 0
    order = np.argsort(counts, kind="stable")
    mass = np.zeros(size, np.int64)
    mass[order] = np.concatenate([[0], np.cumsum(counts[order])[:-1]])
    mass = mass.astype(np.int32)
    total = np.float32(counts.sum())
    want = np.asarray(ref.fine_class_table(jnp.asarray(mass),
                                           jnp.float32(total)))
    got = fine_class_table(torch.from_numpy(mass), torch.tensor(total))
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy(), want)
    codes = rng.integers(0, size, 3000).astype(np.int32)
    thr_q = np.int32(3071)
    want_s = np.asarray(ref.fine_scores_int(jnp.asarray(want)[codes],
                                            jnp.int32(thr_q)))
    got_s = fine_scores_int(got[torch.from_numpy(codes).long()],
                            torch.tensor(thr_q))
    assert got_s.dtype == torch.int32
    assert np.array_equal(got_s.numpy(), want_s)
    # total 0 divides by 1: every rank is 0, every entry 1
    zero = fine_class_table(torch.zeros(size, dtype=torch.int32),
                            torch.tensor(0.0))
    assert (zero == 1).all()


def test_word_gather_rejects_bad_tables_and_types():
    entry = torch.zeros(100, dtype=torch.int32)
    thr_q = torch.tensor(3071, dtype=torch.int32)
    for nw in (1, 3, 24, 1 << 16):
        with pytest.raises(ValueError):
            word_gather(torch.zeros(nw, dtype=torch.int32), entry, thr_q)
    words = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        word_gather(words.reshape(8, 8), entry, thr_q)
    with pytest.raises(TypeError):
        word_gather(words.long(), entry, thr_q)
    with pytest.raises(TypeError):
        word_gather(words, entry.long(), thr_q)
    with pytest.raises(TypeError):
        word_gather(words, entry, thr_q.float())
    with pytest.raises(ValueError):
        word_gather(words, entry, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        word_gather(words, entry.reshape(10, 10).t(), thr_q)
