"""K1 (count_aug) and K2 (fused_screen_scan) of kmer_spans_tpu_torch.

On the CPU the wrappers run their plain PyTorch versions, held here
against the reference's Pallas kernels (interpret mode, as the reference's
own tests run them on the CPU) and against the reference's plain JAX
formulation.  Integers: exact.  The CUDA kernels themselves are held
against these plain versions on the card in tests/test_torch_card.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmer_spans_tpu.ops.blocked import (
    blocked_scan_summaries_int as jax_summaries,
)
from kmer_spans_tpu.ops.gather import class_scores_int as jax_class_scores
from kmer_spans_tpu.ops.gather import prerolled_table
from kmer_spans_tpu.ops.pallas_kernels import pallas_count_aug
from kmer_spans_tpu.ops.screen_scan import fused_screen_scan as jax_fused
from kmer_spans_tpu_torch.ops import histogram, screen_scan
from kmer_spans_tpu_torch.ops.histogram import count_aug, count_aug_plain
from kmer_spans_tpu_torch.ops.screen_scan import (
    fused_screen_scan,
    fused_screen_scan_plain,
)


def tab_words_from_prerolled(tabR: np.ndarray) -> np.ndarray:
    """Invert the reference's ``prerolled_table`` (ops/gather.py).

    tabR: (8, rows, 128) int32, tabR[d, 8w + p] = words[8w + ((p - d) & 7)].
    Copy d = 0 is the table itself; returns its rows * 128 int32 words
    (the packed table, zero-padded to whole 8-row windows).  Raises if the
    eight copies do not agree.
    """
    tabR = np.asarray(tabR)
    if tabR.ndim != 3 or tabR.shape[0] != 8 or tabR.shape[1] % 8:
        raise ValueError(f"not a pre-rolled table: shape {tabR.shape}")
    words = tabR[0]
    r = np.arange(words.shape[0])
    for d in range(1, 8):
        if not np.array_equal(tabR[d], words[(r & ~7) | ((r - d) & 7)]):
            raise ValueError(f"pre-rolled copy {d} disagrees with copy 0")
    return np.array(words.reshape(-1), dtype=np.int32)  # a writable copy


def _aug_words(rng, n, k, p_valid=0.9, p_scored=0.8):
    """Random aug words: code | valid << 16 | scored << 17 (scored implies
    valid), codes below 4^k."""
    codes = rng.integers(0, 1 << (2 * k), n).astype(np.int32)
    valid = rng.random(n) < p_valid
    scored = valid & (rng.random(n) < p_scored)
    return (codes | (valid.astype(np.int32) << 16)
            | (scored.astype(np.int32) << 17)).astype(np.int32)


def _class_words(rng, k, class_bits):
    n_words = (1 << (2 * k)) // (32 // class_bits)
    return rng.integers(-(2 ** 31), 2 ** 31, n_words, dtype=np.int64).astype(
        np.int32)


# ---------------------------------------------------------------- K1

@pytest.mark.parametrize("k", [4, 6, 8])
def test_count_aug_plain_matches_pallas(k):
    rng = np.random.default_rng(40 + k)
    aug = _aug_words(rng, 40_000, k)
    aug[1000:9000] = (1 << 16) | 5  # a long run on one bin
    if k < 8:
        # valid words whose 16-bit code lies past 4^k count nowhere
        aug[20:40] = (1 << 16) | (1 << (2 * k)) + 3
    want = np.asarray(pallas_count_aug(jnp.asarray(aug), k, tile=16384))
    got = count_aug(torch.from_numpy(aug), k)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert got.sum().item() == want.sum()


def test_count_aug_cpu_takes_plain_version():
    rng = np.random.default_rng(1)
    aug = torch.from_numpy(_aug_words(rng, 5000, 6))
    before = histogram.launches
    assert torch.equal(count_aug(aug, 6), count_aug_plain(aug, 6))
    assert histogram.launches == before  # no kernel ran


def test_count_aug_rejects_bad_input():
    aug = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        count_aug(aug, 9)
    with pytest.raises(TypeError):
        count_aug(aug.to(torch.int64), 6)
    with pytest.raises(ValueError):
        count_aug(torch.zeros((8, 8), dtype=torch.int32).t(), 6)


# ---------------------------------------------------------------- K2

def _k2_case(k, class_bits, block=1024, nblocks=4, seed=0):
    rng = np.random.default_rng(seed + 10 * k + class_bits)
    words = _class_words(rng, k, class_bits)
    aug = _aug_words(rng, block * nblocks, k)
    aug[block:2 * block] &= ~(1 << 17)  # a block with no scored position
    aug[3 * block:3 * block + 100] &= ~(1 << 17)  # starts unscored
    return words, aug


@pytest.mark.parametrize("class_bits", [2, 4])
@pytest.mark.parametrize("k", [4, 8])
def test_screen_scan_plain_matches_pallas(k, class_bits):
    block = 1024
    words, aug = _k2_case(k, class_bits, block)
    thr_q = np.int32(3071)
    want = jax_fused(prerolled_table(jnp.asarray(words)), jnp.asarray(aug),
                     jnp.int32(thr_q), class_bits=class_bits, block=block)
    tab = tab_words_from_prerolled(np.asarray(prerolled_table(
        jnp.asarray(words))))
    got = fused_screen_scan(
        torch.from_numpy(tab), torch.from_numpy(aug),
        torch.tensor(thr_q, dtype=torch.int32), class_bits, block)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the all-unscored block keeps the -2^30 sentinel in its B-parts
    assert got[1][1].item() <= -(1 << 29) and got[3][1].item() <= -(1 << 29)


@pytest.mark.parametrize("class_bits", [2, 4])
@pytest.mark.parametrize("k", [4, 6, 8])
def test_screen_scan_plain_matches_jax_summaries(k, class_bits):
    """The plain version against the reference's unfused formulation:
    packed-class gather, class_scores_int and blocked_scan_summaries_int."""
    block = 1024
    words, aug = _k2_case(k, class_bits, block, nblocks=3, seed=5)
    thr_q = 2866
    epw = 32 // class_bits
    c = aug & 0xFFFF
    nib = ((words[c // epw] >> ((c % epw) * class_bits))
           & ((1 << class_bits) - 1))
    if class_bits == 4:
        s = np.asarray(jax_class_scores(jnp.asarray(nib), jnp.int32(thr_q)))
    else:  # the reference's fused kernel: unit 4096 / 4 for 2-bit classes
        s = (nib + 1) * 1024 + 3 - thr_q
    scored = ((aug >> 17) & 1) == 1
    want = jax_summaries(jnp.asarray(s.reshape(-1, block)),
                         jnp.asarray(scored.reshape(-1, block)))
    got = fused_screen_scan(
        torch.from_numpy(words), torch.from_numpy(aug),
        torch.tensor(thr_q, dtype=torch.int32), class_bits, block)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_screen_scan_cpu_takes_plain_version():
    words, aug = _k2_case(6, 4)
    args = (torch.from_numpy(words), torch.from_numpy(aug),
            torch.tensor(3000, dtype=torch.int32), 4, 1024)
    before = screen_scan.launches
    for g, w in zip(fused_screen_scan(*args), fused_screen_scan_plain(*args)):
        assert torch.equal(g, w)
    assert screen_scan.launches == before


def test_screen_scan_rejects_bad_input():
    words = torch.zeros(512, dtype=torch.int32)
    aug = torch.zeros(2048, dtype=torch.int32)
    thr_q = torch.tensor(3000, dtype=torch.int32)
    with pytest.raises(ValueError):  # block not a multiple of 256
        fused_screen_scan(words, aug, thr_q, 4, 1000)
    with pytest.raises(ValueError):  # n not a multiple of block
        fused_screen_scan(words, aug[:1536], thr_q, 4, 1024)
    with pytest.raises(ValueError):  # table length not a power of two
        fused_screen_scan(words[:500], aug, thr_q, 4, 1024)
    with pytest.raises(ValueError):
        fused_screen_scan(words, aug, thr_q, 3, 1024)
    with pytest.raises(TypeError):
        fused_screen_scan(words, aug.to(torch.int64), thr_q, 4, 1024)


def test_tab_words_from_prerolled_inverts():
    rng = np.random.default_rng(3)
    for n_words in (32, 4096, 8192):
        words = rng.integers(-(2 ** 31), 2 ** 31, n_words).astype(np.int32)
        tabR = np.asarray(prerolled_table(jnp.asarray(words)))
        tab = tab_words_from_prerolled(tabR)
        assert np.array_equal(tab[:n_words], words)
        assert not tab[n_words:].any()
    tabR = tabR.copy()
    tabR[3, 0, 0] ^= 1
    with pytest.raises(ValueError):
        tab_words_from_prerolled(tabR)
