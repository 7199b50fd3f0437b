"""The CUDA kernels of kmer_spans_tpu_torch against their plain versions, on
the card.

Every test here needs an NVIDIA GPU and nvcc, and skips without them.  The
file imports neither JAX nor tests/conftest.py, so it runs on a machine
without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_card.py
"""

import numpy as np
import pytest
import torch

from kmer_spans_tpu_torch import api
from kmer_spans_tpu_torch.oracle import golden_genome
from kmer_spans_tpu_torch.ops import histogram, screen_scan
from kmer_spans_tpu_torch.ops.convert import to_tensor
from kmer_spans_tpu_torch.ops.histogram import count_aug, count_aug_plain
from kmer_spans_tpu_torch.ops.screen_scan import (
    fused_screen_scan,
    fused_screen_scan_plain,
)
from kmer_spans_tpu_torch.spans.pipeline import make_span_pipeline

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda", 0)


def _aug_words(rng, n, k):
    codes = rng.integers(0, 1 << (2 * k), n).astype(np.int32)
    valid = rng.random(n) < 0.9
    scored = valid & (rng.random(n) < 0.8)
    return (codes | (valid.astype(np.int32) << 16)
            | (scored.astype(np.int32) << 17)).astype(np.int32)


@pytest.mark.parametrize("k", [4, 6, 8])
def test_count_aug_kernel_matches_plain(card, k):
    rng = np.random.default_rng(100 + k)
    aug = _aug_words(rng, (1 << 20) + 3, k)
    aug[5000:5000 + (1 << 17)] = (1 << 16) | 7  # 2^17 identical codes
    x = to_tensor(aug, card)
    before = histogram.launches
    for view in (x, x[1:]):  # 16-byte aligned and unaligned starts
        got = count_aug(view, k)
        torch.cuda.synchronize()
        assert torch.equal(got, count_aug_plain(view, k))
    assert histogram.launches == before + 2


@pytest.mark.parametrize("block", [1024, 8192])
@pytest.mark.parametrize("class_bits", [2, 4])
@pytest.mark.parametrize("k", [4, 8])
def test_screen_scan_kernel_matches_plain(card, k, class_bits, block):
    rng = np.random.default_rng(k + class_bits + block)
    nw = (1 << (2 * k)) // (32 // class_bits)
    words = rng.integers(-(2 ** 31), 2 ** 31, nw, dtype=np.int64).astype(
        np.int32)
    aug = _aug_words(rng, 6 * block, k)
    aug[block:2 * block] &= ~(1 << 17)  # no scored position
    args = (to_tensor(words, card), to_tensor(aug, card),
            torch.tensor(3071, dtype=torch.int32, device=card), class_bits,
            block)
    before = screen_scan.launches
    got = fused_screen_scan(*args)
    torch.cuda.synchronize()
    assert screen_scan.launches == before + 1
    for g, w in zip(got, fused_screen_scan_plain(*args)):
        assert torch.equal(g, w)
    assert got[1][1].item() <= -(1 << 29)  # the no-scored sentinel


def test_wrappers_raise_on_mixed_devices(card):
    words = torch.zeros(512, dtype=torch.int32)
    aug = torch.zeros(2048, dtype=torch.int32, device=card)
    thr_q = torch.tensor(3000, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        fused_screen_scan(words, aug, thr_q, 4, 1024)


@pytest.mark.parametrize("packed", [False, True])
def test_pipeline_kernels_match_plain_versions(card, packed, monkeypatch):
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 4, 64 * 8192).astype(np.uint8)
    arr[rng.random(arr.size) < 0.001] = 4
    arr[100_000:103_000] = np.tile(np.array([0, 3], np.uint8), 1500)
    fn = make_span_pipeline(8, cand_blocks=16, packed=packed, device=card)
    before = histogram.launches, screen_scan.launches
    got = fn(arr, 0.75)
    assert (histogram.launches, screen_scan.launches) == (
        before[0] + 1, before[1] + 1)
    monkeypatch.setattr(histogram, "count_aug", count_aug_plain)
    monkeypatch.setattr(screen_scan, "fused_screen_scan",
                        fused_screen_scan_plain)
    want = fn(arr, 0.75)
    if packed:
        assert torch.equal(got, want)
    else:
        for key in want:
            assert torch.equal(got[key], want[key]), key


def test_api_on_card_equals_cpu(card):
    seq = golden_genome()
    got = api.kmer_low_comp_regions(seq, 8, 100, 20.0, device=card)
    want = api.kmer_low_comp_regions(seq, 8, 100, 20.0, device="cpu")
    assert len(got.regions) == 3
    assert np.array_equal(got.regions, want.regions)
    assert np.array_equal(got.counts, want.counts)


def test_api_overflow_reruns_on_card(card, monkeypatch):
    rng = np.random.default_rng(2)
    seq = rng.integers(0, 4, 40_000).astype(np.uint8)
    seq[9_000:9_800] = np.tile(np.array([3, 2], np.uint8), 400)
    seq[30_000:30_600] = 0
    packed = api._as_seq_list("".join("ACGT"[b] for b in seq))
    monkeypatch.setattr(api, "exact_fallbacks", 0)
    got = api._low_comp_fast(packed, 6, 30, 3.0, 0.75, card, block=1024,
                             cand_blocks=1)
    assert api.exact_fallbacks >= 1
    want = api._low_comp_fast(packed, 6, 30, 3.0, 0.75, torch.device("cpu"),
                              block=1024)
    assert len(got.regions) >= 2
    assert np.array_equal(got.regions, want.regions)
