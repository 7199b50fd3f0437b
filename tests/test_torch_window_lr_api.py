"""The port's window_kmer_dist and lr_regions against the JAX package's api.

Both packages' api on the same seeded inputs: the port on device="cpu"
(K3's plain version), the JAX package with backend="jax" (JAX on the
CPU, its K3 in interpret mode).  dist, seq_i and the positions matrices
must be equal exactly; regions with their f64 scores ==, and kmer_scores
==.  The reference's lr_regions serves a sequence whose candidate blocks
outnumber its pull capacity with the CPU oracle; the port pulls them in
further batches on the device and counts each in api.exact_fallbacks.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from kmer_spans_tpu import api as ref_api
from kmer_spans_tpu_torch import api
from kmer_spans_tpu_torch.encoding import kmer_to_code
from kmer_spans_tpu_torch.oracle import find_tr_regions

from conftest import random_seq


def _seqs(seed, n=6000):
    rng = np.random.default_rng(seed)
    seqs = []
    for i in range(3):
        s = list(random_seq(rng, n + 1500 * i, n_prob=0.004))
        s[1000:1240] = "CG" * 120
        seqs.append("".join(s))
    seqs.insert(1, "ACGTA")  # shorter than every window: flagged 0
    return seqs


# ------------------------------------------------------- window_kmer_dist

@pytest.mark.parametrize("seed,kmers,window,freq,ret_flag", [
    (0, ["CG", "GC"], 6, False, 1),
    (1, ["ACG", "TTT", "GAG"], 24, True, 0),
    (2, ["A", "C", "G", "T"], 300, False, 1),   # int16 positions
    (3, api.kmer_seq(2), 40, False, 1),          # the 16 dimers
])
def test_window_kmer_dist_equals_jax(seed, kmers, window, freq, ret_flag):
    seqs = _seqs(seed)
    got = api.window_kmer_dist(seqs, kmers, window, freq=freq,
                               ret_flag=ret_flag, device="cpu")
    want = ref_api.window_kmer_dist(seqs, kmers, window, freq=freq,
                                    ret_flag=ret_flag, backend="jax")
    assert got.dist.dtype == want.dist.dtype
    assert np.array_equal(got.dist, want.dist)
    assert np.array_equal(got.seq_i, want.seq_i)
    assert list(got.seq_i) == [1, 0, 1, 1]
    assert got.kmers == want.kmers
    if ret_flag:
        assert len(got.scores) == len(want.scores) == 4
        for g, w in zip(got.scores, want.scores):
            if w is None:
                assert g is None
            else:
                assert g.dtype == w.dtype and np.array_equal(g, w)
    else:
        assert got.scores is None and want.scores is None


def test_window_kmer_dist_hand_trace():
    res = api.window_kmer_dist(["CGCCAATGCG", "AC"], ["CG", "GC"], 6,
                               freq=False, ret_flag=1, device="cpu")
    assert tuple(res.dist[:2, 0]) == (3, 2)
    assert tuple(res.dist[:2, 1]) == (1, 4)
    assert list(res.seq_i) == [1, 0]
    assert res.scores[0] is not None and res.scores[1] is None
    assert list(res.scores[0][:, 0][:5]) == [1, 0, 0, 0, 1]
    freq = api.window_kmer_dist("CGCCAATGCG", ["CG"], 6, device="cpu")
    assert freq.dist[:, 0].sum() == pytest.approx(1.0)


def test_window_kmer_dist_validation():
    with pytest.raises(ValueError):
        api.window_kmer_dist("ACGTACGT", ["CG", "CGG"], 6, device="cpu")
    with pytest.raises(ValueError):
        api.window_kmer_dist("ACGTACGT", ["CG"], 3, device="cpu")  # < 2k
    with pytest.raises(ValueError):
        api.window_kmer_dist("ACGTACGT", ["A" * 16], 40, device="cpu")


# ------------------------------------------------------------- lr_regions

def _lr_tables(kmers, hot=("CG",), seed=(2.0, 2.0), other=(-1.0, -0.5)):
    ks = [seed[0] if km in hot else other[0] for km in kmers]
    ts = [seed[1] if km in hot else other[1] for km in kmers]
    return ks, ts


def test_lr_regions_vector():
    seq = "ATATATATCGCGCGCGCGCGATATATATATATATATCGCGCG"
    kmers = api.kmer_seq(2)
    ks, ts = _lr_tables(kmers)
    res = api.lr_regions(seq, (2, 4), kmers, ks, ts, device="cpu")
    want = ref_api.lr_regions(seq, (2, 4), kmers, ks, ts, backend="jax")
    assert np.array_equal(res.regions, want.regions)
    assert np.array_equal(res.kmer_scores, want.kmer_scores)
    r = res.regions[0]
    assert len(res.regions) == 1
    assert (r["seq_id"], r["beg"], r["end"], r["score"]) == (1, 10, 20, 9.5)
    cg = kmer_to_code("CG")
    assert tuple(res.kmer_scores[cg]) == (2.0, 2.0)


@pytest.mark.parametrize("seed,k,min_length", [(0, 2, 20), (2, 3, 10),
                                               (3, 2, 0)])
def test_lr_regions_equal_jax(seed, k, min_length):
    seqs = _seqs(10 + seed)
    kmers = api.kmer_seq(k)
    hot = ("CG",) if k == 2 else ("CGC", "GCG")
    ks, ts = _lr_tables(kmers, hot)
    got = api.lr_regions(seqs, (k, min_length), kmers, ks, ts, device="cpu")
    want = ref_api.lr_regions(seqs, (k, min_length), kmers, ks, ts,
                              backend="jax")
    assert got.regions.dtype == want.regions.dtype
    assert np.array_equal(got.regions, want.regions)
    assert np.array_equal(got.kmer_scores, want.kmer_scores)
    assert len(got.regions) >= 3
    assert set(got.regions["seq_id"]) >= {1, 3, 4}  # seq_id from 1
    tabs = got.kmer_scores
    want_o = [r for i, s in enumerate(seqs)
              for r in find_tr_regions(s, i + 1, k, tabs[:, 0], tabs[:, 1],
                                       min_length)]
    assert [tuple(r)[:4] for r in got.regions] == want_o


def test_lr_regions_alphabetical_order_reorder():
    seq = "ATATATATCGCGCGCGCGCGATATATATATATATATCGCGCG"
    kmers = sorted(api.kmer_seq(2))
    ks, ts = _lr_tables(kmers)
    res = api.lr_regions(seq, (2, 4), kmers, ks, ts, device="cpu")
    want = ref_api.lr_regions(seq, (2, 4), kmers, ks, ts, backend="jax")
    assert len(res.regions) == 1 and res.regions[0]["beg"] == 10
    assert np.array_equal(res.kmer_scores, want.kmer_scores)


def test_lr_regions_validation():
    kmers = api.kmer_seq(2)
    ks, ts = _lr_tables(kmers)
    for params in ((0, 4), (16, 4), (2, -1)):
        with pytest.raises(ValueError):
            api.lr_regions("ACGT", params, kmers, ks, ts, device="cpu")
    with pytest.raises(ValueError):
        api.lr_regions("ACGT", (2, 4), kmers[:15], ks[:15], ts[:15],
                       device="cpu")


def test_lr_regions_counts_extra_pull_batches(monkeypatch):
    """Where the candidate blocks outnumber C the reference's api falls
    back to its CPU oracle; the port pulls further batches on the device,
    each counted, and gives the same regions."""
    seq = "".join(_seqs(7, n=40_000))
    kmers = api.kmer_seq(2)
    ks, ts = _lr_tables(kmers)
    want = ref_api.lr_regions(seq, (2, 20), kmers, ks, ts, backend="jax")
    monkeypatch.setattr(api, "device_tr_regions", functools.partial(
        api.device_tr_regions, block=512, cand_blocks=2))
    monkeypatch.setattr(api, "exact_fallbacks", 0)
    got = api.lr_regions(seq, (2, 20), kmers, ks, ts, device="cpu")
    assert api.exact_fallbacks >= 2
    assert np.array_equal(got.regions, want.regions)


# ------------------------------------------------------------- both

def test_results_match_the_reference_fields():
    for ours, ref in ((api.LrRegionResult, ref_api.LrRegionResult),
                      (api.WindowDistResult, ref_api.WindowDistResult)):
        assert [f.name for f in dataclasses.fields(ours)] == \
            [f.name for f in dataclasses.fields(ref)]


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the call would run there")
    kmers = api.kmer_seq(2)
    ks, ts = _lr_tables(kmers)
    with pytest.raises(RuntimeError):
        api.lr_regions("ACGTACGT" * 10, (2, 4), kmers, ks, ts)
    with pytest.raises(RuntimeError):
        api.window_kmer_dist("ACGTACGT" * 10, ["CG"], 20)
    with pytest.raises(RuntimeError):
        api.window_kmer_dist("ACGTACGT" * 10, ["CG"], 20, device="cuda:0")
