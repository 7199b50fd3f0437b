"""The plain reference against the program's CPU result, its sequential
oracle and plain loops.  The comparisons are made here, never in the
reference."""

import json

import numpy as np
import pytest

from _setup import BENCH, SMALL
from benchlib import genome
from reference import low_comp_regions as ref

from kmer_spans_tpu_torch import api, oracle
from kmer_spans_tpu_torch.encoding import PackedSeq

FIELDS = ("seq_id", "beg", "end", "score")


def assembly(name, seed, **over):
    with open(BENCH / "traffic" / f"{name}.json") as fh:
        p = dict(json.load(fh), **SMALL)
    p.update(over)
    return genome.make_assembly(p, seed, 0)


def same_regions(got, want):
    assert got.shape[0] == want.shape[0]
    for f in FIELDS:
        assert np.array_equal(got[f], want[f]), f


@pytest.mark.parametrize("name,k,seed,over", [
    ("chromosome", 8, 2**31 + 5, {}), ("scaffolds", 8, 7, {}),
    ("chromosome", 12, 11, {}),
    ("scaffolds", 12, 2**33 + 3, {"sequences": 12})])
def test_equals_the_program_on_the_cpu(name, k, seed, over):
    a = assembly(name, seed, **over)
    seqs = [PackedSeq(bases=b, valid=v) for b, v in zip(a.bases, a.valid)]
    got = api.kmer_low_comp_regions(seqs, k, 100, 50, thr=0.6,
                                    device="cpu")
    want = ref.low_comp_regions(list(zip(a.bases, a.valid)), k, 100, 50,
                                0.6)
    assert np.array_equal(got.counts, want["counts"])
    assert got.n[0] == want["n"] and got.n[1] == 0
    assert np.array_equal(got.w_rank, want["w_rank"])
    assert len(want["regions"]) > 5
    same_regions(got.regions, want["regions"])


def tied_table(k, rng):
    """Weights in steps of 0.1 in [-1, 1]: prefix sums tie and cross zero
    where a sequential fold does not."""
    return np.round(rng.integers(-10, 11, 1 << (2 * k)) * 0.1, 1)


@pytest.mark.parametrize("k,seed", [(2, 1), (4, 2), (8, 3)])
def test_regions_equal_the_oracle_on_tied_tables(k, seed):
    rng = np.random.default_rng(seed)
    a = assembly("scaffolds", seed, total_bases=1 << 17, n_gap_every=40_000,
                 n_gap_first=20_000, sequences=6, min_sequence_bases=1000)
    w = tied_table(k, rng)
    want = []
    for i, (b, v) in enumerate(zip(a.bases, a.valid)):
        want += oracle.find_regions(PackedSeq(bases=b, valid=v), i, 20, 2.0,
                                    w, k, 0.0)
    got = ref.regions(list(zip(a.bases, a.valid)), k, w, 0.0, 20, 2.0)
    assert len(want) > 10
    assert [tuple(r) for r in got.tolist()] == [
        (s, b, e, x) for s, b, e, x in want]


def loop_fold(s, starts):
    out, run = np.empty_like(s), s.dtype.type(0)
    starts = set(starts.tolist())
    for i, x in enumerate(s):
        if i in starts:
            run = s.dtype.type(0)
        run = run + x
        if run < 0:
            run = s.dtype.type(0)
        out[i] = run
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n,drift", [(5000, -0.05), (70_000, 0.0),
                                     (20_000, 0.02)])
def test_fold_equals_a_loop(dtype, n, drift):
    rng = np.random.default_rng(n)
    s = (np.round(rng.normal(drift, 1.0, n), 1)).astype(dtype)
    starts = np.unique(np.r_[0, rng.integers(0, n, 7)])
    assert np.array_equal(ref.fold(s, starts), loop_fold(s, starts))


@pytest.mark.parametrize("k", [1, 3, 8, 12, 15])
def test_kmer_codes(k):
    b = np.random.default_rng(k).integers(0, 4, 300).astype(np.uint8)
    want = [sum(int(b[i + j]) << (2 * (k - 1 - j)) for j in range(k))
            for i in range(300 - k + 1)]
    assert ref.kmer_codes(b, k).tolist() == want


def test_ranks_follow_the_chain():
    counts = np.array([3, 0, 5, 3, 1, 0, 5, 2])
    want, r = np.zeros(8), 0.0
    for i in np.argsort(counts, kind="stable"):
        want[i] = r
        r += counts[i] / 19
    assert np.array_equal(ref.weighted_ranks(counts, 19), want)


def test_processes_give_what_one_gives(monkeypatch):
    monkeypatch.setattr(ref, "_BATCH", 1 << 16)  # several groups
    a = assembly("scaffolds", 5, total_bases=1 << 18, sequences=20)
    seqs = list(zip(a.bases, a.valid))
    one = ref.low_comp_regions(seqs, 8, 100, 50, 0.6)
    two = ref.low_comp_regions(seqs, 8, 100, 50, 0.6, workers=2)
    assert np.array_equal(one["counts"], two["counts"])
    assert np.array_equal(one["w_rank"], two["w_rank"])
    same_regions(two["regions"], one["regions"])
