"""The traffic generator: one seed, one assembly; each file's parameters
met."""

import json

import numpy as np
import pytest

from _setup import BENCH, SMALL
from benchlib import genome


def params(name, **over):
    with open(BENCH / "traffic" / f"{name}.json") as fh:
        p = json.load(fh)
    p.update(over)
    return p


@pytest.mark.parametrize("name", ["chromosome", "scaffolds"])
def test_same_seed_same_assembly(name):
    p = params(name, **SMALL)
    a = genome.make_assembly(p, 2**33 + 1, 0)
    b = genome.make_assembly(p, 2**33 + 1, 0)
    c = genome.make_assembly(p, 2**33 + 2, 0)
    d = genome.make_assembly(p, 2**33 + 1, 1)
    for x, y in zip(a.bases + a.valid, b.bases + b.valid):
        assert np.array_equal(x, y)
    whole = np.concatenate(a.bases)
    assert not np.array_equal(whole, np.concatenate(c.bases))
    assert not np.array_equal(whole, np.concatenate(d.bases))


@pytest.mark.parametrize("name", ["chromosome", "scaffolds"])
def test_full_size_lengths(name):
    """At the files' own size: the total, the count and the floor."""
    p = params(name)
    lengths = genome.sequence_lengths(p)
    assert lengths.sum() == 248_956_422 == p["total_bases"]
    assert lengths.shape[0] == p["sequences"]
    if p["sequences"] > 1:
        assert lengths.min() >= p["min_sequence_bases"]
        assert np.all(np.diff(lengths) <= 0)  # longest first
        assert np.all(lengths % 65536 != 0)  # whole bases, not rounded
        assert np.array_equal(lengths, genome.sequence_lengths(p))


@pytest.mark.parametrize("name", ["chromosome", "scaffolds"])
def test_content_meets_the_parameters(name):
    p = params(name, total_bases=1 << 22, n_gap_every=1_000_000,
               n_gap_first=250_000, min_sequence_bases=2000)
    a = genome.make_assembly(p, 12345, 0)
    bases, valid = np.concatenate(a.bases), np.concatenate(a.valid)
    assert bases.shape[0] == p["total_bases"] == a.total
    assert len(a.bases) == p["sequences"]
    # N gaps exactly where the file puts them
    want = np.ones_like(valid)
    for g in range(p["n_gap_first"], p["total_bases"] - p["n_gap_bases"],
                   p["n_gap_every"]):
        want[g:g + p["n_gap_bases"]] = False
    assert np.array_equal(valid, want)
    assert np.all(bases[~valid] == 3)
    # G+C share within 0.5 points
    gc = np.isin(bases[valid], (1, 3)).mean()
    assert abs(gc - p["gc"]) < 0.005
    # repeat arrays: the share covered (overlaps counted once), lengths
    # and units within the file's ranges
    cover = np.zeros(p["total_bases"], bool)
    for s, n in zip(a.repeat_starts, a.repeat_lengths):
        cover[s:s + n] = True
    lo, hi = p["repeat_array_bases"]
    assert p["repeat_share"] * 0.9 < cover.mean() \
        < p["repeat_share"] + hi / p["total_bases"]
    assert a.repeat_lengths.min() >= lo and a.repeat_lengths.max() <= hi
    ulo, uhi = p["repeat_unit_bases"]
    assert all(ulo <= u.shape[0] <= uhi for u in a.repeat_units)
    # an array that no other array or gap overlaps repeats its unit
    ends = a.repeat_starts + a.repeat_lengths
    for s, n, u in zip(a.repeat_starts, a.repeat_lengths, a.repeat_units):
        alone = np.sum((a.repeat_starts < s + n) & (ends > s)) == 1
        if valid[s:s + n].all() and alone:
            got = bases[s:s + n]
            assert np.array_equal(got, np.resize(u, n))
            break
    else:
        pytest.fail("no array to check")


def test_every_seed_holds_the_same_repeats_elsewhere():
    p = params("chromosome", **SMALL)
    a = genome.make_assembly(p, 5, 0)
    b = genome.make_assembly(p, 6, 2)
    assert np.array_equal(a.repeat_lengths, b.repeat_lengths)
    assert all(np.array_equal(x, y)
               for x, y in zip(a.repeat_units, b.repeat_units))
    assert not np.array_equal(a.repeat_starts, b.repeat_starts)
