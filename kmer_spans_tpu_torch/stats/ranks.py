"""Spectrum statistics on the host: median frequency, integer rank mass,
reference-exact f64 chain ranks from that mass, and both over a sparse
spectrum (wide k).

The port's own copies of ``spectrum_median_freq``, ``cumulative_mass``,
``chain_ranks_from_mass``, ``sparse_mass`` and ``SparseRanks`` from
``kmer_spans_tpu/stats/ranks.py``; the weighted ranks themselves are
``oracle.weighted_ranks``.
"""

from __future__ import annotations

import numpy as np

from ..utils import native


def spectrum_median_freq(counts: np.ndarray) -> float:
    """Median k-mer frequency over *counted positions* (for log2(f/f_med)).

    The median over k-mer instances (each counted position contributes its
    k-mer's frequency), i.e. the weighted median of the spectrum.
    """
    counts = np.asarray(counts, dtype=np.int64)
    total = counts.sum()
    if total == 0:
        return 0.0
    order = np.argsort(counts, kind="stable")
    cum = np.cumsum(counts[order])
    # first sorted position where cumulative mass reaches half
    half = (total + 1) // 2
    idx = int(np.searchsorted(cum, half))
    return counts[order[idx]] / total


def cumulative_mass(counts: np.ndarray) -> np.ndarray:
    """Integer rank numerators: rank[kmer] * total, exactly (int64).

    rank[kmer] = cumulative_mass[kmer] / total, with the spectrum sorted
    stably by count (ties by k-mer index).
    """
    counts = np.asarray(counts, dtype=np.int64)
    order = np.argsort(counts, kind="stable")
    sorted_mass = np.concatenate([[0], np.cumsum(counts[order][:-1])])
    mass = np.empty_like(sorted_mass)
    mass[order] = sorted_mass
    return mass


def chain_ranks_from_mass(
    pm: np.ndarray, value_hist: np.ndarray, total: int,
    chunk: int = 1 << 26,
) -> np.ndarray:
    """Reference-exact f64 chain ranks for k-mers given their integer mass,
    WITHOUT the 4^k table.

    pm: int64 cumulative-mass values of the queried k-mers.  value_hist:
    int64 MASS histogram over count values (value_hist[v] = v * #codes
    with count v).  total: total counted k-mers.

    Why this is exact: the reference's rank chain
    (src/kmer_spans.c:198-200) left-folds counts[sorted]/total in f64.
    Zero terms are exact no-ops (fl(S + 0.0) == S for S >= 0), and equal
    counts contribute bit-identical terms, so the fold sequence is fully
    determined by the multiset of count values, the value histogram.
    A queried k-mer's fold position follows from its mass: the group g
    with below[g] <= pm < below[g+1] gives its count v = v_vals[g] and
    within-group index r = (pm - below[g]) / v (mass grows by exactly v
    per equal-count k-mer), so rank = fold of (nnz_before[g] + r) terms.

    Memory is O(#nonzero-count codes) per chunk (the fold is streamed),
    never O(4^k).

    value_hist may also be a SPARSE (v_vals, n_codes) tuple: distinct
    count values ascending plus their code multiplicities (the native
    ks_mass_of_codes output).

    From 2^22 terms the host library's streaming fold serves it
    (utils/native.py chain_from_hist, bit-identical); below, the chunked
    numpy fold (``_chain_fold``).
    """
    pm = np.asarray(pm, dtype=np.int64)
    v_vals, h = _value_groups(value_hist)
    if int(h.sum()) >= (1 << 22):
        # the C streaming fold: one pass, where the chunked numpy fold is
        # seconds at 100M terms
        return native.chain_from_hist(
            v_vals, h, float(total), pm.reshape(-1)).reshape(pm.shape)
    return _chain_fold(pm, v_vals, h, total, chunk)


def _value_groups(value_hist):
    """(count values present, ascending; codes a value) from either form
    of ``value_hist``."""
    if isinstance(value_hist, tuple):
        v_vals = np.asarray(value_hist[0], dtype=np.int64)
        h = np.asarray(value_hist[1], dtype=np.int64)
        keep = v_vals > 0
        return v_vals[keep], h[keep]
    value_hist = np.asarray(value_hist, dtype=np.int64)
    v_vals = np.nonzero(value_hist[1:])[0] + 1  # values present, asc
    h = value_hist[v_vals] // v_vals  # codes per group
    if (h * v_vals != value_hist[v_vals]).any():
        raise ValueError("value_hist is not a mass histogram")
    return v_vals, h


def _chain_fold(pm, v_vals, h, total, chunk=1 << 26):
    """``chain_ranks_from_mass`` by the chunked numpy fold at any size:
    the fold streamed in chunks of terms, each query answered at its
    prefix.  The oracle's ``SparseRanks`` takes it alone, so that the
    oracle never loads the host library."""
    gmass = v_vals * h
    below = np.concatenate([[0], np.cumsum(gmass)[:-1]])  # mass before group
    nnz_before = np.concatenate([[0], np.cumsum(h)[:-1]])
    g = np.searchsorted(below, pm, side="right") - 1
    if v_vals.size == 0:
        return np.zeros(pm.shape, np.float64)
    v = v_vals[g]
    r, rem = np.divmod(pm - below[g], v)
    if rem.any():
        raise ValueError("pm is not a cumulative_mass value")
    p = nnz_before[g] + r  # fold length for each query
    # stream the fold in chunks; record requested prefixes
    out = np.empty(pm.shape, np.float64)
    order = np.argsort(p.reshape(-1), kind="stable")
    ps = p.reshape(-1)[order]
    nnz_total = int(nnz_before[-1] + h[-1])
    qi = 0
    # answer p == 0 queries (all-zero prefix)
    while qi < ps.size and ps[qi] == 0:
        out.reshape(-1)[order[qi]] = 0.0
        qi += 1
    carry = 0.0
    done = 0  # terms folded so far
    gi = 0    # current group
    used = 0  # terms of current group consumed
    inv_terms = v_vals.astype(np.float64) / np.float64(total)
    while done < nnz_total and qi < ps.size:
        m = min(chunk, nnz_total - done)
        seg = np.empty(m, np.float64)
        fill = 0
        while fill < m:
            take = min(int(h[gi]) - used, m - fill)
            seg[fill:fill + take] = inv_terms[gi]
            fill += take
            used += take
            if used == h[gi]:
                gi += 1
                used = 0
        seg[0] = carry + seg[0]  # seed: fl(carry + t) == accumulate step
        acc = np.add.accumulate(seg)
        while qi < ps.size and ps[qi] <= done + m:
            out.reshape(-1)[order[qi]] = acc[ps[qi] - done - 1]
            qi += 1
        carry = acc[-1]
        done += m
    return out


def sparse_mass(ucodes: np.ndarray, ucounts: np.ndarray):
    """Exact integer rank numerators for a SPARSE spectrum.

    ucodes: distinct k-mer codes, ascending (int64 — wide codes welcome);
    ucounts: their counts.  Absent codes have count 0 and sort (count
    asc, code asc) before every present one with mass contribution 0, so
    mass over present codes alone equals the dense cumulative_mass at
    those codes — exactly (zero terms add nothing to the int sums).

    Returns (pm int64 per entry, (v_vals, n_codes) sparse value
    histogram, total int).  Feed pm slices + the histogram to
    chain_ranks_from_mass for reference-exact f64 ranks without any 4^k
    table — the k >= 16 (wide-code) replay path; reference anchor:
    rank_kmers_w, src/kmer_spans.c:189-202.
    """
    ucounts = np.asarray(ucounts, dtype=np.int64)
    order = np.argsort(ucounts, kind="stable")  # codes asc within ties
    pm = np.empty(ucounts.shape[0], np.int64)
    pm[order] = np.concatenate([[0], np.cumsum(ucounts[order])[:-1]])
    v_vals, n_codes = np.unique(ucounts, return_counts=True)
    return pm, (v_vals, n_codes), int(ucounts.sum())


class SparseRanks:
    """Reference-exact f64 rank lookup over a sparse spectrum.

    ``ranks[code]`` returns the k-mer's weighted rank (the f64 chain
    value of rank_kmers_w) via binary search over the distinct codes —
    the oracle-side weights object for wide k, where a dense 4^k table
    cannot exist.  Only PRESENT codes may be queried (a scored genome
    position's k-mer was, by construction, counted).
    """

    sparse_lookup = True  # oracle.find_regions skips np.asarray on this

    def __init__(self, ucodes, ucounts):
        self.ucodes = np.asarray(ucodes, dtype=np.int64)
        pm, vhist, total = sparse_mass(self.ucodes, ucounts)
        self.total = total
        self.ranks_u = _chain_fold(pm, *_value_groups(vhist), total)

    def __getitem__(self, code):
        i = int(np.searchsorted(self.ucodes, code))
        if i >= self.ucodes.shape[0] or self.ucodes[i] != code:
            raise KeyError(f"code {code} not in spectrum")
        return self.ranks_u[i]

    def lookup(self, codes: np.ndarray) -> np.ndarray:
        """Vectorized rank gather for an array of PRESENT codes.

        Absence is impossible by construction (every scored position's
        k-mer was counted); if an upstream halo/reconstruction bug ever
        queries a missing code, fail LOUDLY rather than silently return
        a neighbor's rank (the never-silently-dropped invariant).
        """
        codes = np.asarray(codes, np.int64)
        idx = np.searchsorted(self.ucodes, codes)
        idx = np.minimum(idx, max(len(self.ucodes) - 1, 0))
        if self.ucodes.size == 0 or not np.array_equal(
                self.ucodes[idx], codes):
            missing = codes[self.ucodes[idx] != codes] if \
                self.ucodes.size else codes
            raise KeyError(
                f"codes not in spectrum (first: {missing.ravel()[:4]})")
        return self.ranks_u[idx]
