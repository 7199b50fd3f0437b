"""Deterministic test-genome generators: the port's own copy of
``kmer_spans_tpu/utils/testgen.py``, array-equal to it.

``golden_genome`` is SURVEY.md Appendix B's golden conformance input: a
100 kb pseudo-random ACGT sequence (a PCG-style LCG, no RNG library) with
three planted repeat islands.  ``realistic_genome`` is a seeded synthetic
chromosome with human-like composition and repeat structure (numpy's
``default_rng``).  ``spectrum_checksum`` folds a spectrum into one
integer.
"""

from __future__ import annotations

import numpy as np

_LCG_MUL = np.uint64(6364136223846793005)
_LCG_ADD = np.uint64(1442695040888963407)


def lcg_bases(n: int, seed: int = 42) -> str:
    """n pseudo-random bases from the PCG-style LCG of the golden genome."""
    state = np.uint64(seed)
    out = np.empty(n, dtype=np.uint8)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    with np.errstate(over="ignore"):
        for i in range(n):
            state = state * _LCG_MUL + _LCG_ADD
            out[i] = letters[int((state >> np.uint64(33)) & np.uint64(3))]
    return out.tobytes().decode("ascii")


def golden_genome(n: int = 100_000, seed: int = 42) -> str:
    """The Appendix-B golden genome: LCG bases + planted repeat islands."""
    seq = list(lcg_bases(n, seed))
    islands = [
        (20000, "AG" * 300),   # [20000, 20600)
        (50000, "CAG" * 300),  # [50000, 50900)
        (80000, "T" * 400),    # [80000, 80400)
    ]
    for start, rep in islands:
        seq[start : start + len(rep)] = rep
    return "".join(seq)


def spectrum_checksum(counts: np.ndarray) -> int:
    """cks = cks * 1000003 + count_i over index order, uint64 wraparound."""
    cks = np.uint64(0)
    mul = np.uint64(1000003)
    with np.errstate(over="ignore"):
        for c in np.asarray(counts, dtype=np.uint64):
            cks = cks * mul + c
    return int(cks)


#: human-like mononucleotide frequencies (GC ~ 41%)
_REAL_MONO = np.array([0.295, 0.205, 0.295, 0.205])  # A, C, T, G
#: CpG observed/expected depletion in mammalian genomes (~0.2-0.25)
_CPG_DEPLETION = 0.22


def realistic_genome(n: int = 2_000_000, seed: int = 7) -> np.ndarray:
    """A realistic synthetic chromosome: the stand-in for the reference's
    real-assembly validation (test.R:104-106, :572-590).

    Composition is a 1st-order Markov chain with human-like GC content
    (41%) and CpG dinucleotide depletion (obs/exp ~ 0.22), overlaid with
    the repeat structure real callers hit: dispersed ~300 bp "Alu-like"
    elements at ~8% divergence, tandem microsatellites ((AC)n, (AT)n,
    (CAG)n), poly-A tails, and assembly N gaps.  Returns nbases uint8
    (N == 4).  Deterministic per seed.
    """
    rng = np.random.default_rng(seed)
    # 1st-order transition matrix: start from the product model, scale
    # the C->G odds by the depletion factor, renormalize rows
    mono = _REAL_MONO  # order A, C, T, G (2-bit code order)
    trans = np.tile(mono, (4, 1))
    trans[1, 3] *= _CPG_DEPLETION  # C followed by G
    trans /= trans.sum(axis=1, keepdims=True)
    # vectorized chain: per-position uniform draws walked through the
    # cumulative transition rows in chunks (python loop over chunks only)
    out = np.empty(n, np.uint8)
    cum = np.cumsum(trans, axis=1)
    u = rng.random(n)
    state = int(rng.integers(0, 4))
    chunk = 1 << 16
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        for i in range(s, e):  # simple chain; testgen-only cost
            state = int(np.searchsorted(cum[state], u[i], side="right"))
            out[i] = state
    # dispersed Alu-like family: one 300 bp consensus, ~8% divergence
    alu = rng.integers(0, 4, 300, dtype=np.uint8)
    for start in range(50_000, n - 400, 97_000):
        copy = alu.copy()
        div = rng.random(300) < 0.08
        copy[div] = rng.integers(0, 4, int(div.sum()), dtype=np.uint8)
        out[start:start + 300] = copy
        # poly-A tail
        out[start + 300:start + 300 + 12] = 0
    # tandem microsatellites
    for start, unit, reps in (
        (200_000, (0, 1), 150),        # (AC)n
        (700_000, (0, 2), 200),        # (AT)n
        (1_300_000, (1, 0, 3), 120),   # (CAG)n
    ):
        if start + len(unit) * reps < n:
            out[start:start + len(unit) * reps] = np.tile(
                np.array(unit, np.uint8), reps)
    # assembly N gaps
    for start in range(400_000, n - 2_000, 650_000):
        out[start:start + 1_500] = 4
    return out
