"""Scoring models: per-k-mer weight tables for the span scan.

The port's own copy of ``kmer_spans_tpu/models/scoring.py``.  Every model
reduces to one interface: a 4^k f64 weight table W and a scalar threshold
t; the per-position score is s_i = W[code_i] - t and the scan is
S_i = max(S_{i-1} + s_i, 0).  The README's three scoring variants plus
arbitrary caller weights all take this shape:

  * RankScoring       — W = weighted ranks, t = thr (the flagship
                        kmer.low.comp.regions pipeline, thr default 0.75);
                        the ranks come from spans/finish.py
                        host_rank_chain, oracle.weighted_ranks bit for bit
                        (served by the host library at 4^k >= 2^20)
  * WeightScoring     — W = arbitrary caller weights, t = 0
                        (kmer.regions; e.g. CpG: W[CG] > 0, rest -1)
  * ThresholdScoring  — W = +1 where freq >= f_t else -1, t = 0
  * Log2MedianScoring — W = log2(f / f_med), t = 0 (zero-count k-mers get
                        -inf, an infinite penalty that resets the scan)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..spans.finish import host_rank_chain
from ..stats.ranks import spectrum_median_freq


@dataclasses.dataclass
class ScoringModel:
    """A resolved scoring model: weight table + threshold."""

    weights: np.ndarray  # f64 [4^k]
    threshold: float

    def scores_for(self, codes: np.ndarray) -> np.ndarray:
        return self.weights[codes] - self.threshold


def RankScoring(counts: np.ndarray, total: float, thr: float = 0.75) -> ScoringModel:
    if not 0.0 < thr < 1.0:
        raise ValueError("the threshold must be between 0 and 1")
    return ScoringModel(weights=host_rank_chain(counts, total), threshold=thr)


def WeightScoring(weights: np.ndarray) -> ScoringModel:
    return ScoringModel(weights=np.asarray(weights, dtype=np.float64), threshold=0.0)


def ThresholdScoring(counts: np.ndarray, f_t: float) -> ScoringModel:
    counts = np.asarray(counts, dtype=np.int64)
    total = counts.sum()
    freq = counts / total if total else np.zeros_like(counts, dtype=np.float64)
    return ScoringModel(
        weights=np.where(freq >= f_t, 1.0, -1.0), threshold=0.0
    )


def Log2MedianScoring(counts: np.ndarray) -> ScoringModel:
    counts = np.asarray(counts, dtype=np.int64)
    total = counts.sum()
    f_med = spectrum_median_freq(counts)
    with np.errstate(divide="ignore"):
        w = np.log2((counts / total) / f_med) if f_med > 0 else np.full(
            counts.shape, -np.inf
        )
    return ScoringModel(weights=w, threshold=0.0)
