"""The sequential reference the port is held against: the port's own copy.

Copied from ``kmer_spans_tpu/oracle/reference.py`` (spectrum count, dense
and sparse, weighted ranks, span caller, transition-score caller, windowed
distributions), so that the port and chip_smoke.py import nothing of the
JAX package; ``golden_genome`` is re-exported from utils/testgen.py.
Straightforward sequential numpy/python code with the reference's exact
f64 rank chain and region recurrences, bit-identical to the C reference
(src/kmer_spans.c:135-155, :189-202, :243-307, :329-395, :413-449).  It is
the api's ``backend="host"`` and the yardstick of every device path; it
never runs on the card.

Coordinates: a region's (beg, end) are the 1-based positions of the last
base of its first positive-scoring and its first maximum-scoring k-mer.
"""

from __future__ import annotations

import numpy as np

from .encoding import MAX_K, pack
from .utils.testgen import golden_genome  # noqa: F401

__all__ = ["count_spectrum", "count_spectrum_sparse", "find_regions",
           "find_tr_regions", "golden_genome", "weighted_ranks",
           "windowed_distributions"]


def segments(valid: np.ndarray) -> list[tuple[int, int]]:
    """Maximal runs [a, b] (inclusive, 0-based) of valid (non-N) bases."""
    n = valid.shape[0]
    if n == 0:
        return []
    v = valid.astype(np.int8)
    d = np.diff(v)
    starts = list(np.nonzero(d == 1)[0] + 1)
    ends = list(np.nonzero(d == -1)[0])
    if v[0]:
        starts.insert(0, 0)
    if v[-1]:
        ends.append(n - 1)
    return list(zip(starts, ends))


def count_spectrum(seq, k: int, counts: np.ndarray | None = None):
    """Count all k-mers of one sequence into a dense 4^k spectrum.

    Every complete k-mer inside each N-free segment is counted (n-k+1 per
    segment of length n >= k).  Returns (counts, n_words).  ``counts`` may be
    passed in to accumulate across sequences.
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}]")
    p = pack(seq)
    size = 1 << (2 * k)
    if counts is None:
        counts = np.zeros(size, dtype=np.int64)
    n_words = 0
    # one bincount per sequence over all its segments' codes (addition is
    # commutative over segments, so this is outcome-identical)
    parts = []
    for a, b in segments(p.valid):
        seg_len = b - a + 1
        if seg_len < k:
            continue
        codes = _segment_codes(p.bases, a, b, k)
        parts.append(codes)
        n_words += codes.shape[0]
    if parts:
        allc = parts[0] if len(parts) == 1 else np.concatenate(parts)
        counts += np.bincount(allc, minlength=size).astype(counts.dtype)
    return counts, n_words


def count_spectrum_sparse(seq, k: int):
    """SPARSE spectrum: distinct codes + counts (the wide-k form).

    For k >= 16 a dense 4^k array cannot exist (68 GB at k=17), but a
    genome's spectrum has at most n distinct entries.  Codes are int64
    (2k <= 62 bits); counting semantics are identical to count_spectrum
    (reference sequence_kmer_count, src/kmer_spans.c:135-155 — which
    is capped at its MAX_K; this extends the same contract past it).
    Returns (ucodes int64 ascending, ucounts int64, n_words).
    """
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    p = pack(seq)
    parts = []
    n_words = 0
    for a, b in segments(p.valid):
        if b - a + 1 < k:
            continue
        codes = _segment_codes(p.bases, a, b, k)
        parts.append(codes)
        n_words += codes.shape[0]
    allc = (np.concatenate(parts) if parts
            else np.zeros(0, np.int64))
    ucodes, ucounts = np.unique(allc, return_counts=True)
    return ucodes, ucounts.astype(np.int64), n_words


def _segment_codes(bases: np.ndarray, a: int, b: int, k: int) -> np.ndarray:
    """Codes of all k-mers in segment [a, b], ordered by end position."""
    seg = bases[a : b + 1].astype(np.int64)
    n = seg.shape[0]
    codes = np.zeros(n - k + 1, dtype=np.int64)
    for j in range(k):
        codes = codes | (seg[j : j + n - k + 1] << (2 * (k - 1 - j)))
    return codes


def weighted_ranks(counts: np.ndarray, total: float) -> np.ndarray:
    """rank[kmer] = fraction of counted k-mer mass strictly before it when the
    spectrum is sorted by (count asc, kmer index asc).

    Tied counts get different ranks, ordered by k-mer index (the
    reference's stable sort).  Accumulation is the sequential chain
    ``r += counts[prev]/total`` in f64, which np.cumsum reproduces exactly
    (left-to-right accumulation).
    """
    counts = np.asarray(counts)
    if total == 0:
        # no k-mers counted: every rank is 0 (the degenerate case defined
        # instead of propagating NaNs)
        return np.zeros(counts.shape[0], dtype=np.float64)
    order = np.argsort(counts, kind="stable")
    terms = counts[order[:-1]].astype(np.float64) / np.float64(total)
    ranks_sorted = np.empty(counts.shape[0], dtype=np.float64)
    ranks_sorted[0] = 0.0
    np.cumsum(terms, out=ranks_sorted[1:])
    ranks = np.empty_like(ranks_sorted)
    ranks[order] = ranks_sorted
    return ranks


def find_regions(
    seq,
    seq_id: int,
    min_width: int,
    min_score: float,
    weights: np.ndarray,
    k: int,
    threshold: float = 0.0,
    scan_counts: np.ndarray | None = None,
):
    """Sequential span caller: S_i = max(S_{i-1} + (weights[code_i] - threshold), 0).

      * scoring positions are k-mer END positions; within an N-free segment
        [a, b], k-mers end at a+k-1 .. b but only a+k-1 .. b-1 are scored
        (the final k-mer of each segment is formed but never scored);
      * a region candidate runs from the first positive-scoring position to
        the FIRST position attaining the running maximum (strict '>' update);
      * when S returns to 0 (or the segment ends with S > 0): emit if
        (max_pos - beg >= min_width) and (max_score >= min_score); after an
        emit, scoring restarts at position max_pos + 1 with S = 0 (the
        reference's jump-back rescan); a failing candidate emits nothing;
      * if scan_counts is given, every scored position increments
        scan_counts[code]; rescanned positions count again.

    Returns a list of (seq_id, beg, end, score).
    """
    p = pack(seq)
    mask = (1 << (2 * k)) - 1
    regions: list[tuple[int, int, int, float]] = []
    # a sparse lookup object (SparseRanks-like) stays as it is
    if not getattr(weights, "sparse_lookup", False):
        weights = np.asarray(weights, dtype=np.float64)

    for a, b in segments(p.valid):
        if b - a + 1 < k:
            continue
        codes = _segment_codes(p.bases, a, b, k)  # codes[j] ends at a+k-1+j
        # scored end positions: a+k-1 .. b-1  -> codes[0 .. len-2]
        end0 = a + k - 1  # 0-based end position of first k-mer
        n_scored = codes.shape[0] - 1
        if n_scored <= 0:
            continue
        start = 0  # index into codes of next position to score
        while start < n_scored:
            emitted_jump = _scan_segment_once(
                codes, start, n_scored, end0, seq_id, min_width, min_score,
                weights, mask, threshold, regions, scan_counts,
            )
            if emitted_jump is None:
                break
            start = emitted_jump
    return regions


def _scan_segment_once(
    codes, start, n_scored, end0, seq_id, min_width, min_score,
    weights, mask, threshold, regions, scan_counts,
):
    """One pass from ``start``; returns restart index after an emit, else None.

    Mirrors the reference inner loop: score, clamp, track first-argmax,
    emit-and-jump on zero-crossing or at scan end.
    """
    score = 0.0
    last_score = 0.0
    max_score = 0.0
    reg_beg = 0
    max_pos = 0
    j = start
    while j < n_scored:
        code = int(codes[j]) & mask
        if scan_counts is not None:
            scan_counts[code] += 1
        s = weights[code] - threshold
        score = last_score + s
        if score < 0.0:
            score = 0.0
        pos1 = end0 + j + 1  # 1-based last-base position of this k-mer
        if last_score == 0.0 and score > 0.0:
            reg_beg = pos1
            max_pos = pos1
            max_score = score
        if score == 0.0 and last_score > 0.0:
            if max_pos - reg_beg >= min_width and max_score >= min_score:
                regions.append((seq_id, reg_beg, max_pos, max_score))
                # jump-back: resume scoring at position max_pos + 1
                return (max_pos + 1) - (end0 + 1)
            max_score = 0.0
            max_pos = pos1
        if score > max_score:
            max_score = score
            max_pos = pos1
        last_score = score
        j += 1
    # terminal (segment end) emission
    if score > 0.0:
        if max_pos - reg_beg >= min_width and max_score >= min_score:
            regions.append((seq_id, reg_beg, max_pos, max_score))
            return (max_pos + 1) - (end0 + 1)
    return None


# ---------------------------------------------------------------------------
# Transition-score caller  (reference find_kmer_tr_lr_regions, :329-395; A.6)
# ---------------------------------------------------------------------------

def find_tr_regions(
    seq,
    seq_id: int,
    k: int,
    kmer_scores: np.ndarray,
    trans_scores: np.ndarray,
    min_region_length: int,
):
    """Sequential transition-score caller.

    Differences from find_regions (SURVEY A.6), all reproduced:
      * the first k-mer of each block seeds ``score = kmer_scores[code]``
        clamped to >= 0; extensions add ``trans_scores[code]``;
      * the running max is updated BEFORE the 0-clamp;
      * emission gate is min length only (no min_score);
      * EVERY zero-crossing from positive jumps back to the max position and
        rescans (not only emitting ones);
      * QUIRK: if the block's seed k-mer scores positive, reg_begin is
        recorded one position late (the reference records i = one past the
        seed's last base), so a region starting at the seed reports
        beg = seed_last_base + 2 in 1-based terms;
      * QUIRK: the reference breaks out of the whole sequence when the seed
        k-mer is followed by fewer than 2 remaining bytes (:341).
      * the final k-mer of a segment IS scored here (unlike find_regions).

    Returns list of (seq_id, beg, end, score), 1-based last-base coordinates.
    """
    p = pack(seq)
    kmer_scores = np.asarray(kmer_scores, dtype=np.float64)
    trans_scores = np.asarray(trans_scores, dtype=np.float64)
    regions: list[tuple[int, int, int, float]] = []
    n = p.n

    for a, b in segments(p.valid):
        if b - a + 1 < k:
            continue
        codes = _segment_codes(p.bases, a, b, k)
        end0 = a + k - 1
        # QUIRK (:341): after init, reference breaks the whole-sequence loop
        # if seq[i] or seq[i+1] is the terminator, where i = end0+1 (one past
        # the seed k-mer): blocks whose seed lands within 2 bytes of the end
        # of the sequence are abandoned without scoring or terminal emission.
        if end0 >= n - 2:
            break
        # seed
        seed_score = float(kmer_scores[int(codes[0])])
        score = seed_score if seed_score > 0.0 else 0.0
        last_score = score
        max_score = 0.0
        max_score_pos0 = 0  # 0-based position as the reference tracks (loop i)
        reg_begin0 = 0
        if score > 0.0:
            max_score = score
            max_score_pos0 = end0 + 1  # QUIRK: one past the seed's last base
            reg_begin0 = end0 + 1
        # extensions: k-mers ending at end0+1 .. b  -> codes[1..]
        j = 1
        n_codes = codes.shape[0]
        while j < n_codes:
            pos0 = end0 + j  # 0-based last base of this k-mer == reference i
            score = last_score + float(trans_scores[int(codes[j])])
            if score > max_score:
                max_score = score
                max_score_pos0 = pos0
            if score < 0.0:
                score = 0.0
            if last_score == 0.0 and score > 0.0:
                max_score = score
                max_score_pos0 = pos0
                reg_begin0 = pos0
            if score == 0.0 and last_score > 0.0:
                if max_score_pos0 - reg_begin0 >= min_region_length:
                    regions.append(
                        (seq_id, 1 + reg_begin0, 1 + max_score_pos0, max_score)
                    )
                # unconditional jump-back to the max position; rescan resumes
                # scoring at max_score_pos0 + 1 with S = 0.
                jump0 = max_score_pos0
                score = last_score = max_score = 0.0
                reg_begin0 = jump0
                max_score_pos0 = 0
                j = (jump0 + 1) - end0  # next iteration scores pos0 = jump0+1
                last_score = 0.0
                continue
            last_score = score
            j += 1
        # terminal region, reference :392-393
        if max_score > 0.0 and max_score_pos0 - reg_begin0 >= min_region_length:
            regions.append((seq_id, 1 + reg_begin0, 1 + max_score_pos0, max_score))
    return regions


# ---------------------------------------------------------------------------
# Windowed k-mer count distributions  (reference :413-449)
# ---------------------------------------------------------------------------

def windowed_distributions(
    seq,
    tracked_codes: np.ndarray,
    k: int,
    window: int,
    dist: np.ndarray | None = None,
    counts_pos: np.ndarray | None = None,
):
    """Occurrence-count distributions of tracked k-mers over sliding windows.

    For every window of ``window`` bases fully inside an N-free segment, the
    occurrence count of each tracked k-mer (k-mers fully inside the window,
    i.e. window-k+1 slots) is histogrammed into ``dist[count, i]``
    (shape (window+1, n_tracked)).  If ``counts_pos`` (shape (n, n_tracked))
    is given, the count is also recorded at the window's 0-based start
    position (reference kmer_counts_pos, :441-442).

    Windows slide by 1 within a segment and never span N gaps.
    """
    p = pack(seq)
    tracked_codes = np.asarray(tracked_codes, dtype=np.int64)
    n_tracked = tracked_codes.shape[0]
    if dist is None:
        dist = np.zeros((window + 1, n_tracked), dtype=np.int64)
    for a, b in segments(p.valid):
        seg_len = b - a + 1
        if seg_len < window:
            continue
        codes = _segment_codes(p.bases, a, b, k)  # start positions a .. b-k+1
        # occ[i, j] = 1 if k-mer starting at a+j equals tracked i
        n_windows = seg_len - window + 1
        slots = window - k + 1  # k-mer start slots per window
        for i in range(n_tracked):
            occ = (codes == tracked_codes[i]).astype(np.int64)
            cs = np.concatenate([[0], np.cumsum(occ)])
            # window starting at a+t covers k-mer starts t .. t+slots-1
            wc = cs[slots : slots + n_windows] - cs[0:n_windows]
            dist[:, i] += np.bincount(wc, minlength=window + 1)
            if counts_pos is not None:
                counts_pos[a : a + n_windows, i] = wc
    return dist
