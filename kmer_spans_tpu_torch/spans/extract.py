"""Exact span extraction from per-position scores (host, f64).

The port's own copy of ``kmer_spans_tpu/spans/extract.py``, which also
takes -inf scores (a reset to 0, as in the sequential reference; the
reference's screen turns NaN after one).  It implements
the excursion recursion of SURVEY.md A.4: the reference's jump-back rescan
is, per positive excursion of the score trace,

    split at the FIRST argmax m; emit the prefix (first-positive .. m) if it
    passes (min_width, min_score); rescan the suffix from m+1 with S = 0;
    a failing candidate emits nothing from its whole excursion.

Two layers:

  * SCREENING (vectorized): per segment, the unclamped prefix sum P and its
    running min M give S_screen = P - M, the max-plus scan up to f64
    rounding; positive runs whose max could reach min_score and whose
    length could reach min_width are candidates.  Everything else provably
    emits nothing and is skipped in O(1).
  * REPLAY (sequential f64): candidates are replayed with
    ``np.add.accumulate``, strictly left to right (the reference's exact
    summation order), so emitted positions and scores are bit-identical to
    the C loop.  The replay finds the true excursion boundaries even where
    screening rounding merged or split runs.
"""

from __future__ import annotations

import numpy as np

_CHUNK = 4096
#: absolute slack on the screened excursion max vs min_score; the screen's
#: f64 rounding error is ~eps * |P|_max ≈ 2e-7 even for a 3 Gb genome at
#: |s| ~ 0.25, two orders below this margin (extra candidates only cost a
#: replay; the replay decides exactly)
_SCORE_MARGIN = 1e-4


def _first_nonpositive(s: np.ndarray, u: int):
    """Sequential S replay from u: exact left-to-right f64 partial sums.

    Returns (S_vals, z): S_vals[i] is S at index u+i; z is the absolute
    index of the first position with S <= 0, or None if the array ends with
    S > 0 throughout (S_vals then covers u..n-1).
    """
    n = s.shape[0]
    parts: list[np.ndarray] = []
    carry = 0.0
    lo = u
    while lo < n:
        hi = min(lo + _CHUNK, n)
        # seed the chunk with the carry as element 0: np.add.accumulate is
        # strictly sequential, so rounding order matches the reference's
        block = np.empty(hi - lo + 1, dtype=np.float64)
        block[0] = carry
        block[1:] = s[lo:hi]
        acc = np.add.accumulate(block)[1:]
        parts.append(acc)
        nonpos = acc <= 0.0
        if nonpos.any():
            z = lo + int(np.argmax(nonpos))
            full = parts[0] if len(parts) == 1 else np.concatenate(parts)
            return full[: z - u + 1], z
        carry = float(acc[-1])
        lo = hi
    return (parts[0] if len(parts) == 1 else np.concatenate(parts)), None


def _screen_candidates(s: np.ndarray, min_width: int, min_score: float):
    """Vectorized candidate runs: list of (start, end) worth exact replay.

    A -inf score (which resets S to 0) screens as a finite value below
    minus the sum of every finite |s| here: it resets P - M the same way,
    where -inf itself would leave P - M undefined from there on.
    """
    n = s.shape[0]
    neg_inf = np.isneginf(s)
    if neg_inf.any():
        reset = -(np.abs(s[~neg_inf]).sum() + 1.0)
        s = np.where(neg_inf, reset, s)
    P = np.cumsum(s)
    M = np.minimum.accumulate(np.minimum(P, 0.0))
    S = P - M
    pos = S > 0.0
    if not pos.any():
        return []
    d = np.diff(pos.astype(np.int8))
    starts = np.nonzero(d == 1)[0] + 1
    ends = np.nonzero(d == -1)[0]
    if pos[0]:
        starts = np.concatenate([[0], starts])
    if pos[-1]:
        ends = np.concatenate([ends, [n - 1]])
    if starts.shape[0] == 0:
        return []
    runmax = np.maximum.reduceat(S, starts)
    width_ok = (ends - starts + 1) >= min_width  # m-u <= runlen-1, +1 slack
    score_ok = runmax >= (min_score - _SCORE_MARGIN)
    keep = width_ok & score_ok
    return list(zip(starts[keep].tolist(), ends[keep].tolist()))


def extract_segment_spans(
    s: np.ndarray,
    pos_offset: int,
    min_width: int,
    min_score: float,
    visits: np.ndarray | None = None,
):
    """Extract spans from one N-free segment's scored positions.

    s          : f64 scores at the segment's scored positions (index j scores
                 the k-mer whose 1-based last base is pos_offset + j).
    pos_offset : 1-based last-base position of scored index 0.
    visits     : optional int64 difference array (len(s)+1): +1 everywhere
                 (base pass) plus +1 over each emission's rescanned range.

    Returns list of (beg, end, score) in the reference's 1-based last-base
    coordinates.
    """
    n = s.shape[0]
    regions: list[tuple[int, int, float]] = []
    if n == 0:
        return regions
    if visits is not None:
        visits[0] += 1
        visits[n] -= 1
    # Work stack: "range" items are screened vectorized into candidate
    # runs; "run" items get the exact sequential replay.  LIFO order with
    # runs pushed reversed keeps everything position-ordered, so a single
    # frontier replicates the reference's scan cursor: after an emission
    # the suffix [m+1, run_end] is re-screened as a fresh range; after a
    # failing candidate the whole excursion emits nothing and the frontier
    # jumps past it.
    stack: list[tuple[int, int, bool]] = [(0, n - 1, True)]
    frontier = 0
    while stack:
        a, b, needs_screen = stack.pop()
        a = max(a, frontier)
        if a > b:
            continue
        if needs_screen:
            runs = _screen_candidates(s[a : b + 1], min_width, min_score)
            for ra, rb in reversed(runs):
                stack.append((a + ra, a + rb, False))
            continue
        rel = s[a : b + 1] > 0.0
        if not rel.any():
            continue
        u = a + int(np.argmax(rel))
        S_vals, z = _first_nonpositive(s, u)
        top = (z - 1) if z is not None else (n - 1)
        m_rel = int(np.argmax(S_vals[: top - u + 1]))  # first argmax
        m = u + m_rel
        max_score = float(S_vals[m_rel])
        if (m - u) >= min_width and max_score >= min_score:
            regions.append((pos_offset + u, pos_offset + m, max_score))
            z_e = z if z is not None else n - 1
            if visits is not None and m + 1 <= z_e:
                visits[m + 1] += 1
                visits[z_e + 1] -= 1
            frontier = m + 1
            stack.append((m + 1, b, True))
        else:
            frontier = (z + 1) if z is not None else n
    return regions


def extract_spans(
    s: np.ndarray,
    scored: np.ndarray,
    min_width: int,
    min_score: float,
    seq_id: int = 0,
    visits_full: np.ndarray | None = None,
):
    """Extract spans over a whole sequence given per-position scores + mask.

    s, scored are full-length (one entry per base, end-position convention);
    runs of ``scored`` are independent scan stretches (the reference's
    N-free segments minus warm-up and segment tails).

    visits_full: optional int64 array (len + 1) difference array over BASE
    positions accumulating scan multiplicity (for scan-count parity).
    """
    s = np.asarray(s, dtype=np.float64)
    scored = np.asarray(scored, bool)
    n = scored.shape[0]
    regions: list[tuple[int, int, int, float]] = []
    d = np.diff(scored.astype(np.int8))
    starts = list(np.nonzero(d == 1)[0] + 1)
    ends = list(np.nonzero(d == -1)[0])
    if n and scored[0]:
        starts.insert(0, 0)
    if n and scored[-1]:
        ends.append(n - 1)
    for a, b in zip(starts, ends):
        visits = None
        if visits_full is not None:
            visits = np.zeros(b - a + 2, dtype=np.int64)
        segs = extract_segment_spans(
            s[a : b + 1], a + 1, min_width, min_score, visits=visits
        )
        regions.extend((seq_id, beg, end, sc) for beg, end, sc in segs)
        if visits_full is not None:
            visits_full[a : b + 2] += visits
    return regions
