"""Exact span extraction from per-position scores (host, f64).

The port's counterpart of ``kmer_spans_tpu/spans/extract.py``, which also
takes -inf scores (a reset to 0, as in the sequential reference; the
reference's screen turns NaN after one) and, on the numpy path, confirms
its screen's zeros with the sequential fold (the reference trusts them,
and on scores that tie moves or drops regions).  It implements the
excursion recursion of SURVEY.md A.4: the reference's jump-back rescan
is, per positive excursion of the score trace,

    split at the FIRST argmax m; emit the prefix (first-positive .. m) if it
    passes (min_width, min_score); rescan the suffix from m+1 with S = 0;
    a failing candidate emits nothing from its whole excursion.

``extract_spans`` folds with the host library wherever it loads:

  * FOLD (sequential f64, C): ``utils/native.replay_scores``, the
    reference's loop itself (``ks_replay_scores``), over every scored run
    of the stretch in one call: the same additions in the same order, the
    same first argmax and rescans, with the scan counts and the candidate
    count as optional outputs: bit-identical to the layers below by
    construction, in one pass over the positions.

Where the library does not load (no C++ compiler), three numpy layers,
``extract_segment_spans`` a scored run, give the same answer:

  * SCREENING (vectorized): per range, the unclamped prefix sum P and its
    running min M give S_screen = P - M, the max-plus scan up to f64
    rounding.  Its zeros are only proposals: a difference of prefixes can
    round to 0 where the reference's fold S_i = max(S_{i-1} + s_i, 0)
    stays just above 0 (one excursion screened as two), or stay just above
    0 where the fold reaches it (two screened as one).
  * CONFIRMATION (vectorized): the stretches between proposed zeros are
    summed strictly left to right from 0, all at once (``_segment_sums``).
    A stretch whose sums first reach <= 0 at its end confirms that zero
    (given its own start); where one does not, the fold is walked with
    ``_first_nonpositive`` from that stretch's start (a true zero) to the
    next proposed zero it reaches.  The result is the fold's own
    excursions, each with its exact length and whether its S reaches
    min_score: an excursion shorter than min_width + 1 or below min_score
    emits nothing and is skipped.
  * REPLAY (sequential f64): candidates are replayed with
    ``np.add.accumulate``, strictly left to right (the reference's exact
    summation order), so emitted positions and scores are bit-identical to
    the C loop.  An emission's rescan [m+1, z] is a fresh range: the
    rescan's fold starts at 0 <= S_m, stays at or below the first pass's
    (f64 addition is monotone) and so closes by the first pass's zero z.

Spans (utils/metrics.py): ``extract.fold`` the library's fold of a
stretch; on the numpy path ``extract.screen`` the screen and the
stretches' sums of each range, ``extract.confirm`` its walks,
``extract.replay`` each candidate's replay.  The counters below count
whether the recorder is on or off.
"""

from __future__ import annotations

import numpy as np

from ..utils import metrics, native

#: ranges handed to ``_candidates`` (numpy path): each segment's first
#: pass and each emission's rescan
replay_ranges = 0
#: the confirmation's sequential walks (numpy path: ``_first_nonpositive``
#: calls from a stretch the screen's sums did not confirm)
confirm_walks = 0
#: candidate excursions replayed, and those of them that emitted a region
#: (both paths: the library's fold counts the same excursions)
replays = 0
replay_emits = 0
#: ``extract_spans`` calls the host library folded
native_folds = 0

_CHUNK = 4096
#: the first chunk of a replay, doubled up to _CHUNK: most excursions
#: (and the walks of ``_candidates``) close within it
_FIRST_CHUNK = 64
#: elements of one block of stretches summed at once (``_segment_sums``)
_BLOCK_ELEMS = 1 << 20


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
    step = _FIRST_CHUNK
    while lo < n:
        hi = min(lo + step, n)
        step = min(2 * step, _CHUNK)
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


def _segment_sums(w: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                  reach: float | None = None):
    """Strictly sequential f64 sums of ``w`` over the stretches
    [starts[i], starts[i] + lens[i]), each from 0.

    ``starts`` is sorted.  Returns (first, reached): first[i] is the
    offset of the stretch's first sum <= 0 (lens[i] when there is none);
    reached[i] whether a sum before that is >= ``reach`` (all False when
    it is None).
    ``np.add.accumulate`` adds left to right along a row, so each
    stretch's sums are the fold's own.  The stretches go in rows of one
    block (of one power-of-four width each where one block would waste
    too much), one accumulate a block, every row closed by a -inf just
    past its stretch: its first sum <= 0 is then always in the row.
    """
    first = lens.copy()
    reached = np.zeros(lens.shape[0], bool)
    if not lens.size:
        return first, reached
    w = np.ascontiguousarray(w)
    longest = int(lens.max())
    wp = w if starts[-1] + longest < w.shape[0] else \
        np.concatenate((w, np.zeros(longest + 1)))
    # row j of rows_of is wp[j : j + longest + 1], a view
    rows_of = np.ndarray((wp.shape[0] - longest, longest + 1), wp.dtype, wp,
                         0, (wp.itemsize, wp.itemsize))
    if lens.shape[0] * longest <= _BLOCK_ELEMS // 16:
        blocks = [(slice(None), longest)]
    else:  # by the power of four at or above each length
        bucket = (np.frexp(np.maximum(lens, 1) - 1)[1] + 1) // 2
        blocks = []
        for e in np.flatnonzero(np.bincount(bucket)).tolist():
            sel = np.flatnonzero(bucket == e)
            step = max(_BLOCK_ELEMS >> 2 * e, 1)
            blocks += [(sel[i:i + step], min(1 << 2 * e, longest))
                       for i in range(0, sel.size, step)]
    for r, width in blocks:
        ln = lens[r]
        ri = np.arange(ln.shape[0])
        g = rows_of[starts[r], : width + 1]
        g[ri, ln] = -np.inf
        acc = np.add.accumulate(g, axis=1, out=g)
        f = (acc <= 0).argmax(axis=1)
        first[r] = f
        if reach is not None:
            hit = acc >= reach
            h = hit.argmax(axis=1)
            reached[r] = hit[ri, h] & (h < f)
    return first, reached


def _segment_check(w: np.ndarray, lo: int, ends: np.ndarray):
    """Strictly sequential f64 sums of ``w`` from ``lo``, restarted at 0
    after each of ``ends`` (sorted, the first >= lo): the first segment
    whose sums do not stay above 0 before its end and reach <= 0 at it.

    Returns (i, j): i is that segment's index into ``ends`` (len(ends)
    when there is none); j is where its sums first reach <= 0, None when
    they stay above 0 through its end (``_segment_sums``).
    """
    starts = np.concatenate(([lo], ends[:-1] + 1))
    lens = ends - starts + 1
    first, _ = _segment_sums(w, starts, lens)
    bad = np.nonzero(first != lens - 1)[0]
    if not bad.size:
        return ends.size, None
    i = int(bad[0])
    return i, (int(starts[i] + first[i]) if first[i] < lens[i] else None)


def _screen_zeros(s: np.ndarray) -> np.ndarray:
    """The vectorized screen's zeros (a mask): where P - M, the max-plus
    scan up to f64 rounding, is 0.

    A -inf score (which resets S to 0) screens as a finite value below
    minus the sum of every finite |s| here: it resets P - M the same way,
    where -inf itself would leave P - M undefined from there on.
    """
    if s.min() == -np.inf:
        neg_inf = np.isneginf(s)
        reset = -(np.abs(s[~neg_inf]).sum() + 1.0)
        s = np.where(neg_inf, reset, s)
    P = np.cumsum(s)
    return P <= np.minimum.accumulate(np.minimum(P, 0.0))


def _candidates(s: np.ndarray, min_width: int, min_score: float) -> list:
    """The starts u of the fold's excursions over ``s`` (entered with
    S = 0) that could emit: S > 0 on u..z-1, z the fold's first zero after
    u (len(s) when none), with z - 1 - u >= min_width and max S >=
    min_score.

    The screen's zeros cut ``s`` into stretches: a zero after a zero is
    one alone (the fold, at 0 before it, is 0 there when its score is
    <= 0); a run of positive screened S ends with the zero that closes it
    (``_segment_sums`` sums them all at once).  A stretch that does not
    hold (the fold reaches 0 before its end, or not at it) is walked with
    the fold's own sums (``_first_nonpositive``) from its start, a true
    zero when every stretch before it holds, until the fold reaches 0 on
    a screened zero: the stretches after that hold as screened.
    """
    global confirm_walks
    n = s.shape[0]
    if n <= min_width:  # no excursion here is long enough
        return []
    sp = metrics.begin("extract.screen") if metrics.enabled else None
    zero = _screen_zeros(s)
    # where the screen turns positive and back: the runs' starts and
    # closing zeros, by turns
    edges = np.flatnonzero(zero[1:] != zero[:-1]) + 1
    if zero[0]:
        run_start, run_end = edges[0::2], edges[1::2]
    else:
        run_start, run_end = np.append(0, edges[1::2]), edges[0::2]
    if run_end.shape[0] < run_start.shape[0]:  # the last run is open
        run_end = np.append(run_end, n - 1)
    lens = run_end - run_start + 1
    first, _ = _segment_sums(s, run_start, lens)
    keep = first == lens - 1  # the runs that hold
    if lens.size and run_start[-1] + first[-1] == n:
        keep[-1] = True  # S stays > 0 to the end
    # a zero after a zero holds where its score is <= 0
    lone = np.flatnonzero(zero & (s > 0))
    walk = run_start[~keep]
    if lone.size:
        walk = np.union1d(lone[(lone == 0) | zero[lone - 1]], walk)
    if sp is not None:
        metrics.end(sp)
        sp = metrics.begin("extract.confirm") if walk.size else None
    walked_u, lo, hi = [], [], []
    walked = -1  # the walks have fixed the fold up to here
    walks = 0
    for u in walk.tolist():
        if u <= walked:
            continue
        lo.append(u)
        while True:
            walks += 1
            S_vals, zw = _first_nonpositive(s, u)
            zz = n if zw is None else zw
            if zz - 1 - u >= min_width and zz > u and \
                    (S_vals[: zz - u] >= min_score).any():
                walked_u.append(u)
            if zw is None or zw == n - 1 or zero[zw]:
                walked = zz  # the stretches after zw hold
                break
            u = zw + 1
        hi.append(walked)
    confirm_walks += walks
    if lo:  # the runs a walk passed over are its own
        c = np.searchsorted(np.asarray(lo), run_start, side="right") - 1
        keep &= (c < 0) | (run_start > np.asarray(hi)[c])
    if sp is not None:
        metrics.end(sp)
    # the runs long enough to emit: does S reach the bar before the zero?
    wide = np.flatnonzero(keep & (first >= max(min_width + 1, 1)))
    if wide.size:
        sp = metrics.begin("extract.screen") if metrics.enabled else None
        _, reached = _segment_sums(s, run_start[wide], first[wide],
                                   reach=min_score)
        wide = wide[reached]
        if sp is not None:
            metrics.end(sp)
    return sorted(run_start[wide].tolist() + walked_u)


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
    global replay_ranges, replays, replay_emits
    n = s.shape[0]
    regions: list[tuple[int, int, float]] = []
    if n == 0:
        return regions
    if visits is not None:
        visits[0] += 1
        visits[n] -= 1
    # Work stack: a (a, b) range, entered with S = 0 at a - 1, is turned
    # into its candidate excursions; an excursion start u gets the exact
    # sequential replay.  LIFO order with candidates pushed reversed keeps
    # everything position-ordered: an emission's rescan [m+1, z] lies
    # inside its excursion, before the next candidate.
    stack: list = [(0, n - 1)]
    ranges = tried = 0
    while stack:
        item = stack.pop()
        if isinstance(item, tuple):
            ranges += 1
            a, b = item
            for u in reversed(_candidates(s[a: b + 1], min_width,
                                          min_score)):
                stack.append(a + u)
            continue
        tried += 1
        sp = metrics.begin("extract.replay") if metrics.enabled else None
        u = item
        S_vals, z = _first_nonpositive(s, u)
        top = (z - 1) if z is not None else (n - 1)
        m_rel = int(np.argmax(S_vals[: top - u + 1]))  # first argmax
        m = u + m_rel
        max_score = float(S_vals[m_rel])
        if sp is not None:
            metrics.end(sp)
        if (m - u) >= min_width and max_score >= min_score:
            regions.append((pos_offset + u, pos_offset + m, max_score))
            z_e = z if z is not None else n - 1
            if m + 1 <= z_e:
                if visits is not None:
                    visits[m + 1] += 1
                    visits[z_e + 1] -= 1
                stack.append((m + 1, z_e))
    replay_ranges += ranges
    replays += tried
    replay_emits += len(regions)
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

    One fold of the host library where it loads; else the numpy layers,
    a scored run at a time.
    """
    global replays, replay_emits, native_folds
    s = np.asarray(s, dtype=np.float64)
    scored = np.asarray(scored, bool)
    if native.available():
        sp = metrics.begin("extract.fold") if metrics.enabled else None
        tried = np.zeros(1, np.int64)
        beg, end, score = native.replay_scores(
            s, scored, min_width, min_score, 0, visits=visits_full,
            candidates=tried)
        if sp is not None:
            metrics.end(sp)
        native_folds += 1
        replays += int(tried[0])
        replay_emits += beg.shape[0]
        return list(zip([seq_id] * beg.shape[0], beg.tolist(), end.tolist(),
                        score.tolist()))
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
