"""Exact span extraction from per-position scores (host, f64).

The port's counterpart of ``kmer_spans_tpu/spans/extract.py``, which also
takes -inf scores (a reset to 0, as in the sequential reference).  It
implements the excursion recursion of SURVEY.md A.4: the reference's
jump-back rescan is, per positive excursion of the score trace,

    split at the FIRST argmax m; emit the prefix (first-positive .. m) if it
    passes (min_width, min_score); rescan the suffix from m+1 with S = 0;
    a failing candidate emits nothing from its whole excursion.

``extract_spans`` is the one sequential fold of every host finisher of
the device paths: ``utils/native.replay_scores``, the reference's loop
itself in the host library (``ks_replay_scores``), over every scored run
of a stretch in one call: the same additions in the same order, the same
first argmax and rescans, with the scan counts and the candidate count as
optional outputs.  The exact path's finisher hands it the weight table
instead of the scores (``utils/native.replay_table`` →
``ks_replay_table``): the library then takes ``table[code] - threshold``
at each scored position itself, reading the stretch's code and mask rows
where they lie.  The library is required: where it does not build or
load, the fold raises RuntimeError.  The JAX package's numpy copy and the
port's oracle are the references the tests hold it to.

Span (utils/metrics.py): ``extract.fold`` the library's fold of a
stretch.  The counters below count whether the recorder is on or off.
"""

from __future__ import annotations

import numpy as np

from ..utils import metrics, native

#: candidate excursions replayed, and those of them that emitted a region
replays = 0
replay_emits = 0
#: ``extract_spans`` calls the host library folded, and those of them
#: that read their scores from a table
native_folds = 0
table_folds = 0


def extract_spans(
    s,
    scored: np.ndarray | None,
    min_width: int,
    min_score: float,
    seq_id: int = 0,
    visits_full: np.ndarray | None = None,
    base_pos: int = 0,
    rows: np.ndarray | None = None,
):
    """Extract spans over a whole sequence given per-position scores + mask.

    s, scored are full-length (one entry per base, end-position convention);
    runs of ``scored`` are independent scan stretches (the reference's
    N-free segments minus warm-up and segment tails).

    Or s is ``(store, table, threshold)``, with ``store`` a
    ``utils/native.RowStore`` of code and mask rows (scored is then None),
    and ``rows`` the int64 indices of the stretch's rows in it, in order;
    the fold reads ``table[code] - threshold`` at each scored position
    itself (``utils/native.replay_table``), and the stretch is len(rows) *
    block positions long.

    visits_full: optional int64 array (len + 1) difference array over BASE
    positions accumulating scan multiplicity (for scan-count parity).
    base_pos: the 0-based position of s[0] in its sequence, added to every
    region's coordinates.

    Returns [(seq_id, beg, end, score)] in 1-based last-base coordinates.
    """
    global replays, replay_emits, native_folds, table_folds
    tried = np.zeros(1, np.int64)
    if isinstance(s, tuple):
        store, table, threshold = s
        sp = metrics.begin("extract.fold") if metrics.enabled else None
        beg, end, score = native.replay_table(
            store, rows, table, threshold, min_width, min_score, base_pos,
            visits=visits_full, candidates=tried)
        table_folds += 1
    else:
        s = np.asarray(s, dtype=np.float64)
        scored = np.asarray(scored, bool)
        sp = metrics.begin("extract.fold") if metrics.enabled else None
        beg, end, score = native.replay_scores(
            s, scored, min_width, min_score, base_pos, visits=visits_full,
            candidates=tried)
    if sp is not None:
        metrics.end(sp)
    native_folds += 1
    replays += int(tried[0])
    replay_emits += beg.shape[0]
    return list(zip([seq_id] * beg.shape[0], beg.tolist(), end.tolist(),
                    score.tolist()))
