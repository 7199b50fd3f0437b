"""The port's host span replay (kmer_spans_tpu_torch/spans/extract.py,
the host library's sequential fold) on scores that tie: decimal tables,
whose sums return to 0 exactly in the reals, and in f64 to 0 or to a few
ulps above it.

A vectorized screen's zeros are differences of prefix sums; they round
otherwise than the reference's clamped fold S_i = max(S_{i-1} + s_i, 0),
added one position at a time.  The fold adds one position at a time, so
its regions (beg/end exact, f64 scores ==), scan counts (rescans
included) and counts of candidate excursions equal the port's oracle
over the same scores (oracle._scan_segment_once, a position's code its
index), the host oracle (backend="host") and the host library's caller
(backend="native").  The JAX package's device path keeps the screen's
rounding (its spans/extract.py) and departs from the oracle on two of
these inputs."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kmer_spans_tpu import api as ref_api
from kmer_spans_tpu.spans import extract as ref_extract
from kmer_spans_tpu_torch import api, oracle
from kmer_spans_tpu_torch.spans import extract

#: A: 0.1 + 0.2 - 0.3 stays 5.55e-17 above 0 in the fold after the -1;
#: the screen's prefix difference is 0 there
SCORES_A = np.array([-1.0, 0.1, 0.2, -0.3] + [0.5] * 200)
#: B: the fold reaches exactly 0 at the -0.4; the screen stays above it
SCORES_B = np.array([-0.1, 0.4, -0.4, 0.4, 0.4] + [0.4] * 300)

#: the same two through kmer_regions at k = 1 (the table in the 2-bit
#: order A C T G): (sequences, table, the oracle's regions)
API_A = (["A" * 50 + "TCGA" + "CG" * 300 + "T" * 50],
         [-0.3, 0.1, -1.0, 0.2], [(0, 52, 654, 90.00000000000021)])
API_B = (["ACTCC" + "C" * 300 + "T"], [-0.1, 0.4, -0.4, 0.3],
         [(0, 4, 305, 120.80000000000064)])


def _fold_spans(s, pos_offset, min_width, min_score, visits=None):
    """The port's oracle over precomputed scores: its scan loop
    (oracle._scan_segment_once: clamp at 0, first argmax, emit and jump
    back to max_pos + 1 on a close or at the end) with each position's
    code its index and the scores as the weights.  Returns (the regions,
    the candidate excursions: those whose last positive position is at
    least min_width past their first and whose S reaches min_score);
    ``visits`` (len(s)) counts each position's scans."""
    s = np.asarray(s, np.float64)
    n = s.shape[0]
    sc = np.zeros(n, np.int64) if visits is None else visits
    regions = []
    start = 0
    while start is not None and start < n:
        start = oracle._scan_segment_once(
            np.arange(n), start, n, pos_offset - 1, 0, min_width, min_score,
            s, -1, 0.0, regions, sc)
    return [r[1:] for r in regions], _candidates(s, min_width, min_score)


def _candidates(s, min_width, min_score):
    """The candidate excursions of the scan over ``s`` (rescans
    included), counted from the oracle's regions: each excursion from a
    position after the last emission's end."""
    count = 0
    start = 0
    n = s.shape[0]
    while start < n:
        score, beg, top, jump = 0.0, None, 0.0, None
        for j in range(start, n + 1):
            score = 0.0 if j == n else max(score + s[j], 0.0)
            if beg is None:
                if score > 0.0:
                    beg, top, arg = j, score, j
                continue
            if score > top:
                top, arg = score, j
            if score == 0.0:  # closed at j (or the end)
                if j - 1 - beg >= min_width and top >= min_score:
                    count += 1
                    if arg - beg >= min_width:  # emitted: rescan from arg+1
                        jump = arg + 1
                        break
                beg = None
        if jump is None:
            return count
        start = jump
    return count


def _fold_extract(s, scored, min_width, min_score):
    """_fold_spans over each scored stretch: extract_spans's regions,
    per-position scan counts and candidate excursions."""
    visits = np.zeros(s.shape[0], np.int64)
    regions = []
    candidates = 0
    edges = np.flatnonzero(np.diff(np.concatenate(([0], scored, [0]))))
    for a, b in zip(edges[0::2], edges[1::2]):
        got, c = _fold_spans(s[a:b], a + 1, min_width, min_score,
                             visits[a:b])
        regions += [(0, beg, end, sc) for beg, end, sc in got]
        candidates += c
    return regions, visits, candidates


def _regions(res):
    return [(int(r["seq_id"]), int(r["beg"]), int(r["end"]),
             float(r["score"])) for r in res.regions]


@pytest.mark.parametrize("scores, min_width, min_score, want", [
    (SCORES_A, 100, 20.0, [(2, 204, 100.0)]),
    (SCORES_B, 100, 20.0, [(4, 305, 120.80000000000064)]),
    (np.array([-0.1, 0.4, -0.4, 0.4, -0.4]), 0, 0.0,
     [(2, 2, 0.4), (4, 4, 0.4)]),
], ids=["a_region_moves", "b_region_lost", "c_walk_to_the_end"])
def test_tied_scores_equal_the_sequential_fold(scores, min_width, min_score,
                                               want):
    """A: a screen cuts one excursion in two at a zero the fold does not
    reach (a replay from the screen's zero starts at 5).  B: a screen
    joins two at a zero the fold reaches; the first fails, the second
    passes.  C: the fold reaches 0 at 2 and at the last position, where a
    screen stays above 0 throughout.  The library's fold equals the
    oracle's on each: regions, scan counts, candidate excursions."""
    v_got = np.zeros(scores.shape[0] + 1, np.int64)
    before = (extract.replays, extract.replay_emits)
    got = extract.extract_spans(scores, np.ones(scores.shape[0], bool),
                                min_width, min_score, visits_full=v_got)
    v_want = np.zeros(scores.shape[0], np.int64)
    want_regions, candidates = _fold_spans(scores, 1, min_width, min_score,
                                           v_want)
    assert [r[1:] for r in got] == want_regions == want
    assert np.array_equal(np.cumsum(v_got)[:-1], v_want)
    assert (extract.replays - before[0], extract.replay_emits - before[1]) \
        == (candidates, len(want))


@pytest.mark.parametrize("case", [API_A, API_B], ids=["a", "b"])
def test_api_equals_host_and_native_on_tied_tables(case):
    """kmer_regions on the CPU (the device path's plain versions, then
    the host replay) equals the oracle (backend="host") and the host
    library (backend="native"): regions with f64 ==, scan counts.  The
    JAX package's device path gives beg 55 on A and no region on B."""
    seqs, table, want = case
    got = api.kmer_regions(seqs, 1, table, 100, 20.0, device="cpu")
    for backend in ("host", "native"):
        other = api.kmer_regions(seqs, 1, table, 100, 20.0, backend=backend)
        assert _regions(got) == _regions(other) == want
        assert np.array_equal(got.counts, other.counts)
    ref = _regions(ref_api.kmer_regions(seqs, 1, table, 100, 20.0))
    assert ref == ([(0, 55, 654, 90.00000000000021)] if case is API_A
                   else [])


def test_seeded_genome_k2_equals_native():
    """A 2^20-base genome and a 16-entry table of steps of 0.1 (-0.55 to
    0.45): 780 regions and 1,988,652 scanned k-mers, equal to the host
    library's caller (a replay from a screen's unconfirmed zeros gave 725
    regions and 1,970,171)."""
    rng = np.random.default_rng(7)
    seq = "".join(rng.choice(list("ACGT"), size=1 << 20))
    w = np.round(rng.choice(np.arange(-5, 6), size=16) / 10.0 - 0.05, 2)
    got = api.kmer_regions([seq], 2, w, 20, 2.0, device="cpu")
    assert len(got.regions) == 780
    assert int(got.counts.sum()) == 1_988_652
    want = api.kmer_regions([seq], 2, w, 20, 2.0, backend="native")
    assert _regions(got) == _regions(want)
    assert np.array_equal(got.counts, want.counts)


@st.composite
def tied_scores(draw):
    """Scores over a short decimal alphabet (4-16 multiples of 0.05 or
    0.1, both signs, maybe -inf), with long planted runs of a short
    pattern, some of whose sums are exactly 0 in the reals."""
    step = draw(st.sampled_from([0.05, 0.1]))
    size = draw(st.integers(4, 16))
    ints = draw(st.lists(st.integers(-20, 20), min_size=size,
                         max_size=size))
    ints[0] = abs(ints[0]) or 1
    ints[1] = -abs(ints[1]) or -1
    alphabet = np.round(np.array(ints) * step, 2)
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))
    n = draw(st.integers(1, 500))
    s = rng.choice(alphabet, n)
    for _ in range(draw(st.integers(0, 3))):
        a, b = rng.choice(alphabet, 2)
        pattern = [a, b, round(-(a + b), 2)][: draw(st.integers(1, 3))]
        lo = int(rng.integers(0, n))
        hi = min(n, lo + draw(st.integers(20, 300)))
        s[lo:hi] = np.resize(pattern, hi - lo)
    if draw(st.booleans()):
        s[rng.random(n) < 0.01] = -np.inf
    scored = rng.random(n) > 0.02
    s = np.where(scored, s, 0.0)
    return s, scored


@settings(max_examples=200, deadline=None, database=None)
@given(case=tied_scores(), min_width=st.integers(0, 30),
       min_score=st.sampled_from([0.0, 0.5, 1.0, 2.0, 5.0]))
def test_extract_spans_equals_the_sequential_fold(case, min_width,
                                                   min_score):
    s, scored = case
    visits = np.zeros(s.shape[0] + 1, np.int64)
    got = extract.extract_spans(s, scored, min_width, min_score,
                                visits_full=visits)
    want, want_visits, _ = _fold_extract(s, scored, min_width, min_score)
    assert got == want
    assert np.array_equal(np.cumsum(visits)[:-1], want_visits)


def _folded(s, scored, min_width, min_score, seq_id=0):
    """extract_spans: (regions, visits, the change in ``replays``,
    ``replay_emits`` and ``native_folds``)."""
    before = (extract.replays, extract.replay_emits, extract.native_folds)
    visits = np.zeros(s.shape[0] + 1, np.int64)
    got = extract.extract_spans(s, scored, min_width, min_score,
                                seq_id=seq_id, visits_full=visits)
    return (got, visits, extract.replays - before[0],
            extract.replay_emits - before[1],
            extract.native_folds - before[2])


def _case_neg_inf():
    s = np.array([0.5] * 30 + [-np.inf] + [0.5] * 30 + [-0.2] * 5
                 + [0.3] * 40 + [-np.inf] * 2 + [0.25] * 20)
    return s, np.ones(s.shape[0], bool), 10, 2.0


def _case_several_runs():
    rng = np.random.default_rng(11)
    s = rng.choice(np.round(np.arange(-5, 6) / 10.0, 2), 3000)
    s[500:900] = np.resize([0.4, -0.3, 0.2], 400)
    s[1700:2300] = np.resize([0.1, 0.2, -0.3, 0.4], 600)
    scored = np.ones(s.shape[0], bool)
    scored[[0, 600, 601, 1800, 2999]] = False
    return np.where(scored, s, 0.0), scored, 20, 2.0


def _case_many_regions():
    """More regions (~400) than the library's former first buffer of 256
    held."""
    rng = np.random.default_rng(5)
    s = rng.normal(-1.0, 0.5, 40_000)
    for lo in rng.choice(np.arange(0, 39_950, 60), 400, replace=False):
        s[lo:lo + int(rng.integers(15, 45))] = rng.uniform(0.2, 1.0)
    return s, np.ones(s.shape[0], bool), 10, 3.0


@pytest.mark.parametrize("case", [
    pytest.param(lambda: (SCORES_A, np.ones(SCORES_A.shape[0], bool),
                          100, 20.0), id="a_region_moves"),
    pytest.param(lambda: (SCORES_B, np.ones(SCORES_B.shape[0], bool),
                          100, 20.0), id="b_region_lost"),
    pytest.param(_case_neg_inf, id="neg_inf_resets"),
    pytest.param(lambda: (np.array([-0.1, 0.4, -0.4, 0.4, -0.4]),
                          np.ones(5, bool), 0, 0.0), id="walk_to_the_end"),
    pytest.param(lambda: (np.array([-1.0] + [0.5] * 60), np.ones(61, bool),
                          10, 2.0), id="open_at_the_end"),
    pytest.param(_case_several_runs, id="several_runs"),
    pytest.param(_case_many_regions, id="many_regions"),
])
def test_library_fold_equals_the_numpy_path(case):
    """The host library's fold and the sequential oracle agree: regions
    (f64 ==), scan counts, the candidate excursions counted in
    ``replays`` and the emissions in ``replay_emits``; one fold a call.
    On the many-regions case, whose scores neither tie nor hold -inf,
    the JAX package's numpy copy gives the same regions and scan counts
    too (its screen trusts its zeros, so ties are the oracle's alone)."""
    s, scored, min_width, min_score = case()
    got, visits, tried, emits, folds = _folded(s, scored, min_width,
                                               min_score, seq_id=3)
    want, want_visits, candidates = _fold_extract(s, scored, min_width,
                                                  min_score)
    assert got == [(3,) + r[1:] for r in want]
    assert np.array_equal(np.cumsum(visits)[:-1], want_visits)
    assert (tried, emits, folds) == (candidates, len(want), 1)
    if case is _case_many_regions:
        assert len(want) > 256
        ref_visits = np.zeros(s.shape[0] + 1, np.int64)
        assert ref_extract.extract_spans(s, scored, min_width, min_score,
                                         seq_id=3,
                                         visits_full=ref_visits) == got
        assert np.array_equal(ref_visits, visits)


@settings(max_examples=100, deadline=None, database=None)
@given(case=tied_scores(), min_width=st.integers(0, 30),
       min_score=st.sampled_from([0.0, 0.5, 1.0, 2.0, 5.0]))
def test_numpy_path_equals_the_library_fold(case, min_width, min_score):
    """On tied scores with -inf, the library's fold counts the oracle's
    candidate excursions and emissions, in one fold."""
    s, scored = case
    got, _, tried, emits, folds = _folded(s, scored, min_width, min_score)
    want, _, candidates = _fold_extract(s, scored, min_width, min_score)
    assert got == want
    assert (tried, emits, folds) == (candidates, len(want), 1)


# ------------------------------------------ the fold that reads a table

def _table_stretch(k, order, block=256):
    """A store of code rows and masks (its first half the top C's rows,
    its second the pulled ones), a 4^k table of decimal steps with -inf
    entries, and the rows of one stretch taken from both halves, in
    order or not.  Planted runs of a three-code pattern whose scores
    (1, -0.5, -0.5 after the threshold 0.25) sum to exactly 0 tie the
    running maxima; the codes of unscored positions are junk out of the
    table's range."""
    rng = np.random.default_rng(k * 10 + len(order))
    size = 1 << (2 * k)
    table = np.round(rng.integers(-6, 5, size) / 10.0, 2)
    table[rng.random(size) < 0.002] = -np.inf
    hot = rng.choice(size, 3, replace=False)
    table[hot] = (1.25, -0.25, -0.25)
    up = rng.choice(size, 1)
    table[up] = 1.0
    patterns = [hot, np.concatenate([up, hot])]
    R = 24
    codes = rng.integers(0, size, (R, block)).astype(np.int32)
    for r in range(R):
        for lo in rng.choice(block, 3, replace=False):
            n = int(rng.integers(30, 200))
            codes[r, lo:lo + n] = np.resize(
                patterns[rng.integers(2)], n)[:block - lo]
    codes[:, rng.random(block) < 0.01] = 0
    stop = rng.choice(size, 1)
    table[stop] = -np.inf
    codes[rng.integers(0, R, 40), rng.integers(0, block, 40)] = stop
    scored = rng.random((R, block)) > 0.01
    scored[3, :40] = False
    scored[17, -5:] = False
    junk = np.array([-(1 << 31), -1, size, size + 7, (1 << 31) - 1],
                    np.int32)
    codes[~scored] = rng.choice(junk, int((~scored).sum()))
    if order == "in_order":
        rows = np.arange(R // 2 - 4, R // 2 + 6)  # the top's tail, pulled head
    else:
        rows = rng.permutation(R)[:14]
    return codes, scored, rows.astype(np.int64), table


@pytest.mark.parametrize("order", ["in_order", "out_of_order"])
@pytest.mark.parametrize("k", [4, 8, 12])
def test_table_fold_equals_the_precomputed_scores(k, order):
    """The table form of extract_spans (store, table, threshold), its rows
    in two arrays, and the precomputed-score form over the same stretch:
    regions (beg, end and the score's bits), scan counts, candidate
    excursions and emissions equal; one fold each, the first counted in
    ``table_folds``."""
    from kmer_spans_tpu_torch.utils import native

    codes, scored, rows, table = _table_stretch(k, order)
    thr = 0.25
    store = native.RowStore(codes.shape[1])
    half = codes.shape[0] // 2
    assert store.add(codes[:half], scored[:half]) == 0
    assert store.add(codes[half:], scored[half:]) == half
    c_flat = codes[rows].reshape(-1)
    sc_flat = scored[rows].reshape(-1)
    s = np.where(sc_flat, (table - thr)[np.where(sc_flat, c_flat, 0)], 0.0)
    names = ("replays", "replay_emits", "native_folds", "table_folds")
    got = {}
    for form in ("table", "scores"):
        before = [getattr(extract, n) for n in names]
        visits = np.zeros(s.shape[0] + 1, np.int64)
        if form == "table":
            regs = extract.extract_spans((store, table, thr), None, 20,
                                         2.0, seq_id=1, visits_full=visits,
                                         base_pos=999, rows=rows)
        else:
            regs = extract.extract_spans(s, sc_flat, 20, 2.0, seq_id=1,
                                         visits_full=visits, base_pos=999)
        got[form] = (regs, visits, [getattr(extract, n) - b
                                    for n, b in zip(names, before)])
    (t_regs, t_visits, t_counts), (s_regs, s_visits, s_counts) = \
        got["table"], got["scores"]
    assert len(t_regs) > 5
    assert [r[:3] for r in t_regs] == [r[:3] for r in s_regs]
    assert np.array_equal(np.array([r[3] for r in t_regs]).view(np.int64),
                          np.array([r[3] for r in s_regs]).view(np.int64))
    assert np.array_equal(t_visits, s_visits)
    assert t_counts == s_counts[:3] + [1] and s_counts[3] == 0
    assert t_counts[0] >= t_counts[1] == len(t_regs)
    assert (s == -np.inf).any() and _tied_maxima(s, sc_flat) > 0


def _tied_maxima(s, scored):
    """How often the clamped fold over the scored runs of ``s`` comes
    back to its excursion's running maximum, exactly."""
    ties, S, mx = 0, 0.0, 0.0
    for v, on in zip(s, scored):
        S = max(S + v, 0.0) if on else 0.0
        if S == 0.0:
            mx = 0.0
        elif S == mx:
            ties += 1
        mx = max(mx, S)
    return ties


def test_table_fold_refuses_rows_it_cannot_read():
    """A row index beyond the store, rows of other than [R, block], or a
    block of other than a power of two positions: the binding raises and
    the library folds nothing; a store of two arrays reads each row where
    it lies, the codes joined in the rows' order."""
    from kmer_spans_tpu_torch.utils import native

    codes = np.zeros((2, 256), np.int32)
    scored = np.ones((2, 256), bool)
    table = np.ones(4)
    store = native.RowStore(256)
    store.add(codes[:1], scored[:1])
    store.add(codes[1:] + 1, scored[1:])
    with pytest.raises(IndexError):
        native.replay_table(store, np.array([0, 2]), table, 0.5, 10, 2.0, 0)
    with pytest.raises(ValueError):
        store.add(codes[:, :255], scored[:, :255])
    odd = native.RowStore(255)
    odd.add(codes[:, :255], scored[:, :255])
    with pytest.raises(ValueError):
        native.replay_table(odd, np.array([0]), table, 0.5, 10, 2.0, 0)
    beg, _, score = native.replay_table(store, np.array([1, 0]), table, 0.5,
                                        10, 2.0, 0)
    assert beg.tolist() == [1] and score.tolist() == [256.0]
    assert store.codes(np.array([1, 0, 1])).tolist() == \
        [[1] * 256, [0] * 256, [1] * 256]
