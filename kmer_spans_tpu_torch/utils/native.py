"""ctypes binding for the port's host library (csrc/host/kmerspans_host.cpp).

The library is built at first use with the system C++ compiler ($CXX, else
``c++`` or ``g++`` on PATH) into ``kmer_spans_tpu_torch/build/``, under a
name made from a hash of the source and flags.  The compiler writes a
per-process temporary file that ``os.replace`` moves into place, so
concurrent processes never load a half-written library.  The device
paths need the library: where it does not build or load, every entry
point raises RuntimeError carrying the compiler's message.  A failed
build is not remembered: the next call tries again.  The api's
``backend="host"`` (the sequential oracle) never loads it.

Copied from ``kmer_spans_tpu/utils/native.py`` for the entry points the
port calls: same arguments, same results (``replay_scores`` adds two
optional outputs, scan counts and candidates, and sizes its region
buffers so that it folds once; ``replay_table``, the port's own, is the
same fold reading its scores from a table).  ``find_spans``, ``count_spectrum`` and
``host_spectrum_sparse`` serve the api's ``backend="native"``;
``pack_nbases`` is bound as the reference binds it, and no caller of the
port uses it yet; the rest serve the host finishers of the device paths
and the span extraction of the exact path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host" / "kmerspans_host.cpp"
BUILD_DIR = _PKG / "build"
#: no -march=native: the built file must load on any x86-64 host the tree
#: is copied to; no fast-math, so the f64 folds stay IEEE
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared",
            "-ffp-contract=off", "-Wall", "-Wextra")

_P, _I32, _I64, _F64 = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                        ctypes.c_double)
_SIGNATURES = {
    "ks_pack": (_P, _I64, _P),
    "ks_count": (_P, _I64, _I32, _P),
    "ks_count_sparse": (_P, _I64, _I32, _P, _P, _I64, _P, _I32),
    "ks_spans": (_P, _I64, _I32, _P, _F64, _I64, _F64, _P, _P, _P, _I64,
                 _P),
    "ks_count_mt": (_P, _I64, _I32, _P, _I32),
    "ks_count_radix": (_P, _I64, _I32, _P, _I32),
    "ks_rank_chain": (_P, _I64, _F64, _P),
    "ks_chain_from_hist": (_P, _P, _I64, _F64, _P, _I64, _P),
    "ks_mass_of_codes": (_P, _I64, _P, _I64, _P, _P, _P, _I64),
    "ks_replay_packed": (_P, _P, _I64, _I64, _I32, _P, _F64, _I64, _F64,
                         _I64, _P, _P, _P, _I64),
    "ks_replay_scores": (_P, _P, _I64, _I64, _F64, _I64, _P, _P, _P, _I64,
                         _P, _P),
    "ks_replay_table": (_P, _P, _I64, _I64, _P, _F64, _I64, _F64, _I64, _P,
                        _P, _P, _I64, _P, _P),
    "ks_replay_tr": (_P, _P, _P, _I64, _P, _P, _I64, _I64, _I64, _P, _P, _P,
                     _I64),
}

_lib: ctypes.CDLL | None = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libkst_host_{h.hexdigest()[:16]}.so"


def _compiler() -> str | None:
    return (os.environ.get("CXX") or shutil.which("c++")
            or shutil.which("g++"))


def build() -> Path:
    """Compile the library unless it is already there; return its path.

    Raises RuntimeError when there is no compiler or the compiler fails.
    """
    out = library_path()
    if out.exists():
        return out
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX, c++ or g++)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    try:
        res = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"{cxx} failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never loads half
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load() -> ctypes.CDLL:
    """The library, built first where it is not there yet.

    Raises RuntimeError where it does not build or load; the next call
    tries again.
    """
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(str(build()))
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(
                    f"the host library did not build or load: {e}") from e
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int64
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def pack_nbases(raw: np.ndarray) -> np.ndarray:
    """bytes -> nbases (2-bit values, N == 4)."""
    lib = _load()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty(raw.shape[0], dtype=np.uint8)
    lib.ks_pack(raw.ctypes.data, raw.shape[0], out.ctypes.data)
    return out


def count_spectrum(nbases: np.ndarray, k: int) -> tuple[np.ndarray, int]:
    """Native sequential spectrum count."""
    lib = _load()
    nbases = np.ascontiguousarray(nbases, dtype=np.uint8)
    counts = np.zeros(1 << (2 * k), dtype=np.int32)
    n = lib.ks_count(nbases.ctypes.data, nbases.shape[0], k, counts.ctypes.data)
    return counts.astype(np.int64), int(n)


def host_spectrum(
    nbases: np.ndarray, k: int, threads: int = 0,
) -> tuple[np.ndarray, int]:
    """Host spectrum from nbases (N == 4).  The k >= 10 span pipelines
    replay candidates from this recount instead of pulling 4^k device
    words (spans/pipeline.py packed_counts=False).

    threads=0 picks min(os.cpu_count(), 4); >1 uses the code-space-
    partitioned multithreaded native counter (shared table, disjoint
    writes).  Returns (counts, n_words); counts int32 for k >= 13 (the
    4^k table is 4 GB at k=15; int64 would double it), int64 below.
    """
    lib = _load()
    if threads == 0:
        threads = min(os.cpu_count() or 1, 4)
    nbases = np.ascontiguousarray(nbases, dtype=np.uint8)
    counts = np.zeros(1 << (2 * k), dtype=np.int32)
    if 10 <= k <= 14 and nbases.shape[0] >= (1 << (2 * k - 3)):
        # cache-staged radix counter: per-bucket write-combining into
        # cache-resident table slices (atomic adds).  Not for k = 15,
        # where each count touches a unique line, and only when the
        # genome is big enough for slices to get several hits
        # (n >= 4^k / 8)
        n = lib.ks_count_radix(nbases.ctypes.data, nbases.shape[0],
                               k, counts.ctypes.data, threads)
    else:
        n = lib.ks_count_mt(nbases.ctypes.data, nbases.shape[0], k,
                            counts.ctypes.data, threads)
    if k < 13:
        counts = counts.astype(np.int64)
    # k >= 13 stays int32: the table is 0.25-4 GB, and every native
    # consumer (rank_chain, mass_of_codes, replay) takes int32
    return counts, int(n)


def host_spectrum_sparse(
    nbases: np.ndarray, k: int, threads: int = 0,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Sparse host spectrum for wide k (16..31): distinct int64 codes and
    their counts, ascending (threads partition the code space and sort
    independently; 0 takes up to 8).  Returns (ucodes, ucounts, n_words)."""
    lib = _load()
    nbases = np.ascontiguousarray(nbases, dtype=np.uint8)
    if threads == 0:
        threads = min(os.cpu_count() or 1, 8)
    n = nbases.shape[0]
    cap = max(n, 1)
    ucodes = np.empty(cap, dtype=np.int64)
    ucounts = np.empty(cap, dtype=np.int64)
    nw = np.zeros(1, dtype=np.int64)
    nd = lib.ks_count_sparse(
        nbases.ctypes.data, n, k, ucodes.ctypes.data,
        ucounts.ctypes.data, cap, nw.ctypes.data, threads)
    assert nd <= cap  # distinct <= words <= n by construction
    return ucodes[:nd].copy(), ucounts[:nd].copy(), int(nw[0])


def chain_from_hist(v_vals, n_codes, total, pm) -> np.ndarray:
    """Exact f64 chain ranks for mass values pm given the sparse value
    histogram: the C form of stats/ranks.py chain_ranks_from_mass (one
    streaming fold).  Raises ValueError on an invalid pm."""
    lib = _load()
    v_vals = np.ascontiguousarray(v_vals, dtype=np.int64)
    n_codes = np.ascontiguousarray(n_codes, dtype=np.int64)
    pm = np.ascontiguousarray(pm, dtype=np.int64)
    out = np.empty(pm.shape[0], dtype=np.float64)
    rc = lib.ks_chain_from_hist(
        v_vals.ctypes.data, n_codes.ctypes.data, v_vals.shape[0],
        float(total), pm.ctypes.data, pm.shape[0], out.ctypes.data)
    if rc != 0:
        raise ValueError("pm is not a cumulative_mass value")
    return out


def rank_chain(counts: np.ndarray, total: int) -> np.ndarray:
    """The reference's exact f64 rank chain over a dense spectrum via the
    sort-free native kernel (value histogram + per-value cursors).  Counts
    must fit int32."""
    lib = _load()
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    ranks = np.empty(counts.shape[0], dtype=np.float64)
    lib.ks_rank_chain(counts.ctypes.data, counts.shape[0], float(total),
                      ranks.ctypes.data)
    return ranks


def _fold_outputs(n, min_width, visits, candidates):
    """Check the fold's optional outputs and size its region buffers:
    len // (min_width + 1) + 1 entries, since regions never overlap and
    each spans at least min_width + 1 positions, so one fold always
    suffices."""
    for out, size in ((visits, n + 1), (candidates, 1)):
        if out is not None and (out.dtype != np.int64 or out.shape != (size,)
                                or not out.flags.c_contiguous):
            raise ValueError(f"an output must be contiguous int64 [{size}]")
    cap = n // (max(min_width, 0) + 1) + 1
    return (np.empty(cap, dtype=np.int64), np.empty(cap, dtype=np.int64),
            np.empty(cap, dtype=np.float64), cap)


def _mask(scored: np.ndarray) -> np.ndarray:
    scored = np.ascontiguousarray(scored)
    return scored.view(np.uint8) if scored.dtype == np.bool_ else \
        scored.astype(np.uint8)


def _ptr(a: np.ndarray | None):
    return None if a is None else a.ctypes.data


def replay_scores(
    s: np.ndarray, scored: np.ndarray, min_width: int, min_score: float,
    base_pos: int, visits: np.ndarray | None = None,
    candidates: np.ndarray | None = None,
):
    """Reference-exact replay from precomputed per-position f64 scores:
    the reference's sequential fold over each run of ``scored``.  Its one
    caller is spans/extract.py extract_spans, through which every host
    finisher of the device paths folds.

    Returns (beg, end, score) arrays in 1-based last-base coordinates
    offset by ``base_pos``.  Two optional outputs, both added into:
    ``visits``, an int64 difference array of len(s) + 1 whose prefix sum
    counts each position's scans (rescans included); ``candidates``, an
    int64 array of one element that gains the count of candidate
    excursions (those spans/extract.py replays).
    """
    lib = _load()
    s = np.ascontiguousarray(s, dtype=np.float64)
    scored = _mask(scored)
    n = s.shape[0]
    if scored.shape != (n,):
        raise ValueError("scored must have one entry a score")
    beg, end, score, cap = _fold_outputs(n, min_width, visits, candidates)
    nreg = lib.ks_replay_scores(
        s.ctypes.data, scored.ctypes.data, n, min_width, min_score,
        base_pos, beg.ctypes.data, end.ctypes.data, score.ctypes.data, cap,
        _ptr(visits), _ptr(candidates))
    assert nreg <= cap  # disjoint regions of min_width + 1 positions
    return beg[:nreg], end[:nreg], score[:nreg]


class RowStore:
    """Rows of ``block`` positions, their int32 codes and bool mask, kept
    where they lie in several arrays under one row index: the rows
    ``replay_table`` reads.  The store keeps each added array alive and
    the address of each of its rows."""

    def __init__(self, block: int):
        self.block = block
        self.nrows = 0
        self._arrays = []
        self._firsts = []
        self._addr = []
        self._joined = None

    def add(self, codes: np.ndarray, scored: np.ndarray) -> int:
        """Append the rows of codes and scored ([R, block] int32 and bool,
        not copied where they already are contiguous); returns the row
        index of the first."""
        codes = np.ascontiguousarray(codes, dtype=np.int32)
        scored = _mask(scored)
        if codes.ndim != 2 or codes.shape[1] != self.block \
                or scored.shape != codes.shape:
            raise ValueError(f"codes and scored must be [R, {self.block}]")
        first = self.nrows
        r = np.arange(codes.shape[0], dtype=np.int64)
        self._arrays.append((codes, scored))
        self._firsts.append(first)
        self._addr.append((codes.ctypes.data + r * codes.strides[0],
                           scored.ctypes.data + r * scored.strides[0]))
        self.nrows += codes.shape[0]
        self._joined = None
        return first

    def addresses(self, rows: np.ndarray):
        """The code and mask addresses of ``rows`` (an IndexError for an
        index beyond the store; a negative one counts from its end)."""
        if self._joined is None:
            self._joined = (np.concatenate([a[0] for a in self._addr]),
                            np.concatenate([a[1] for a in self._addr]))
        return self._joined[0][rows], self._joined[1][rows]

    def codes(self, rows: np.ndarray) -> np.ndarray:
        """The code rows ``rows``, joined: [len(rows), block] int32."""
        which = np.searchsorted(self._firsts, rows, side="right") - 1
        return np.stack([self._arrays[a][0][r - self._firsts[a]]
                         for a, r in zip(which, rows)])


def replay_table(
    store: RowStore, rows: np.ndarray, table: np.ndarray, threshold: float,
    min_width: int, min_score: float, base_pos: int,
    visits: np.ndarray | None = None, candidates: np.ndarray | None = None,
):
    """``replay_scores`` over scores the library reads itself:
    ``table[code] - threshold`` in f64 at each scored position, the same
    subtraction and the same fold, so the same results bit for bit.

    store, rows: the stretch's rows in order, indices into ``store`` (its
    block a power of two), read in place, so the stretch has len(rows) *
    block positions.  Every scored code must index ``table`` (f64, taken
    as it is where it is contiguous f64); the codes of unscored positions
    are never read.  visits and candidates as in ``replay_scores``.
    """
    lib = _load()
    rows = np.asarray(rows, dtype=np.int64)
    if rows.ndim != 1:
        raise ValueError("rows must be 1-D")
    code_rows, mask_rows = store.addresses(rows)
    table = np.ascontiguousarray(table, dtype=np.float64)
    n = rows.shape[0] * store.block
    beg, end, score, cap = _fold_outputs(n, min_width, visits, candidates)
    nreg = lib.ks_replay_table(
        code_rows.ctypes.data, mask_rows.ctypes.data, rows.shape[0],
        store.block, table.ctypes.data, float(threshold), min_width,
        min_score, base_pos, beg.ctypes.data, end.ctypes.data,
        score.ctypes.data, cap, _ptr(visits), _ptr(candidates))
    if nreg < 0:
        raise ValueError("a row must hold a power of two of positions")
    assert nreg <= cap  # disjoint regions of min_width + 1 positions
    return beg[:nreg], end[:nreg], score[:nreg]


def replay_tr(codes, seed, ext, ks, ts, base_pos: int, min_len: int,
              seq_len: int | None = None):
    """The transition-score replay of one stretch: the C form of the JAX
    package's ``kmer_spans_tpu/spans/tr_pipeline.py replay_tr_segment``,
    with ks/ts the 4^k f64 tables gathered at each position's code, and
    given ``seq_len`` the oracle's end-of-sequence check.

    Returns (beg, end, score) arrays in global 1-based last-base coords.
    """
    lib = _load()
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    seed = np.ascontiguousarray(seed, dtype=np.uint8)
    ext = np.ascontiguousarray(ext, dtype=np.uint8)
    ks = np.ascontiguousarray(ks, dtype=np.float64)
    ts = np.ascontiguousarray(ts, dtype=np.float64)
    cap = 256
    while True:
        beg = np.empty(cap, dtype=np.int64)
        end = np.empty(cap, dtype=np.int64)
        score = np.empty(cap, dtype=np.float64)
        nreg = lib.ks_replay_tr(
            codes.ctypes.data, seed.ctypes.data, ext.ctypes.data,
            codes.shape[0], ks.ctypes.data, ts.ctypes.data, base_pos,
            min_len, -1 if seq_len is None else seq_len,
            beg.ctypes.data, end.ctypes.data, score.ctypes.data, cap)
        if nreg <= cap:
            return beg[:nreg], end[:nreg], score[:nreg]
        cap = int(nreg) + 16


def mass_of_codes(counts: np.ndarray, qcodes: np.ndarray):
    """Exact integer mass + sparse value histogram for sorted unique
    query codes (the k >= 13 replay path: no 4^k f64 rank table).

    Returns (pm int64 [nq], v_vals int64 asc, v_ncodes int64).  counts
    must be int32-compatible.
    """
    lib = _load()
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    q = np.ascontiguousarray(qcodes, dtype=np.int64)
    pm = np.empty(q.shape[0], dtype=np.int64)
    cap = 1 << 16
    while True:
        vv = np.empty(cap, dtype=np.int64)
        vn = np.empty(cap, dtype=np.int64)
        nvals = lib.ks_mass_of_codes(
            counts.ctypes.data, counts.shape[0], q.ctypes.data,
            q.shape[0], pm.ctypes.data, vv.ctypes.data, vn.ctypes.data,
            cap)
        if nvals <= cap:
            return pm, vv[:nvals], vn[:nvals]
        cap = int(nvals) + 16


def replay_packed(
    cand_words: np.ndarray,
    scored: np.ndarray,
    block: int,
    k: int,
    ranks: np.ndarray,
    threshold: float,
    min_width: int,
    min_score: float,
    base_pos: int,
):
    """Reference-exact candidate-stretch replay from the device's packed
    2-bit-bases payload (spans/pipeline.py packed_bases format).

    cand_words: [rows, 1 + block/16] uint32 (seed code + base words) for
    CONSECUTIVE candidate blocks; scored: [rows, block] bool; base_pos:
    global 0-based position of the stretch's first element.
    Returns (beg, end, score) arrays in global 1-based last-base coords.
    """
    lib = _load()
    cand_words = np.ascontiguousarray(cand_words, dtype=np.uint32)
    scored = np.ascontiguousarray(scored, dtype=np.uint8)
    rows = cand_words.shape[0]
    ranks = np.ascontiguousarray(ranks, dtype=np.float64)
    cap = 256
    while True:
        beg = np.empty(cap, dtype=np.int64)
        end = np.empty(cap, dtype=np.int64)
        score = np.empty(cap, dtype=np.float64)
        nreg = lib.ks_replay_packed(
            cand_words.ctypes.data, scored.ctypes.data,
            rows, block, k, ranks.ctypes.data, threshold,
            min_width, min_score, base_pos,
            beg.ctypes.data, end.ctypes.data, score.ctypes.data, cap,
        )
        if nreg <= cap:
            return beg[:nreg], end[:nreg], score[:nreg]
        cap = int(nreg) + 16


def find_spans(
    nbases: np.ndarray,
    k: int,
    weights: np.ndarray,
    threshold: float,
    min_width: int,
    min_score: float,
    want_scan_counts: bool = False,
):
    """Native sequential span caller (reference-exact).

    Returns (beg, end, score arrays, scan_counts int64 [4^k] or None).
    The region buffers start at 1024 and grow to the count the caller
    reports, with the call repeated.
    """
    lib = _load()
    nbases = np.ascontiguousarray(nbases, dtype=np.uint8)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    sc = np.zeros(1 << (2 * k), dtype=np.int64) if want_scan_counts else None
    cap = 1024
    while True:
        beg = np.empty(cap, dtype=np.int64)
        end = np.empty(cap, dtype=np.int64)
        score = np.empty(cap, dtype=np.float64)
        if sc is not None:
            sc[:] = 0
        nreg = lib.ks_spans(
            nbases.ctypes.data, nbases.shape[0], k,
            weights.ctypes.data, threshold, min_width, min_score,
            beg.ctypes.data, end.ctypes.data, score.ctypes.data,
            cap, sc.ctypes.data if sc is not None else None,
        )
        if nreg <= cap:
            return beg[:nreg], end[:nreg], score[:nreg], sc
        cap = int(nreg) + 16
