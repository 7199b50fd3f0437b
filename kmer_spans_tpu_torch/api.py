"""User API of the port: k-mer counts and span calling.

Counterpart of ``kmer_spans_tpu/api.py``.  Every function that takes a
``backend`` in the reference takes one here, beside ``device``:

  * ``backend="auto"`` (the default) runs the device path on ``device``
    ("cuda" by default, or "cpu" for the kernels' plain versions); it
    stands in for the reference's "jax" and never picks a CPU backend.
    A CUDA device without a card raises.  Its host finish needs the
    port's host C++ library (utils/native.py): where that does not build
    or load, the call raises RuntimeError;
  * ``backend="host"`` runs the port's sequential oracle (oracle.py) one
    sequence at a time, as the reference's "host" does; it loads no host
    library, so it is the route for a machine without a C++ compiler;
  * ``backend="native"`` runs the port's host C++ library
    (utils/native.py: count_spectrum, find_spans) where the reference's
    "native" does, and the oracle where the reference does too
    (lr_regions, window_kmer_dist, and the wide caller over the sparse
    spectrum of host_spectrum_sparse).  Without the library it raises
    RuntimeError.
  * Any other name raises ValueError ("jax" too).  Under "host" and
    "native", ``device`` is not used and nothing touches the card; no
    call moves from one backend to another.

The device path of each function:

  * kmer_counts: the 4^k spectrum (parallel/device.py, K3);
  * kmer_regions, kmer_spans and kmer_low_comp_regions(mode="exact"), the
    default: a weight table (models/scoring.py), its integer screen on the
    device (spans/pipeline.py make_weight_span_pipeline, K3 for the scan
    counts), one sequence at a time (on CUDA, up to 2^20 positions, the
    replay of a CUDA graph captured once a padded size), and the exact
    f64 replay of the candidate blocks on the host (spans/finish.py
    finish_weight_spans), with the candidate blocks the top C missed
    pulled from the device in batches;
  * kmer_low_comp_regions(mode="fast"): one device pipeline over all
    sequences at once, for 2 <= k <= 9 (the class screen of
    spans/pipeline.py: fused at 4 <= k <= 8, non-fused at k = 2, 3 and 9)
    and 10 <= k <= 15 (the exact-mass pm screen, spans/pm_pipeline.py);
    under "host" and "native" mode="fast" runs the exact host path, as in
    the reference;
  * lr_regions: the transition-score caller (spans/tr_pipeline.py), its
    integer screen on the device and the exact f64 replay of its
    candidate blocks on the host;
  * kmer_wide_regions: rank-scored spans at wide k (16 <= k <= 23), the
    wide pm pipeline over all sequences at once, with the sparse spectrum
    counted on the device;
  * window_kmer_dist: windowed k-mer count distributions (ops/window.py,
    parallel/window_stream.py; K3 for the count histogram);
  * kmer_seq, kmers_to_file and read_kmers.

Results carry the reference's fields, equal under every backend: region
positions and f64 scores are exactly the sequential reference's (the
device path replays its candidates on the host from the f64 weights, or
the exact rank chain).

Where the fast device step cannot cover every candidate, the call reruns
it on the same device and counts each rerun in ``exact_fallbacks``: with
twice the candidate capacity, until every candidate block is pulled, or,
at k >= 10 (kmer_wide_regions too), with a list capacity doubled until
the high-count run list fits.  (The reference instead falls through to its
exact path, or at wide k to its CPU oracle; the regions are the same
either way.)  At 10 <= k <= 14 a smallv run-list overflow first retries
once with the packed-key strategy, as the reference does; that retry is
not counted.
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np
import torch

from . import oracle
from .device import resolve_device
from .encoding import MAX_K, PackedSeq, all_kmers, kmer_to_code, pack
from .io.fasta import read_fasta
from .io.spectrum_file import read_kmers as _read_kmers
from .io.spectrum_file import write_kmers
from .models.scoring import (
    Log2MedianScoring,
    RankScoring,
    ScoringModel,
    ThresholdScoring,
    WeightScoring,
)
from .ops.blocked import WIDE_MAX_K
from .ops.pmscreen import pm_params
from .parallel.device import (
    bucket_size,
    device_count_spectrum,
    device_sparse_spectrum,
    device_tr_regions,
    device_window_dist,
    staged_nbases,
)
from .spans.finish import finish_spans, finish_weight_spans
from .spans.pipeline import (
    make_span_pipeline,
    make_weight_span_pipeline,
    quantize_weight_table,
)
from .spans.pm_finish import finish_pm_spans, unpack_pm_outputs
from .spans.pm_pipeline import make_pm_span_pipeline, make_wide_pm_pipeline
from .stats.ranks import SparseRanks, cumulative_mass, spectrum_median_freq
from .utils import metrics, native

#: device reruns after a candidate- or list-capacity overflow, and
#: lr_regions' pull batches beyond the first of each sequence
exact_fallbacks = 0

_REGION_DTYPE = np.dtype(
    [
        ("seq_id", np.int32),
        ("beg", np.int32),
        ("end", np.int32),
        ("score", np.float64),
        ("entropy", np.float64),  # always 0, as in the reference
    ]
)


def _as_region_array(regions) -> np.ndarray:
    out = np.zeros(len(regions), dtype=_REGION_DTYPE)
    for i, (sid, beg, end, score) in enumerate(regions):
        out[i] = (sid, beg, end, score, 0.0)
    return out


def _as_seq_list(seqs) -> list[PackedSeq]:
    if isinstance(seqs, (str, bytes, PackedSeq)):
        seqs = [seqs]
    return [pack(s) for s in seqs]


def _resolve(backend: str, device):
    """(backend, torch.device or None): "auto" (the device path on
    ``device``, which must exist), "host", or "native" (its library must
    load; RuntimeError otherwise), with no device; any other name raises
    ValueError."""
    if backend == "auto":
        return backend, resolve_device(device)
    if backend == "native" and not native.available():
        raise RuntimeError("native backend unavailable (the host library "
                           "did not build or load)")
    if backend == "jax":
        raise ValueError("the port has no 'jax' backend: backend='auto' "
                         "runs the device path on `device`")
    if backend not in ("host", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend, None


def _rank_scoring(cr: KmerCountResult, thr: float,
                  backend: str) -> ScoringModel:
    """RankScoring over a spectrum.  Under "host" the weights are the
    oracle's weighted_ranks (the same chain bit for bit): RankScoring's
    chain takes the host library from 2^20 entries, and the host backend
    loads none."""
    if backend != "host":
        return RankScoring(cr.counts, cr.n, thr)
    if not 0.0 < thr < 1.0:
        raise ValueError("the threshold must be between 0 and 1")
    return ScoringModel(weights=oracle.weighted_ranks(cr.counts, cr.n),
                        threshold=thr)


def _nbases_of(p: PackedSeq) -> np.ndarray:
    nb = p.bases.copy()
    nb[~p.valid] = 4
    return nb


# ---------------------------------------------------------------------------
# Spectrum counting
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KmerCountResult:
    """What kmer_counts returns (the reference's fields)."""

    k: int
    n: float  # total k-mers counted (the reference returns a double)
    counts: np.ndarray  # int64 [4^k]
    f: np.ndarray | None = None  # counts / sum(counts) when with_f


def kmer_counts(seqs, k: int, with_f: bool = True,
                device="cuda", backend: str = "auto") -> KmerCountResult:
    """Dense 4^k spectrum over the combined set of sequences, counted on
    ``device`` or by the host ``backend`` (reference kmer_counts;
    kmer_spans.R:18-27).

    Sequences shorter than k are skipped (src/kmer_spans.c:478-479).
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k should be in [1, {MAX_K}]")
    backend, dev = _resolve(backend, device)
    packed = _as_seq_list(seqs)
    if backend == "auto":
        counts, n = device_count_spectrum(packed, k, dev)
    else:
        counts, n = _host_counts(packed, k, backend)
    f = counts / counts.sum() if with_f and counts.sum() else None
    return KmerCountResult(k=k, n=float(n), counts=counts, f=f)


def _host_counts(packed: list[PackedSeq], k: int, backend: str):
    """The 4^k spectrum by the oracle ("host") or the host library
    ("native"), sequence by sequence: (counts int64, n)."""
    counts = np.zeros(1 << (2 * k), dtype=np.int64)
    n = 0
    for p in packed:
        if p.n < k:
            continue
        if backend == "native":
            c, nw = native.count_spectrum(_nbases_of(p), k)
            counts += c
        else:
            _, nw = oracle.count_spectrum(p, k, counts)
        n += nw
    return counts, n


# ---------------------------------------------------------------------------
# Span calling
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RegionResult:
    """What the span callers return (the reference's fields)."""

    n: np.ndarray  # the reference's n slot (its shape varies by call)
    counts: np.ndarray | None
    regions: np.ndarray  # structured (seq_id, beg, end, score, entropy)
    w_rank: np.ndarray | None = None


def _score_table(k: int, kmer_scores) -> np.ndarray:
    """Resolve scores to a 4^k f64 array in 2-bit index order.

    Accepts a dict {kmer string: score} in any order (the R wrapper's
    name-reorder, kmer_spans.R:44-47) or an array already in 2-bit order.
    """
    size = 1 << (2 * k)
    if isinstance(kmer_scores, dict):
        if len(kmer_scores) != size:
            raise ValueError(f"there should be a total of 4^k ({size}) scores")
        table = np.empty(size, dtype=np.float64)
        seen = np.zeros(size, dtype=bool)
        for kmer, sc in kmer_scores.items():
            if len(kmer) != k:
                raise ValueError(f"k-mer {kmer!r} is not length {k}")
            code = kmer_to_code(kmer)
            table[code] = sc
            seen[code] = True
        if not seen.all():
            raise ValueError("all kmers not defined")
        return table
    table = np.asarray(kmer_scores, dtype=np.float64)
    if table.shape != (size,):
        raise ValueError(f"kmer_scores must have 4^k = {size} entries")
    return table


def _call_regions(
    packed: list[PackedSeq],
    k: int,
    model: ScoringModel,
    min_width: int,
    min_score: float,
    device: torch.device | None,
    want_scan_counts: bool,
    backend: str = "auto",
):
    """The span-calling core of kmer_regions, kmer_low_comp_regions(mode=
    "exact") and kmer_spans: under "auto", one device step per sequence,
    block 4096, C = min(128, blocks) (reference api.py:204-243), its
    candidates replayed on the host; under "host" or "native", the
    sequential caller per sequence.

    Spans (utils/metrics.py) on the device path: ``regions.sequence`` a
    sequence, and inside it ``regions.stage`` (staging and the copy to
    the device), ``regions.step`` (the step's launches or its graph's
    replay; on CUDA its ``device_ms`` from an event pair),
    ``regions.outputs`` (the copy of its outputs to the host, which waits
    for the step) and the finish.

    Returns (regions, scan counts int64 [4^k] or None).
    """
    if backend != "auto":
        return _host_regions(packed, k, model, min_width, min_score,
                             backend, want_scan_counts)
    block = 4096
    size = 1 << (2 * k)
    scan_counts = np.zeros(size, dtype=np.int64) if want_scan_counts else None
    all_regions = []
    w_q, scale = quantize_weight_table(model.weights, model.threshold, block)
    w_q = torch.from_numpy(w_q).to(device)
    for i, p in enumerate(packed):
        if p.n < k:
            continue
        seq = metrics.begin("regions.sequence", seq_id=i, bases=p.n) \
            if metrics.enabled else None
        npad = max(bucket_size(p.n), block)
        fn = make_weight_span_pipeline(
            k, block=block, cand_blocks=min(128, npad // block),
            with_scan_counts=want_scan_counts, device=device)
        sp = metrics.begin("regions.stage") if seq is not None else None
        nbases = torch.from_numpy(staged_nbases(p, npad)).to(device)
        if sp is not None:
            metrics.end(sp)
            sp = metrics.begin("regions.step", device=nbases.device)
        step = fn(nbases, w_q)
        if sp is not None:
            metrics.end(sp)
            sp = metrics.begin("regions.outputs")
        out = {key: v.cpu().numpy() for key, v in step.items()}
        del step
        if sp is not None:
            metrics.end(sp)
        seq_scan = np.zeros(size, np.int64) if want_scan_counts else None
        res = finish_weight_spans(
            out, npad, model.weights, model.threshold, min_width, min_score,
            scale, block=block, seq_id=i, scan_counts=seq_scan,
            pull_fn=fn.pull, nbases_dev=nbases)
        if res.fallback:
            raise AssertionError("the pull path left a candidate block out")
        all_regions.extend(res.regions)
        if want_scan_counts:
            scan_counts += seq_scan
            scan_counts += out["scan_hist"].astype(np.int64)
        if seq is not None:
            metrics.end(seq)
    return all_regions, scan_counts


def _host_regions(packed, k, model, min_width, min_score, backend,
                  want_scan_counts):
    """The sequential caller per sequence (reference api.py:244-273): the
    host library's find_spans ("native") or the oracle ("host")."""
    size = 1 << (2 * k)
    scan_counts = np.zeros(size, dtype=np.int64) if want_scan_counts else None
    all_regions = []
    for i, p in enumerate(packed):
        if p.n < k:
            continue
        if backend == "native":
            beg, end, score, sc = native.find_spans(
                _nbases_of(p), k, model.weights, model.threshold,
                min_width, min_score, want_scan_counts=want_scan_counts)
            all_regions.extend((i, int(b), int(e), float(v))
                               for b, e, v in zip(beg, end, score))
        else:
            sc = np.zeros(size, dtype=np.int64) if want_scan_counts else None
            all_regions.extend(oracle.find_regions(
                p, i, min_width, min_score, model.weights, k,
                model.threshold, scan_counts=sc))
        if want_scan_counts:
            scan_counts += sc
    return all_regions, scan_counts


@metrics.traced("api.kmer_regions")
def kmer_regions(
    seqs, k: int, kmer_scores, min_width: int, min_score: float,
    device="cuda", backend: str = "auto",
) -> RegionResult:
    """Arbitrary-weight span calling (reference kmer_regions_r, :490-546).

    Returns n = total sequence length (of sequences >= k), scan counts
    (k-mers at *scanned* positions, rescans counted again, as the
    reference does), and the regions.
    """
    backend, dev = _resolve(backend, device)
    if k > MAX_K:
        raise ValueError("kmer sizes >= 16 not supported")
    packed = _as_seq_list(seqs)
    model = WeightScoring(_score_table(k, kmer_scores))
    total_len = float(sum(p.n for p in packed if p.n >= k))
    regions, scan_counts = _call_regions(
        packed, k, model, min_width, min_score, dev, want_scan_counts=True,
        backend=backend)
    return RegionResult(
        n=np.array([total_len]),
        counts=scan_counts,
        regions=_as_region_array(regions),
    )


@metrics.traced("api.kmer_low_comp_regions")
def kmer_low_comp_regions(
    seqs, k: int, min_w: int, min_score: float, thr: float = 0.75,
    mode: str = "exact", device="cuda", backend: str = "auto",
) -> RegionResult:
    """Spectrum -> weighted ranks -> rank-scored spans (reference
    kmer_low_comp_regions, src/kmer_spans.c:548-621), on ``device``.

    mode="exact" (the default, as in the reference): the spectrum on the
    device, the reference's sequential f64 rank chain on the host, then
    the weight pipeline one sequence at a time; spans bit-identical to the
    C reference, for 1 <= k <= 15.  mode="fast": the sparse device
    pipeline over all sequences at once (concatenated with N separators),
    exact f64 replay of candidates, for 2 <= k <= 15; k = 1 raises
    ValueError there, since the class table packs 8 ranks a word and 4^1
    fill none (the reference's fast path fails there too).  Under
    backend="host" or "native" both modes run the exact host path, as in
    the reference.
    """
    if mode not in ("exact", "fast"):
        raise ValueError(f"unknown mode {mode!r}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k should be in [1, {MAX_K}]")
    backend, dev = _resolve(backend, device)
    packed = _as_seq_list(seqs)
    if mode == "fast" and backend == "auto":
        if k < 2:
            raise ValueError(
                "mode='fast' needs k >= 2: the class table packs 8 ranks a "
                "word")
        return _low_comp_fast(packed, k, min_w, min_score, thr, dev)
    cr = kmer_counts(packed, k, with_f=False, device=dev, backend=backend)
    model = _rank_scoring(cr, thr, backend)
    regions, _ = _call_regions(packed, k, model, min_w, min_score, dev,
                               want_scan_counts=False, backend=backend)
    return RegionResult(
        n=np.array([cr.n, 0.0]),  # slot 1 is always 0 in the reference
        counts=cr.counts,
        regions=_as_region_array(regions),
        w_rank=model.weights,
    )


@metrics.traced("api.kmer_spans")
def kmer_spans(
    seqs,
    k: int,
    scoring: str = "rank",
    min_width: int = 100,
    min_score: float = 20.0,
    thr: float = 0.75,
    f_t: float | None = None,
    kmer_scores=None,
    device="cuda",
    backend: str = "auto",
) -> RegionResult:
    """Span calling with any of the reference's scoring functions, on
    ``device`` or by the host ``backend``.

    scoring:
      * "rank"        — s = rank_i - thr (the kmer.low.comp.regions model)
      * "threshold"   — s = +1 if f_i >= f_t else -1 (README.md:34-42);
                        f_t defaults to the weighted median frequency
      * "log2_median" — s = log2(f_i / f_med) (README.md:27-32); a
                        zero-count k-mer scores -inf
      * "weights"     — arbitrary caller table (kmer.regions)
    """
    backend, dev = _resolve(backend, device)
    packed = _as_seq_list(seqs)
    if scoring == "weights":
        if kmer_scores is None:
            raise ValueError("scoring='weights' requires kmer_scores")
        return kmer_regions(packed, k, kmer_scores, min_width, min_score,
                            device=dev, backend=backend)
    cr = kmer_counts(packed, k, with_f=False, device=dev, backend=backend)
    if scoring == "rank":
        model = _rank_scoring(cr, thr, backend)
    elif scoring == "threshold":
        if f_t is None:
            f_t = spectrum_median_freq(cr.counts)
        model = ThresholdScoring(cr.counts, f_t)
    elif scoring == "log2_median":
        model = Log2MedianScoring(cr.counts)
    else:
        raise ValueError(f"unknown scoring {scoring!r}")
    regions, _ = _call_regions(packed, k, model, min_width, min_score, dev,
                               want_scan_counts=False, backend=backend)
    return RegionResult(
        n=np.array([cr.n]),
        counts=cr.counts,
        regions=_as_region_array(regions),
        w_rank=model.weights if scoring == "rank" else None,
    )


def kmer_seq(k: int) -> list[str]:
    """All 4^k k-mer strings in 2-bit index order (A, C, T, G)."""
    return all_kmers(k)


# ---------------------------------------------------------------------------
# Spectrum files (reference kmers.to.file / read.kmers, kmer_spans.R:135-186)
# ---------------------------------------------------------------------------

def kmers_to_file(seq_f, out_prefix: str, k, min_l: int = 100_000,
                  device="cuda", backend: str = "auto"):
    """FASTA -> binary spectrum file for each k in ``k`` (scalar or list),
    counted on ``device`` or by the host ``backend``.

    Sequences shorter than min_l are dropped before counting (reference
    default 1e5).  Returns (seq_f, out_f, seq_size, seq_fsize, seq_fl) like
    the reference; out_f is None when reading or filtering fails.
    """
    ks = [int(k)] if np.isscalar(k) else [int(x) for x in k]
    out_f = f"{out_prefix}counts_{'_'.join(str(x) for x in ks)}.bin"
    backend, dev = _resolve(backend, device)
    try:
        records = read_fasta(seq_f)
        seq_size = sum(len(s) for _, s in records)
        kept = [s for _, s in records if len(s) >= min_l]
        seq_fsize = sum(len(s) for s in kept)
        seq_fl = len(kept)
        if not kept:
            raise ValueError("no sequence after length filtering")
        packed = [pack(s) for s in kept]
        counts = [kmer_counts(packed, kk, with_f=False, device=dev,
                              backend=backend).counts for kk in ks]
    except (OSError, ValueError):
        return (seq_f, None, 0, 0, 0)
    write_kmers(out_f, counts)
    return (seq_f, out_f, seq_size, seq_fsize, seq_fl)


def read_kmers(fname):
    """Read a binary spectrum file (magic 310572); None on bad magic."""
    return _read_kmers(fname)


# ---------------------------------------------------------------------------
# Transition-score regions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LrRegionResult:
    kmer_scores: np.ndarray  # [4^k, 2] reordered (seed, transition) tables
    regions: np.ndarray  # structured; score column + null column (entropy)


def lr_regions(
    seqs, params, kmers, kmer_scores, trans_scores, device="cuda",
    backend: str = "auto",
) -> LrRegionResult:
    """Transition-score span calling (reference tr_lr_regions_r, :649-713),
    one sequence at a time on ``device`` (parallel/device.py
    device_tr_regions), or by the oracle under "host" and "native".

    params = (k, min_length).  ``kmers`` gives the order of the score
    tables (any order, e.g. alphabetical); they are reordered to 2-bit
    order by re-encoding each k-mer string, as the reference does
    (:686-694).  Candidate blocks beyond one pull of C are pulled from the
    device in further batches, each counted in ``exact_fallbacks`` (the
    reference serves such a sequence with its CPU oracle instead).
    """
    global exact_fallbacks
    k, min_length = int(params[0]), int(params[1])
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k should be in [1, {MAX_K}]")
    if min_length < 0:
        raise ValueError("min_length should be a positive integer")
    size = 1 << (2 * k)
    kmer_scores = np.asarray(kmer_scores, dtype=np.float64)
    trans_scores = np.asarray(trans_scores, dtype=np.float64)
    if not (len(kmers) == kmer_scores.shape[0] == trans_scores.shape[0]
            == size):
        raise ValueError(
            "kmers, kmer_scores, trans_scores should all be 4^k long")
    ks = np.empty(size, dtype=np.float64)
    ts = np.empty(size, dtype=np.float64)
    for i, kmer in enumerate(kmers):
        code = kmer_to_code(kmer)
        ks[code] = kmer_scores[i]
        ts[code] = trans_scores[i]
    backend, dev = _resolve(backend, device)
    regions = []
    for i, p in enumerate(_as_seq_list(seqs)):
        # reference seq_id starts at 1 here (:699)
        if backend != "auto":
            regions.extend(
                oracle.find_tr_regions(p, i + 1, k, ks, ts, min_length))
            continue
        res = device_tr_regions(p, k, ks, ts, min_length, seq_id=i + 1,
                                device=dev)
        exact_fallbacks += max(res.pull_batches - 1, 0)
        regions.extend(res.regions)
    return LrRegionResult(
        kmer_scores=np.stack([ks, ts], axis=1),
        regions=_as_region_array(regions),
    )


# ---------------------------------------------------------------------------
# Windowed k-mer count distributions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WindowDistResult:
    dist: np.ndarray  # (window+1, kmer_n); frequencies if freq else counts
    seq_i: np.ndarray  # int [n_seqs]; 1 where the sequence was included
    scores: list | None  # per-seq (len, kmer_n) count matrices if ret_flag&1
    kmers: list[str]


@metrics.traced("api.window_kmer_dist")
def window_kmer_dist(
    seqs, kmers, window: int, freq: bool = True, ret_flag: int = 0,
    device="cuda", backend: str = "auto",
) -> WindowDistResult:
    """Sliding-window occurrence distributions (reference :717-793), one
    sequence at a time on ``device`` (parallel/device.py
    device_window_dist, K3 for the count histogram), or by the oracle
    under "host" and "native".

    Sequences with length <= window are skipped and flagged 0 in seq_i.
    Spans (utils/metrics.py): ``window.sequence`` a sequence counted, and
    inside it on the device path ``window.stage``, ``window.chunks`` and
    ``window.pull`` (parallel/window_stream.py).
    """
    kmers = list(kmers)
    klens = {len(x) for x in kmers}
    if len(klens) != 1:
        raise ValueError("all kmers must be of the same size")
    k = klens.pop()
    if k >= 16:
        raise ValueError("kmer sizes >= 16 not supported")
    if window < 2 * k:
        raise ValueError("the window size must be at least two times k")
    backend, dev = _resolve(backend, device)
    tracked = np.array([kmer_to_code(x) for x in kmers], dtype=np.int64)
    packed = _as_seq_list(seqs)
    dist = np.zeros((window + 1, len(kmers)), dtype=np.int64)
    seq_i = np.zeros(len(packed), dtype=np.int64)
    scores = [] if (ret_flag & 1) else None
    for i, p in enumerate(packed):
        if p.n <= window:
            if scores is not None:
                scores.append(None)
            continue
        seq_i[i] = 1
        seq = metrics.begin("window.sequence", seq_id=i, bases=p.n) \
            if metrics.enabled else None
        if backend != "auto":
            cpos = None
            if scores is not None:
                cpos = np.zeros((p.n, len(kmers)), dtype=np.int64)
            oracle.windowed_distributions(p, tracked, k, window, dist, cpos)
        else:
            d, cpos = device_window_dist(p, tracked, k, window,
                                         scores is not None, device=dev)
            dist += d
        if seq is not None:
            metrics.end(seq)
        if scores is not None:
            scores.append(cpos)
    out = dist.astype(np.float64)
    if freq:
        colsum = out.sum(axis=0)
        colsum[colsum == 0] = 1.0
        out = out / colsum
    return WindowDistResult(
        dist=out if freq else dist, seq_i=seq_i, scores=scores, kmers=kmers
    )


# ---------------------------------------------------------------------------
# The fast path (mode="fast")
# ---------------------------------------------------------------------------

def _low_comp_fast(packed, k, min_w, min_score, thr, device, block=8192,
                   cand_blocks=128):
    """The device pipeline over all sequences in one call.

    Sequences >= k concatenate with single-N separators (segments never
    span N, so per-sequence semantics are kept exactly); emitted global
    positions map back to (seq_id, local 1-based) coordinates.
    """
    if not 0.0 < thr < 1.0:
        raise ValueError("the threshold must be between 0 and 1")
    kept = [(i, p) for i, p in enumerate(packed) if p.n >= k]
    if not kept:
        return RegionResult(
            n=np.array([0.0, 0.0]),
            counts=np.zeros(1 << (2 * k), np.int64),
            regions=_as_region_array([]),
            w_rank=np.zeros(1 << (2 * k)),
        )
    arr, offsets = _concatenated(kept, block)
    nbases = torch.from_numpy(arr).to(device)
    run = _pm_regions if k >= 10 else _class_regions
    res, counts, total = run(nbases, arr, k, min_w, min_score, thr, device,
                             block, cand_blocks)
    return RegionResult(
        n=np.array([float(total), 0.0]),
        counts=counts,
        regions=_as_region_array(_per_sequence(res.regions, kept, offsets)),
        w_rank=cumulative_mass(counts).astype(np.float64) / max(total, 1),
    )


def _concatenated(kept, block: int):
    """The kept sequences joined by single-N separators, N-padded to a
    power of two >= 8192 rounded up to a multiple of ``block``: (uint8
    bases with N as 4, the 0-based start of each sequence)."""
    total_len = sum(p.n for _, p in kept) + len(kept) - 1
    npad = max(block, 1 << 13)
    while npad < total_len:
        npad *= 2
    npad = -(-npad // block) * block
    arr = np.full(npad, 4, np.uint8)
    offsets = []  # global 0-based start of each kept sequence
    pos = 0
    for j, (i, p) in enumerate(kept):
        if j:
            pos += 1  # N separator
        offsets.append(pos)
        arr[pos:pos + p.n] = np.where(p.valid, p.bases, 4)
        pos += p.n
    return arr, offsets


def _per_sequence(regions, kept, offsets) -> list:
    """Global regions mapped back to (seq_id, local 1-based) coordinates."""
    out = []
    for _, beg, end, score in regions:
        j = bisect.bisect_right(offsets, beg - 1) - 1
        off = offsets[j]
        out.append((kept[j][0], beg - off, end - off, score))
    return out


def _class_regions(nbases, arr, k, min_w, min_score, thr, device, block,
                   cand_blocks):
    """2 <= k <= 9: the class screen; a missed candidate reruns it with
    twice the capacity (at one candidate per block none can be missed).
    Returns (finished spans, counts int64, total)."""
    global exact_fallbacks
    npad = arr.shape[0]
    nb = npad // block
    cand = min(cand_blocks, nb)
    while True:
        fn = make_span_pipeline(k, block=block, cand_blocks=cand,
                                device=device)
        out = {key: v.cpu().numpy() for key, v in fn(nbases, thr).items()}
        res = finish_spans(out, npad, thr, min_w, min_score, block=block)
        if not res.fallback:
            return res, out["counts"].astype(np.int64), int(out["total"])
        if cand == nb:
            raise AssertionError("every block was pulled, yet a candidate "
                                 "was missed")
        exact_fallbacks += 1
        cand = min(2 * cand, nb)


def _pm_regions(nbases, arr, k, min_w, min_score, thr, device, block,
                cand_blocks):
    """10 <= k <= 15: the pm pipeline (reference api.py:427-453).

    counts come from the host recount, as in the reference: the replay
    needs none, only the result's counts/w_rank fields do.
    Returns (finished spans, counts int64, total).
    """
    res, out = _pm_device_regions(nbases, arr.shape[0], k, min_w, min_score,
                                  thr, device, block, cand_blocks)
    counts, _ = native.host_spectrum(arr, k)
    return res, np.asarray(counts).astype(np.int64), int(out["total"])


def _pm_device_regions(nbases, npad, k, min_w, min_score, thr, device,
                       block, cand_blocks):
    """The pm pipeline, narrow (10 <= k <= 15) or wide (16 <= k <= 23),
    rerun on the same device until it covers every candidate.

    A smallv run-list overflow at k <= 14 retries once with the packed
    key, uncounted (the reference's retry); a list still overflowing
    reruns with its capacity doubled until the true run count fits, a
    missed candidate with twice the candidate capacity, each rerun counted
    in ``exact_fallbacks``.  Returns (finished spans, the decoded dict).
    """
    global exact_fallbacks
    nb = npad // block
    cand = min(cand_blocks, nb)
    strategy, list_cap = None, None
    while True:
        if k > 15:
            fn, meta = make_wide_pm_pipeline(
                k, block=block, cand_blocks=cand, list_cap=list_cap,
                device=device)
        else:
            fn, meta = make_pm_span_pipeline(
                k, block=block, cand_blocks=cand, list_cap=list_cap,
                strategy=strategy, device=device)
        out = unpack_pm_outputs(fn(nbases, thr).cpu().numpy(), npad, meta)
        res = finish_pm_spans(out, npad, meta, thr, min_w, min_score)
        if not res.fallback:
            return res, out
        overflow = out["list_count"] > meta["list_cap"]
        if (overflow and strategy is None and k <= 14
                and pm_params(k, None, n=npad)[0] == "smallv"):
            strategy = "packed"
            continue
        if overflow:
            list_cap = meta["list_cap"]
            while list_cap < out["list_count"]:
                list_cap *= 2
        elif cand == nb:
            raise AssertionError("every block was pulled, yet a candidate "
                                 "was missed")
        else:
            cand = min(2 * cand, nb)
        exact_fallbacks += 1


# ---------------------------------------------------------------------------
# Wide k (16..23)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WideRegionResult:
    """kmer_wide_regions output: regions + the SPARSE spectrum.

    At k >= 16 a dense 4^k counts array cannot exist (the reference's own
    MAX_K tops out below this — SURVEY §2.1 #4), so the spectrum is
    (codes, counts) over distinct k-mers only.
    """

    regions: np.ndarray          # structured (_REGION_DTYPE)
    spectrum_codes: np.ndarray   # int64, distinct codes ascending
    spectrum_counts: np.ndarray  # int64
    n_words: int                 # total counted k-mers


def kmer_wide_regions(
    seqs, k: int, min_w: int, min_score: float, thr: float = 0.75,
    device="cuda", block: int = 8192, cand_blocks: int = 256,
    with_spectrum: bool = True, backend: str = "auto",
) -> WideRegionResult:
    """Rank-scored spans for wide k (16..23), past the reference's MAX_K
    (reference api.kmer_wide_regions; the semantics of
    kmer_low_comp_regions, src/kmer_spans.c:548-621), on ``device``.

    One device step over all sequences at once (concatenated with N
    separators): the wide pm pipeline (spans/pm_pipeline.py
    make_wide_pm_pipeline), whose candidates replay on the host through
    the exact f64 chain from the device's exact rank mass; no spectrum is
    needed for the regions.  A list or candidate overflow reruns on the
    same device, counted in ``exact_fallbacks``; the reference serves it
    with its CPU oracle instead.  with_spectrum=True adds the sparse
    spectrum, counted on the device (parallel/device.py
    device_sparse_spectrum) and checked against the device total;
    otherwise the spectrum fields are empty and n_words is the device
    total.

    Under backend="host" or "native" the sequential oracle calls the
    concatenated sequences over a SparseRanks lookup of the sparse
    spectrum (counted by the oracle, or by the host library's
    host_spectrum_sparse), as the reference's CPU path does; the spectrum
    is then always returned.
    """
    if not 16 <= k <= WIDE_MAX_K:
        raise ValueError(f"kmer_wide_regions needs 16 <= k <= {WIDE_MAX_K}")
    if not 0.0 < thr < 1.0:
        raise ValueError("the threshold must be between 0 and 1")
    backend, dev = _resolve(backend, device)
    kept = [(i, p) for i, p in enumerate(_as_seq_list(seqs)) if p.n >= k]
    empty = np.zeros(0, np.int64)
    if not kept:
        return WideRegionResult(_as_region_array([]), empty, empty, 0)
    arr, offsets = _concatenated(kept, block)
    if backend != "auto":
        cat = PackedSeq(bases=arr & 3, valid=arr < 4)
        if backend == "native":
            ucodes, ucounts, n_words = native.host_spectrum_sparse(arr, k)
        else:
            ucodes, ucounts, n_words = oracle.count_spectrum_sparse(cat, k)
        regions = oracle.find_regions(cat, 0, min_w, min_score,
                                      SparseRanks(ucodes, ucounts), k, thr)
        return WideRegionResult(
            _as_region_array(_per_sequence(regions, kept, offsets)),
            ucodes, ucounts, n_words)
    nbases = torch.from_numpy(arr).to(dev)
    res, out = _pm_device_regions(nbases, arr.shape[0], k, min_w, min_score,
                                  thr, dev, block, cand_blocks)
    ucodes = ucounts = empty
    n_words = out["total"]
    if with_spectrum:
        ucodes, ucounts, n_words = device_sparse_spectrum(nbases, k, dev)
        if n_words != out["total"]:
            raise AssertionError(f"device total {out['total']} != sparse "
                                 f"spectrum total {n_words}")
    return WideRegionResult(
        _as_region_array(_per_sequence(res.regions, kept, offsets)),
        ucodes, ucounts, n_words)
