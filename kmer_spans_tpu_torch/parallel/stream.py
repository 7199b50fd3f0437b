"""Streaming span pipeline: genomes of any size through fixed-size chunks.

Counterpart of ``kmer_spans_tpu/parallel/stream.py`` on one device.  Two
passes over the same chunks:

  * count: each chunk's rolling codes (with the previous chunk's k-1
    bases as halo) counted by K3 (ops/histogram.py count_spectrum) and
    added into one int64 [4^k] device accumulator; the spectrum is pulled
    once, and the exact int64 rank mass and the reference's f64 rank chain
    are made on the host (finish_rank);
  * scan: each chunk screened against the global spectrum through a
    quantized table, in one of four branches:
      - 4 <= k <= 8 with block >= 1024: K2 (ops/screen_scan.py) on the aug
        words, whose scored bits see the chunk's lookahead byte;
      - the other k <= 9: K4 (ops/gather.py word_gather), then the
        integer block summaries;
      - k >= 10: the uint8 row table (ops/rowgather.py), then the
        summaries;
      - any ScoringModel: the affine row table, then the summaries;
    the summaries compose exactly in int64, seeded by the chunk's
    incoming carry, to order the top C candidate blocks (the reference's
    f32 composition cancels at genome scale); the candidate rows and the
    first and last ``margin_blocks`` blocks leave the device as packed
    2-bit bases and scored bits (spans/pipeline.py pack_candidates), with
    the summaries, in one pull a chunk.

The host finish (``_finish_chunk``) is a copy of the reference's: exact
int64 composition with the carry, run-aware candidacy, exact f64 replay
from the reference's rank chain or the model's weights, and the stitching
of excursions across chunk edges from the pulled margins.  It differs in
one place: candidate blocks that the top C missed are pulled from the
card in batches of C (ops/blocked.py block_rows_codes over the chunk with
its halo and lookahead byte, counted in ``pull_batches``), where the
reference reports "candidate capacity overflow" in ``unresolved``.  A
straddling excursion longer than the margins stays in ``unresolved``
with the reference's reasons.

Each chunk's bytes travel with its halo and its successor's first byte in
one pinned host buffer, copied ``non_blocking`` on a side CUDA stream one
chunk ahead of the compute (an event orders the two).  The reference's
2-bit H2D packing and its two-deep prefetch served a slow TPU host link
and are not ported; nor is its (hi, lo) int32 accumulator (the port
carries int64).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

from ..device import resolve_device
from ..encoding import MAX_K
from ..io.checkpoint import StreamCheckpoint
from ..ops import gather, histogram, screen_scan
from ..ops.blocked import (
    block_rows_codes,
    blocked_codes,
    blocked_scan_summaries_int,
    blocked_scored,
)
from ..ops.gather import CLASS_BITS, SCREEN_SCALE, screen_thr_q
from ..ops.rowgather import (
    host_row_table,
    host_row_table_weights,
    row_screen_scores,
    row_screen_scores_affine,
)
from ..ops.screen_scan import MAX_BLOCK
from ..spans.extract import extract_spans
from ..spans.finish import compose_summaries_exact, host_rank_chain, \
    rebuild_codes
from ..spans.pipeline import _top_blocks, aug_words, pack_candidates
from ..stats.ranks import cumulative_mass
from ..utils import native

#: the class screens' range (a 4^k/8-word table for K4 and K2)
CLASS_MAX_K = 9
#: K2's range (16-bit codes in the aug words)
FUSED_MAX_K = 8

#: the stream's sequential sums (``_first_nonpositive``): chunks of up to
#: _CHUNK elements, the first _FIRST_CHUNK long and doubled from there,
#: since most excursions close within it
_CHUNK = 4096
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


def _segment_sums(w: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """Strictly sequential f64 sums of ``w`` over the stretches
    [starts[i], starts[i] + lens[i]), each from 0.

    ``starts`` is sorted.  Returns first: first[i] is the offset of the
    stretch's first sum <= 0 (lens[i] when there is none).
    ``np.add.accumulate`` adds left to right along a row, so each
    stretch's sums are the fold's own.  The stretches go in rows of one
    block (of one power-of-four width each where one block would waste
    too much), one accumulate a block, every row closed by a -inf just
    past its stretch: its first sum <= 0 is then always in the row.
    """
    first = lens.copy()
    if not lens.size:
        return first
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
        g = rows_of[starts[r], : width + 1]
        g[np.arange(ln.shape[0]), ln] = -np.inf
        acc = np.add.accumulate(g, axis=1, out=g)
        first[r] = (acc <= 0).argmax(axis=1)
    return first


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
    first = _segment_sums(w, starts, lens)
    bad = np.nonzero(first != lens - 1)[0]
    if not bad.size:
        return ends.size, None
    i = int(bad[0])
    return i, (int(starts[i] + first[i]) if first[i] < lens[i] else None)


def tail_close(tail_s: np.ndarray, tail_sc: np.ndarray, x0_ub: float,
               bound_zero: np.ndarray) -> int | None:
    """The last position of the tail margin where the true S is provably 0:
    its index, -1 for the position just before the margin, or None.

    tail_s, tail_sc: the margin's true f64 scores and scored bits; x0_ub:
    an upper bound of S entering the margin (the composed integer bound
    over the screen's scale); bound_zero: True at the margin's block ends
    whose composed integer bound is <= 0.

    The vectorized bound ``max(P + x0_ub, P - min(0, min P))`` over
    ``np.cumsum`` picks the closes, but its differences of prefixes can
    round to 0 where the sequential fold stays marginally positive (or
    the other way).  So the last close c is confirmed by the reference's
    own fold, strictly sequential f64 sums from the last exact anchor at
    or before c: an unscored reset or a zero of the integer bound (the
    entry itself when x0_ub is 0; else the fold starts from x0_ub, which
    bounds S from above and meets the true S at its first zero).  The
    bound's closes after the anchor are taken as the fold's zeros and
    checked all at once (``_segment_check``: the sums that
    ``_first_nonpositive`` takes, for many excursions in one accumulate,
    where one call an excursion walks a margin of short excursions far
    slower); where one is not, the fold goes on past it,
    and a zero the bound missed restarts the check.  The answer is c
    where it holds, else the last zero the fold confirms, else the
    anchor.
    """
    n = tail_s.shape[0]
    P = np.cumsum(tail_s)
    Mn = np.minimum.accumulate(np.minimum(P, 0.0))
    closed = np.nonzero((np.maximum(P + x0_ub, P - Mn) <= 0) | ~tail_sc)[0]
    c = int(closed[-1]) if closed.size else n - 1
    exact = np.nonzero(~tail_sc[:c + 1] | bound_zero[:c + 1])[0]
    a = int(exact[-1]) if exact.size else -1
    if a == c:
        return c
    # w[j] is the tail's position a + j; w[0] the fold's state at a
    init = x0_ub if a < 0 else 0.0
    w = np.concatenate(([init], tail_s[a + 1:c + 1]))
    last, lo = (None, 0) if init > 0 else (0, 1)
    ends = closed[closed > a] - a
    if ends.size == 0 or ends[-1] != c - a:
        ends = np.append(ends, c - a)
    while ends.size:
        i, j = _segment_check(w, lo, ends)
        if i == ends.size:
            return a + int(ends[-1])
        if i:
            last, lo = int(ends[i - 1]), int(ends[i - 1]) + 1
        if j is None:  # no zero at ends[i]: the fold goes on past it
            ends = ends[i + 1:]
        else:          # a zero before ends[i]
            last, lo, ends = j, j + 1, ends[i:]
    return None if last is None else a + last


@dataclasses.dataclass
class StreamResult:
    regions: list  # (seq_id, beg, end, score) global 1-based coords
    n_kmers: int
    unresolved: list  # (chunk_idx, reason) windows needing exact rerun
    counts_host: object  # int64 np spectrum (None until finish_rank ran)


def host_class_words(mass: np.ndarray, total: int) -> np.ndarray:
    """Packed 4-bit class table from int64 mass, on the host.

    Bit-identical to ops.gather.class_table_from_mass (the same f32 IEEE
    operations), so the screen's soundness slack applies unchanged.
    """
    rank = mass.astype(np.float32) / np.float32(max(total, 1))
    cls = np.clip((rank * 16).astype(np.int32), 0, 15)
    w = cls.reshape(-1, 8)
    shifts = (np.arange(8, dtype=np.int32) * 4)
    return np.bitwise_or.reduce(w << shifts[None, :], axis=1).astype(
        np.int32)


def host_fine_table(mass: np.ndarray, total: int) -> np.ndarray:
    """int16 4096-level class table from int64 mass, on the host
    (== ops.gather.fine_class_table)."""
    rank = mass.astype(np.float32) / np.float32(max(total, 1))
    return (
        np.clip((rank * SCREEN_SCALE).astype(np.int32), 0, SCREEN_SCALE) + 1
    ).astype(np.int16)


class _Stager:
    """Chunks to the device, one ahead of the compute.

    A chunk's bytes, its k-1 halo and its successor's first byte go into
    one of two pinned host buffers and travel with one non_blocking copy
    on a side stream into the device buffer of the same slot; the compute
    stream waits on the copy's event.  A slot is refilled only after the
    compute of the chunk that last held it (``done``), so at most two
    chunks are staged at once.  On the CPU a chunk is its own buffer.
    """

    def __init__(self, n: int, device: torch.device):
        self.device = device
        self.turn = 0
        if device.type == "cuda":
            self.host = [torch.empty(n, dtype=torch.uint8, pin_memory=True)
                         for _ in range(2)]
            self.dev = [torch.empty(n, dtype=torch.uint8, device=device)
                        for _ in range(2)]
            self.copied = [torch.cuda.Event() for _ in range(2)]
            self.used = [None, None]
            self.stream = torch.cuda.Stream(device)

    def put(self, parts) -> int | torch.Tensor:
        """Start staging the concatenation of ``parts`` (uint8 arrays);
        returns the handle that ``take`` turns into the device buffer."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.concatenate(parts))
        i = self.turn
        self.turn ^= 1
        if self.used[i] is not None:
            self.used[i].synchronize()
        np.concatenate(parts, out=self.host[i].numpy())
        with torch.cuda.stream(self.stream):
            self.dev[i].copy_(self.host[i], non_blocking=True)
            self.copied[i].record(self.stream)
        return i

    def take(self, handle) -> torch.Tensor:
        if self.device.type != "cuda":
            return handle
        torch.cuda.current_stream(self.device).wait_event(self.copied[handle])
        return self.dev[handle]

    def done(self, handle) -> None:
        """The compute stream has queued its last use of the slot."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.used[handle] = ev


class _Clock:
    """Device time of a chunk's stages by CUDA events (``chunk_times``)."""

    def __init__(self, on: bool):
        self.marks = [] if on else None
        self.mark("start")

    def mark(self, name: str) -> None:
        if self.marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))

    def read(self, **extra) -> dict | None:
        if self.marks is None:
            return None
        self.marks[-1][1].synchronize()
        out = {name: a.elapsed_time(b) for (_, a), (name, b)
               in zip(self.marks, self.marks[1:])}
        out.update(extra)
        return out


class StreamingSpanPipeline:
    """count -> rank -> scan over fixed-size chunks with exact stitching.

    ``pull_batches`` counts the device gathers of candidate blocks that
    the top C missed; ``chunk_times``, when set to a list, receives each
    chunk's device stage times in ms (CUDA events; on the card only).
    """

    def __init__(
        self,
        k: int,
        chunk_bases: int = 1 << 25,
        block: int = 8192,
        cand_blocks: int = 128,
        margin_blocks: int = 16,
        device="cuda",
    ):
        if not 1 <= k <= MAX_K:
            raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
        if chunk_bases % block:
            raise ValueError("chunk_bases must be a multiple of block")
        if block % 32:
            raise ValueError(f"block={block}: the payload packs the scored "
                             "flags 32 a word")
        if margin_blocks < 1:
            raise ValueError("margin_blocks must be at least 1")
        nb = chunk_bases // block
        self.k = k
        self.block = block
        self.chunk = chunk_bases
        self.cand = cand_blocks
        self.margin = min(margin_blocks, nb)  # a margin is at most a chunk
        self.device = resolve_device(device)
        self._use_class = k <= CLASS_MAX_K
        self._use_fused = (self._use_class and 4 <= k <= FUSED_MAX_K
                           and block >= 1024)
        if self._use_fused and (block % 256 or block > MAX_BLOCK):
            raise NotImplementedError(
                f"block={block}: the fused screen kernel takes multiples of "
                f"256 up to {MAX_BLOCK}")
        self._size = 1 << (2 * k)
        self._nb = nb
        self._C = min(cand_blocks, nb)
        self._stager = None
        self.pull_batches = 0
        self.chunk_times = None

    # ------------------------------------------------------------ chunks
    def _stage(self, arr: np.ndarray, halo: np.ndarray, next_byte: int):
        if self._stager is None:
            self._stager = _Stager(self.chunk + self.k, self.device)
        return self._stager.put(
            (arr, halo, np.array([next_byte], np.uint8)))

    def _views(self, buf: torch.Tensor):
        """(chunk bytes, halo bytes, lookahead byte) of a staged buffer."""
        c, h = self.chunk, self.k - 1
        return buf[:c], buf[c:c + h], buf[c + h]

    def _codes(self, x, halo):
        nb, block = self._nb, self.block
        v2 = (x < 4).reshape(nb, block)
        codes, kv = blocked_codes((x & 3).reshape(nb, block), v2, self.k,
                                  first_bases=halo & 3,
                                  first_valid=halo < 4)
        return v2, codes, kv

    def _clock(self) -> _Clock:
        return _Clock(self.chunk_times is not None
                      and self.device.type == "cuda")

    # -------------------------------------------------------------- count
    def run(self, chunk_iter_factory, thr, min_width, min_score,
            seq_id: int = 0, checkpoint_path: str | None = None,
            resume: bool = False, metrics=None,
            stop_after_chunk: int | None = None,
            scoring=None) -> StreamResult:
        """Run the two-pass pipeline.

        chunk_iter_factory: zero-arg callable returning an iterator of
        uint8 numpy arrays (nbases; N encoded as 4), each exactly
        chunk_bases long except the last (which is padded with N here).
        The factory is called twice (count pass, scan pass).

        scoring: optional callable (counts int64 [4^k], total) ->
        ScoringModel: stream under any of the scoring variants
        (models/scoring.py) instead of rank scoring; ``thr`` is then
        unused (the model carries its own threshold).

        checkpoint_path: if set, the scan pass saves a StreamCheckpoint
        after every chunk; with resume=True and an existing checkpoint,
        the scan pass restarts after the last completed chunk.
        metrics: optional utils.metrics.Metrics recorder.
        """

        def _phase(name, bases=0, **kw):
            if metrics is None:
                return contextlib.nullcontext()
            return metrics.phase(name, bases=bases, **kw)

        with _phase("count"):
            acc = self.accumulate_counts(chunk_iter_factory)
        with _phase("rank"):
            mass, total = self.finish_rank(acc)
            model = scoring(self._counts_host, total) if scoring else None
        return self.scan_stream(
            chunk_iter_factory, mass, total, thr, min_width, min_score,
            seq_id=seq_id, checkpoint_path=checkpoint_path, resume=resume,
            metrics=metrics, stop_after_chunk=stop_after_chunk,
            counts_host=self._counts_host, model=model,
        )

    def accumulate_counts(self, chunk_iter_factory, acc=None):
        """Count pass over one stream into an int64 [4^k] device tensor;
        pass ``acc`` to accumulate several streams into one spectrum (the
        reference counts across all sequences before scanning any,
        src/kmer_spans.c:592-601)."""
        h = self.k - 1
        if acc is None:
            acc = torch.zeros(self._size, dtype=torch.int64,
                              device=self.device)
        halo = np.full(h, 4, np.uint8)  # N: the stream start has no halo
        it = iter(chunk_iter_factory())
        arr = next(it, None)
        handle = None if arr is None else self._stage(self._pad(arr), halo, 4)
        while handle is not None:
            arr = self._pad(arr)
            clock = self._clock()
            x, halo_dev, _ = self._views(self._stager.take(handle))
            _, codes, kv = self._codes(x, halo_dev)
            clock.mark("codes")
            part = histogram.count_spectrum(codes.reshape(-1),
                                            kv.reshape(-1), self.k)
            clock.mark("K3")
            acc += part
            clock.mark("accumulate")
            self._stager.done(handle)
            del codes, kv, part
            if h:
                halo = arr[-h:]
            arr = next(it, None)
            handle = (None if arr is None
                      else self._stage(self._pad(arr), halo, 4))
            times = clock.read(phase="count")
            if times is not None:
                self.chunk_times.append(times)
        # finish the queued chunks inside this pass (a metrics phase
        # around it then holds their device time)
        acc[:1].cpu()
        return acc

    def finish_rank(self, acc):
        """Exact int64 rank mass from the accumulated device spectrum.

        Pulls the spectrum once per genome and computes the exact integer
        cumulative mass on the host: the analog of the reference's f64
        rank chain (src/kmer_spans.c:198-200), exact at any genome size.
        Returns (mass int64 np [4^k], total int).
        """
        counts = acc.cpu().numpy().astype(np.int64)
        self._counts_host = counts
        return cumulative_mass(counts), int(counts.sum())

    # --------------------------------------------------------------- scan
    def _screen_table(self, mass: np.ndarray, total: int) -> torch.Tensor:
        if self._use_class:
            if self.k < 2:
                raise ValueError("the class screen packs 8 ranks a word: "
                                 "k = 1 streams only with a scoring model")
            tab = host_class_words(mass, total)
        else:
            tab = host_row_table(mass, total)
        return torch.from_numpy(tab).to(self.device)

    def _scan_device(self, buf, screen, x_in: int, clock: _Clock):
        """One chunk's device work: codes, screen, summaries, top C and
        the packed summary + payload vector (int32, on the device).

        screen: (class words, thr_q) for K2, else a function from the
        codes [nb, block] to the integer scores."""
        nb, block, m = self._nb, self.block, self.margin
        x, halo, nxt = self._views(buf)
        fused = isinstance(screen, tuple)
        if fused:
            aug, scored = aug_words(x, self.k, block, halo & 3, halo < 4,
                                    nxt < 4)
            clock.mark("codes")
            words, thr_q = screen
            tA, tB, maxA, maxB = screen_scan.fused_screen_scan(
                words, aug.reshape(-1), thr_q, CLASS_BITS, block)
            codes = aug
        else:
            v2, codes, kv = self._codes(x, halo)
            scored = blocked_scored(v2, kv, next_valid=nxt < 4)
            del v2, kv
            clock.mark("codes")
            s_int = screen(codes)
            tA, tB, maxA, maxB = blocked_scan_summaries_int(s_int, scored)
            del s_int
        clock.mark("screen")
        top_idx = _top_blocks(tA, tB, maxA, maxB, self._C, x_in)
        clock.mark("top C")
        parts = [tA, tB, maxA, maxB, top_idx.to(torch.int32)]
        rows = torch.arange(nb, device=x.device)
        for sel in (top_idx, rows[:m], rows[nb - m:]):
            c = codes[sel]
            if fused:
                c &= 0xFFFF
            sc_words, cand_words = pack_candidates(scored[sel], c)
            parts += [cand_words, sc_words]
        return torch.cat(parts)

    def _unpack_summary(self, v):
        nb, C = self._nb, self._C
        tA, tB, maxA, maxB = (v[i * nb:(i + 1) * nb] for i in range(4))
        top_idx = v[4 * nb:4 * nb + C]
        return tA, tB, maxA, maxB, top_idx

    def _unpack_payload(self, vec, ranks, thr):
        """Decode packed codes/bits; candidates stay as packed words
        (decoded per stretch by the host library's packed replay);
        margins (small) decode to s/scored eagerly.

        ranks: the reference's f64 sequential rank chain (or a model's
        weights): replayed scores are bit-identical to the C reference
        (src/kmer_spans.c:198-200, :268)."""
        v = np.asarray(vec)
        block, C, m = self.block, self._C, self.margin
        k = self.k
        cw = 1 + block // 16
        off = 0

        def words_of(rows):
            nonlocal off
            w = v[off:off + rows * cw].copy().view(np.uint32).reshape(
                rows, cw)
            off += rows * cw
            return w

        def bits_of(rows):
            nonlocal off
            w = v[off:off + rows * (block // 32)].copy().view(np.uint32)
            off += rows * (block // 32)
            return ((w[:, None] >> np.arange(32, dtype=np.uint32)) & 1
                    ).astype(bool).reshape(rows, block)

        def s_of(words, sc):
            codes = rebuild_codes(words, k, block)
            return np.where(sc, ranks[codes] - thr, 0.0)

        w_cand = words_of(C)
        sc_cand = bits_of(C)
        w_head = words_of(m)
        sc_head = bits_of(m)
        w_tail = words_of(m)
        sc_tail = bits_of(m)
        assert off == v.shape[0], (off, v.shape)
        return {
            "w_cand": w_cand, "sc_cand": sc_cand,
            "s_head": s_of(w_head, sc_head).reshape(-1),
            "sc_head": sc_head.reshape(-1),
            "s_tail": s_of(w_tail, sc_tail).reshape(-1),
            "sc_tail": sc_tail.reshape(-1),
        }

    def scan_stream(self, chunk_iter_factory, mass, total, thr,
                    min_width, min_score, seq_id=0, checkpoint_path=None,
                    resume=False, metrics=None, stop_after_chunk=None,
                    counts_host=None, model=None) -> StreamResult:
        """Scan pass over one stream with a (possibly shared) rank table.

        mass: int64 np array (finish_rank); total: int k-mer count.

        model: optional ScoringModel (models/scoring.py): streams spans
        under arbitrary weights, frequency-threshold or log2-median
        scoring instead of rank scoring.  The screen quantizes the model
        to a 256-level row table with an affine integer decode
        (ops/rowgather.host_row_table_weights); the exact f64 replay reads
        the model's weights directly, so emitted scores keep the
        sequential-f64 invariant for every scoring.
        """
        dev = self.device
        nb, h = self._nb, self.k - 1
        if counts_host is None:
            counts_host = getattr(self, "_counts_host", None)
        if counts_host is None:
            raise ValueError(
                "scan_stream needs the host spectrum for bit-identical "
                "replay: run finish_rank first or pass counts_host"
            )
        if model is None:
            tab = self._screen_table(np.asarray(mass, dtype=np.int64), total)
            thr_q = screen_thr_q(torch.tensor(thr, dtype=torch.float32,
                                              device=dev))
            ranks = host_rank_chain(counts_host, total)
            score_thr = thr
            scale = float(SCREEN_SCALE)
            if self._use_fused:
                screen = (tab, thr_q)
            elif self._use_class:
                def screen(codes):
                    return gather.word_gather(tab, codes, thr_q)
            else:
                def screen(codes):
                    return row_screen_scores(tab, codes.reshape(-1),
                                             thr_q).reshape(nb, self.block)
        else:
            tab_np, step, off, scale = host_row_table_weights(
                model.weights, model.threshold, self.block)
            tab = torch.from_numpy(tab_np).to(dev)
            ranks = np.asarray(model.weights, dtype=np.float64)
            score_thr = float(model.threshold)

            def screen(codes):
                return row_screen_scores_affine(
                    tab, codes.reshape(-1), step, off).reshape(nb, self.block)

        regions: list = []
        unresolved: list = []
        x_in = np.int64(0)  # exact composed screen bound entering the chunk
        halo = np.full(h, 4, np.uint8)

        # host-side stitching state: open excursion s-values at boundary
        open_s: np.ndarray | None = None
        open_scored: np.ndarray | None = None
        open_start: int = 0  # global 0-based position of open_s[0]
        start_chunk = 0

        if checkpoint_path and resume and os.path.exists(checkpoint_path):
            ck = StreamCheckpoint.load(checkpoint_path)
            start_chunk = ck.chunk_idx + 1
            x_in = np.int64(ck.x_in)
            if h:
                halo = np.frombuffer(ck.halo_bytes, dtype=np.uint8)
            open_s, open_scored = ck.open_s, ck.open_scored
            open_start = ck.open_start
            regions = list(ck.regions)

        chunks = list(chunk_iter_factory())
        last = len(chunks) - 1
        if stop_after_chunk is not None:
            last_run = min(last, stop_after_chunk)
        else:
            last_run = last

        def stage(ci, halo):
            nxt = chunks[ci + 1][0] if ci < last else 4
            return self._stage(self._pad(chunks[ci]), halo, int(nxt))

        base = start_chunk * self.chunk
        handle = stage(start_chunk, halo) if start_chunk <= last_run else None
        for ci in range(start_chunk, last_run + 1):
            arr = self._pad(chunks[ci])
            is_last = ci == last
            t0 = time.perf_counter()
            clock = self._clock()
            buf = self._stager.take(handle)
            vec = self._scan_device(buf, screen, int(x_in), clock)
            cur = handle
            if ci < last_run:  # the next chunk's copy runs under this one
                handle = stage(ci + 1, arr[-h:] if h else halo)
            host = vec.cpu().numpy()
            clock.mark("payload pull")
            split = 4 * nb + self._C
            tA, tB, maxA, maxB, top_idx = self._unpack_summary(
                host[:split])
            x_dev, halo_dev, nxt_dev = self._views(buf)

            def pull(idx, x_dev=x_dev, halo_dev=halo_dev,
                     nxt_dev=nxt_dev):
                return block_rows_codes(
                    x_dev, torch.from_numpy(idx).to(dev), self.k,
                    self.block, first=halo_dev, next_byte=nxt_dev)

            t1 = time.perf_counter()
            res, open_next, x_in = self._finish_chunk(
                tA, tB, maxA, maxB, top_idx, host[split:], x_in,
                base, score_thr, ranks, min_width, min_score, seq_id,
                open_s, open_scored, open_start, unresolved, ci, pull,
                is_last=is_last, scale=scale,
            )
            self._stager.done(cur)
            times = clock.read(
                phase="scan", **{"host finish":
                                 (time.perf_counter() - t1) * 1e3})
            if times is not None:
                self.chunk_times.append(times)
            regions.extend(res)
            open_s, open_scored, open_start = open_next
            base += arr.shape[0]
            if metrics is not None:
                metrics.record(
                    "scan_chunk", time.perf_counter() - t0,
                    bases=arr.shape[0], chunk=ci, regions=len(regions),
                )
            if checkpoint_path:
                StreamCheckpoint(
                    chunk_idx=ci,
                    x_in=int(x_in),
                    halo_bytes=(arr[-h:].tobytes() if h else b""),
                    open_start=open_start,
                    open_s=open_s,
                    open_scored=open_scored,
                    regions=regions,
                ).save(checkpoint_path)

        # genome end: terminal semantics were already applied inside the
        # final chunk (its lookahead byte is N)
        return StreamResult(
            regions=regions, n_kmers=total, unresolved=unresolved,
            counts_host=counts_host,
        )

    def _pad(self, arr: np.ndarray) -> np.ndarray:
        n = arr.shape[0]
        if n == self.chunk:
            return arr
        if n > self.chunk:
            raise ValueError("chunk longer than configured chunk_bases")
        out = np.full(self.chunk, 4, np.uint8)
        out[:n] = arr
        return out

    def _pull_missing(self, pull, missing: np.ndarray) -> dict:
        """Codes and scored rows of the candidate blocks the top C missed,
        gathered on the device in batches of C (fixed shapes)."""
        C = self._C
        pulled = {}
        for s in range(0, missing.size, C):
            batch = missing[s:s + C]
            idxp = np.full(C, batch[0], np.int64)
            idxp[:batch.size] = batch
            codes, scored = (t.cpu().numpy() for t in pull(idxp))
            self.pull_batches += 1
            for j, b in enumerate(batch):
                pulled[int(b)] = (codes[j], scored[j])
        return pulled

    def _finish_chunk(self, tA, tB, maxA, maxB, top_idx, payload, x_in,
                      base, thr, ranks, min_width, min_score,
                      seq_id, open_s, open_scored, open_start,
                      unresolved, ci, pull, is_last=False,
                      scale=float(SCREEN_SCALE)):
        """Extract this chunk's spans + stitch the boundary excursion.

        All screening is exact: int64 composition of the integer block
        summaries, carry included.  Ownership protocol (prevents double
        emission):
          * the boundary replay owns the whole excursion that straddles
            the incoming chunk edge, all its regions on both sides, up to
            its exact end E;
          * the in-chunk pass owns (E, next_open_start): candidate stretch
            positions outside that window are masked unscored;
          * the excursion open at the outgoing edge (start found from the
            exact block_last chain) is handed to the next chunk.
        Candidate blocks the top C missed come from ``pull`` (an int64
        [C] numpy array of block indices -> their codes and scored rows
        on the device).
        """
        block, nb, m = self.block, self._nb, self.margin
        pl = self._unpack_payload(payload, ranks, thr)

        block_max, block_last = compose_summaries_exact(
            tA, tB, maxA, maxB, x0=int(x_in))
        # exact run-aware candidacy (see spans/finish.finish_spans)
        linked = np.zeros(nb, bool)
        linked[0] = x_in > 0
        linked[1:] = block_last[:-1] > 0
        seg_start = ~linked
        seg_start[0] = True
        starts = np.nonzero(seg_start)[0]
        run_of = np.cumsum(seg_start) - 1
        run_max = np.maximum.reduceat(block_max, starts)[run_of]
        cand = run_max >= float(min_score) * scale
        have = np.zeros(nb, bool)
        have[top_idx] = True
        pos_in_pull = {int(b): i for i, b in enumerate(top_idx)}
        w_cand = pl["w_cand"]
        sc_cand = pl["sc_cand"]

        regions = []

        # --- A. outgoing open excursion (start located via block_last) ---
        # The screen's identity-at-unscored semantics make block_last an
        # over-approximation (it can stay positive across N gaps); the
        # host resolves that here with the true reset rule: an unscored
        # position provably has true S = 0, as does any position whose
        # no-reset upper-bound S is <= 0.  Never runs on the final chunk:
        # there is no next chunk, and the in-chunk pass owns terminal
        # emissions (reference sequence-end semantics, src/kmer_spans.c:
        # 298-305, live in extract_spans).
        open_next = (None, None, 0)
        clip_from_global = None  # in-chunk pass must not extract past this
        x_out = np.int64(block_last[-1]) if block_last[-1] > 0 else np.int64(0)
        if block_last[-1] > 0 and not is_last:
            # Locate the last position in the tail margin where true S = 0
            # provably (tail_close), from the margin's true s-values and
            # the composed integer bound entering the margin and at its
            # block ends (block_last >= scale * S_true always).
            tail_s = pl["s_tail"]
            tail_sc = pl["sc_tail"]
            x0_ub = (float(max(int(block_last[nb - m - 1]), 0)) / scale
                     if nb > m else float(max(int(x_in), 0)) / scale)
            bound_zero = np.zeros(tail_s.shape[0], bool)
            bound_zero[block - 1::block] = block_last[nb - m:] <= 0
            close = tail_close(tail_s, tail_sc, x0_ub, bound_zero)
            if close is None:
                unresolved.append(
                    (ci, "open excursion exceeds tail margin"))
            else:
                start_rel = close + 1
                if start_rel < tail_s.shape[0]:
                    # else the edge position itself is provably closed: the
                    # chunk ends with true S = 0, nothing to hand off
                    open_next = (
                        tail_s[start_rel:],
                        tail_sc[start_rel:],
                        base + (nb - m) * block + start_rel,
                    )
                    clip_from_global = open_next[2]

        # --- B. incoming boundary excursion: owned here entirely ----------
        # The boundary pass owns the whole handed window [open_start,
        # base) plus its continuation into the head margin, up to the
        # first true close (S = 0 or unscored reset) at or after the edge.
        # The replay here is the true scan (true S = 0 at open_start - 1
        # by the handoff invariant), so interior closes/reopens replay
        # exactly and extract_spans emits every region inside the owned
        # window.
        boundary_done_global = base - 1  # in-chunk pass starts after this
        if open_s is not None:
            joined_s = np.concatenate([open_s, pl["s_head"]])
            joined_sc = np.concatenate([open_scored, pl["sc_head"]])
            hd0 = int(base - open_start)  # joined index of chunk start
            # exact close search, excursion by excursion, with
            # _first_nonpositive's strictly sequential f64 sums (the
            # reference's own rounding order).  An unscored position is a
            # forced close.
            nj = joined_s.shape[0]
            unsc = np.nonzero(~joined_sc)[0]
            z_close = None
            u = 0
            while u < nj:
                if not joined_sc[u]:
                    if u >= hd0 - 1:
                        z_close = u
                        break
                    u += 1
                    continue
                ui = int(np.searchsorted(unsc, u))
                nxt = int(unsc[ui]) if ui < unsc.size else nj
                _, z = _first_nonpositive(joined_s[:nxt], u)
                if z is None:
                    u = nxt  # excursion runs into the unscored reset
                    continue
                if z >= hd0 - 1:
                    z_close = z
                    break
                u = z + 1
            if z_close is None:
                unresolved.append(
                    (ci, "boundary excursion exceeds head margin"))
                boundary_done_global = base + m * block  # best effort
            else:
                clip = z_close + 1
                regions.extend(extract_spans(
                    joined_s[:clip], joined_sc[:clip], min_width, min_score,
                    seq_id=seq_id, base_pos=open_start))
                boundary_done_global = open_start + z_close

        # --- C. in-chunk candidate extraction with ownership masking ------
        if not cand.any():
            return regions, open_next, x_out
        missing = np.nonzero(cand & ~have)[0]
        pulled = self._pull_missing(pull, missing) if missing.size else {}
        i = 0
        while i < nb:
            if not cand[i]:
                i += 1
                continue
            j = i
            while j + 1 < nb and cand[j + 1]:
                j += 1
            bp = base + i * block  # global pos of first element
            ne = (j + 1 - i) * block
            gpos = bp + np.arange(ne).reshape(j + 1 - i, block)
            msk = gpos <= boundary_done_global
            if clip_from_global is not None:
                msk |= gpos >= clip_from_global
            blocks = range(i, j + 1)
            if not any(b in pulled for b in blocks):
                rows = [pos_in_pull[b] for b in blocks]
                beg, end, sc = native.replay_packed(
                    w_cand[rows], sc_cand[rows] & ~msk, block, self.k,
                    ranks, thr, min_width, min_score, bp)
                regions.extend(
                    (seq_id, int(b), int(e), float(s))
                    for b, e, s in zip(beg, end, sc)
                )
            else:
                # pulled blocks carry their codes; the others rebuild them
                codes = np.stack([
                    pulled[b][0] if b in pulled else rebuild_codes(
                        w_cand[pos_in_pull[b]][None], self.k, block)[0]
                    for b in blocks])
                sc_flat = (np.stack([
                    pulled[b][1] if b in pulled else sc_cand[pos_in_pull[b]]
                    for b in blocks]) & ~msk).reshape(-1)
                s_flat = np.where(
                    sc_flat, ranks[codes.reshape(-1)] - thr, 0.0)
                regions.extend(extract_spans(s_flat, sc_flat, min_width,
                                             min_score, seq_id=seq_id,
                                             base_pos=bp))
            i = j + 1
        return regions, open_next, x_out
