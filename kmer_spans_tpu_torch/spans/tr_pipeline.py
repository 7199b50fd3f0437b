"""Device pipeline for the transition-score caller (lr_regions).

Counterpart of ``kmer_spans_tpu/spans/tr_pipeline.py``.  The reference's
find_kmer_tr_lr_regions (src/kmer_spans.c:329-395; SURVEY A.6) fits the
same max-plus scan algebra as the rank caller, with three element kinds:

    seed (first k-mer of an N-free block):  f(x) = max(kmer_scores[c], 0)
                                            -> (a, b) = (-inf, clamp(ks))
    extension:                              f(x) = max(x + trans_scores[c], 0)
                                            -> (a, b) = (ts, 0)
    N / warm-up:                            f(x) = 0 -> (-inf, 0)

Integer-sound screen:

  * both tables are quantized UP to int32 (quantize_tr_tables: one
    shared power-of-two scale, q = floor(v*scale) + 2 >= v*scale for
    every f64 v);
  * the device computes per-block (tA, tB, maxA, maxB) int32 summaries
    of the (a, b) pair algebra; within a block every sum is exact int32
    (scale chosen so block * max|q| < 2^26);
  * the host composes the summaries in exact int64
    (spans/finish.py compose_summaries_exact), then has the device
    recompute per-block positive-run stats at those exact incoming
    states (runstats); a region needs max_score > 0 and length >= min_len,
    both inside one maximal run of S_ub > 0, so runs shorter than the gate
    provably emit nothing; the candidate blocks are pulled (pull) and
    replayed in f64 on the host from the original tables.

The block scan.  The reference scans each block with
``jax.lax.associative_scan`` of a combine whose a-part is floored at
SCREEN_NEG; that combine is not associative (with a = (NEG, NEG, 5),
(x∘y)∘z gives NEG + 5 and x∘(y∘z) gives NEG), so an a-part after a reset
(a seed or an N) is whatever the scan's tree made it.  The port computes
the prefix in a closed form, row by row with torch.cumsum and
torch.cummax:

  * the resets are the positions that are not extensions; P is the
    cumsum of the extension scores (exact int32);
  * B = P + the cummax of (b - P) within each stretch from a reset (the
    segment index in the high 32 bits of an int64 key), the exact prefix
    b-part: every element's b is >= 0 and a floored a-part through a
    reset is below -2^29, so the floor never decides a b-part and the
    reference's B is exact too;
  * A = P before the block's first reset and SCREEN_NEG from it on.
So tB and maxB equal the reference's exactly; tA and maxA equal it where
its value exceeds SCREEN_NEG // 2, and both are at or below that value
elsewhere.  runstats' positivity max(x + A, B) > 0, the candidate mask
and the regions are equal: with x <= 2^27, x + A < 0 wherever A is below
SCREEN_NEG // 2, and B >= 0.

The host replay (the host library's ``replay_tr``: the JAX package's
replay_tr_segment in C, with the oracle's end-of-sequence check) is
control-flow faithful to the reference, including its quirks: reg_begin
recorded one past a positive seed, unconditional jump-back to the max on
every zero crossing, terminal emission without rescan, and (given the
sequence's length) no scoring from a block whose seed lands within 2
bytes of the sequence end.  The
last changes regions only at min_region_length == 0; the reference's
device path leaves it out, so there the port is held against the oracle.

Candidate capacity: where the candidate blocks outnumber C, the reference
returns fallback=True and its api serves the sequence on the CPU oracle;
here they are pulled from the device in batches of C (``pull_batches``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..ops.blocked import SCREEN_NEG, _rolling, blocked_codes
from ..utils import native
from .finish import compose_summaries_exact

#: positions a row group of the block scans holds (bounds their memory)
_GROUP = 1 << 24


def quantize_tr_tables(ks: np.ndarray, ts: np.ndarray, block: int):
    """Sound shared-scale integer upper bounds for both f64 score tables.

    Returns (ks_q, ts_q int32, scale): q/scale >= v for every entry
    (floor(fl(v*scale)) >= v*scale - 1 - ulp, covered by +2), scale a
    power of two with block * (scale*max|v| + 2) < 2^26 so within-block
    int32 sums are exact.
    """
    ks = np.asarray(ks, dtype=np.float64)
    ts = np.asarray(ts, dtype=np.float64)
    maxabs = max(
        float(np.max(np.abs(ks))) if ks.size else 0.0,
        float(np.max(np.abs(ts))) if ts.size else 0.0,
    )
    if maxabs <= 0.0:
        return (np.full(ks.shape, 2, np.int32),
                np.full(ts.shape, 2, np.int32), 1.0)
    e = int(np.floor(np.log2((1 << 26) / (block * maxabs))))
    e = max(min(e, 20), -40)
    scale = 2.0 ** e
    ks_q = (np.floor(ks * scale) + 2.0).astype(np.int32)
    ts_q = (np.floor(ts * scale) + 2.0).astype(np.int32)
    return ks_q, ts_q, scale


def _scan_rows(a: torch.Tensor, b: torch.Tensor, ext: torch.Tensor):
    """Inclusive prefix (A, B) int32 [R, block] of the pair algebra along
    each row, in the closed form of the module docstring."""
    P = torch.cumsum(torch.where(ext, a, 0), dim=1, dtype=torch.int32)
    seg = torch.cumsum(~ext, dim=1, dtype=torch.int64)
    # b - P lies in (-2^26, 2^27): offset by 2^31 into the low 32 bits
    key = (seg << 32) | ((b - P).to(torch.int64) + (1 << 31))
    top = torch.cummax(key, dim=1).values
    del key
    B = P + ((top & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)
    A = torch.where(seg == 0, P, SCREEN_NEG)
    return A, B


def _run_stats(pos: torch.Tensor):
    """Per-row (lead, maxrun, tail) of a bool [R, B] mask: its leading
    and trailing runs of True and its longest."""
    idx = torch.arange(pos.shape[1], dtype=torch.int32, device=pos.device)
    npos = ~pos
    lead = (torch.cumsum(npos, dim=1, dtype=torch.int32) == 0).sum(
        dim=1, dtype=torch.int32)
    tail = (torch.cumsum(npos.flip(1), dim=1, dtype=torch.int32) == 0).sum(
        dim=1, dtype=torch.int32)
    last_zero = torch.cummax(torch.where(npos, idx, -1), dim=1).values
    runl = torch.where(pos, idx - last_zero, 0)
    return lead, runl.amax(dim=1), tail


class TrPipeline:
    """The device programs of the tr caller for one (k, block, C).

    .summaries(nbases, ks_q i32, ts_q i32, halo=None) -> dict of
        per-block int32 score summaries (tA, tB, maxA, maxB);
    .runstats(nbases, ks_q, ts_q, x32 i32 [nb], halo=None) -> per-block
        (lead, maxrun, tail) of the S_ub-positive mask at the exact
        incoming state x32 (the host's int64-composed block_last, clamped
        at 2^27: any x >= 2^27 - 2^26 behaves as +inf since in-block
        |A| <= 2^26, so the clamp stays an upper bound);
    .pull(nbases, idx [C], halo=None) -> (codes, seed, ext) rows of the
        exact candidate blocks the host computed.

    nbases: uint8 [n] (tensor or numpy; moved to the device), N as 4, n a
    multiple of ``block``.  halo: uint8 [k], the k bytes before nbases
    (the previous chunk's last k; default all N, the sequence start), so
    codes and the seed/ext masks are consistent across chunk edges.
    """

    def __init__(self, k: int, block: int = 8192, cand_blocks: int = 128,
                 device="cuda"):
        self.k = k
        self.block = block
        self.cand_blocks = cand_blocks
        self.device = resolve_device(device)

    def _genome(self, nbases):
        """nbases on the device, checked; and its number of blocks."""
        nbases = torch.as_tensor(nbases, device=self.device)
        if nbases.dtype != torch.uint8 or nbases.dim() != 1:
            raise TypeError("nbases must be a 1-D uint8 array")
        n = nbases.shape[0]
        if n % self.block or n == 0:
            raise ValueError(
                f"n={n} is not a positive multiple of {self.block}")
        return nbases, n // self.block

    def _halo(self, halo):
        if halo is None:
            return torch.full((self.k,), 4, dtype=torch.uint8,
                              device=self.device)
        return torch.as_tensor(halo, device=self.device).to(torch.uint8)

    def _with_halo(self, nbases, halo):
        """The k halo bytes, then the genome, on the device; and nb."""
        nbases, nb = self._genome(nbases)
        return torch.cat([self._halo(halo), nbases]), nb

    def _rows(self, nb: int):
        """Row groups (r0, r1) of the block scans."""
        R = max(1, _GROUP // self.block)
        return [(r0, min(nb, r0 + R)) for r0 in range(0, nb, R)]

    def _elements(self, xk, r0: int, r1: int, ks_q, ts_q):
        """(a, b, ext) int32/int32/bool [r1-r0, block] of block rows
        r0 .. r1-1; xk holds the k halo bytes, then the genome."""
        k, B = self.k, self.block
        seg = xk[r0 * B:r1 * B + k]  # the k bytes before the rows, the rows
        body = seg[k:]
        v2 = (body < 4).reshape(-1, B)
        codes, kv = blocked_codes((body & 3).reshape(-1, B), v2, k,
                                  first_bases=seg[1:k] & 3,
                                  first_valid=seg[1:k] < 4)
        codes.masked_fill_(~kv, 0)
        # seed: first complete k-mer of its block — the base k positions
        # back is N or before the (global) start
        seed = kv & ~(seg[:-k] < 4).reshape(-1, B)
        ext = kv & ~seed
        a = torch.where(ext, ts_q[codes], SCREEN_NEG)
        b = torch.where(seed, ks_q[codes].clamp(min=0), 0)
        return a, b, ext

    def tables(self, ks_q, ts_q):
        return (torch.as_tensor(ks_q, device=self.device),
                torch.as_tensor(ts_q, device=self.device))

    def summaries(self, nbases, ks_q, ts_q, halo=None):
        xk, nb = self._with_halo(nbases, halo)
        ks_q, ts_q = self.tables(ks_q, ts_q)
        parts = []
        for r0, r1 in self._rows(nb):
            A, Bv = _scan_rows(*self._elements(xk, r0, r1, ks_q, ts_q))
            parts.append((A[:, -1], Bv[:, -1], A.amax(dim=1),
                          Bv.amax(dim=1)))
            del A, Bv
        keys = ("tA", "tB", "maxA", "maxB")
        return {kk: torch.cat([p[i] for p in parts])
                for i, kk in enumerate(keys)}

    def runstats(self, nbases, ks_q, ts_q, x32, halo=None):
        xk, nb = self._with_halo(nbases, halo)
        ks_q, ts_q = self.tables(ks_q, ts_q)
        x32 = torch.as_tensor(x32, device=self.device).to(torch.int32)
        parts = []
        for r0, r1 in self._rows(nb):
            A, Bv = _scan_rows(*self._elements(xk, r0, r1, ks_q, ts_q))
            pos = torch.maximum(x32[r0:r1, None] + A, Bv) > 0
            del A, Bv
            parts.append(_run_stats(pos))
        return tuple(torch.cat([p[i] for p in parts]) for i in range(3))

    def pull(self, nbases, idx, halo=None):
        nbases, _ = self._genome(nbases)
        halo = self._halo(halo)
        k, B = self.k, self.block
        idx = torch.as_tensor(idx, device=self.device).to(torch.int64)
        # each block's k preceding bytes (from the halo before position 0),
        # then the block
        pos = idx[:, None] * B + torch.arange(-k, B, device=self.device)
        x = torch.where(pos >= 0, nbases[pos.clamp(min=0)],
                        halo[(pos + k).clamp(max=k - 1)])
        v = x < 4
        codes, kv = _rolling((x[:, 1:] & 3).to(torch.int32), v[:, 1:], k, B)
        codes.masked_fill_(~kv, 0)
        seed = kv & ~v[:, :B]
        return codes, seed, kv & ~seed


def make_tr_pipeline(k: int, block: int = 8192, cand_blocks: int = 128,
                     device="cuda") -> TrPipeline:
    """The tr caller's device programs (see TrPipeline) on ``device``."""
    return TrPipeline(k, block, cand_blocks, device)


def _tr_candidacy(lead, mrun, tail, x_in, min_len, nb, block):
    """Exact candidate-block mask from per-block positive-run stats.

    Stitches cross-block runs: carry = length of the S_ub-positive run
    ending exactly at the boundary before block b (0 if S_ub <= 0
    there).  A region needs length >= min_len inside one such run, so
    runs shorter than the gate provably emit nothing.  Each candidate
    stretch is then extended left to the first block whose incoming
    exact bound is <= 0 (S_true is provably 0 there), so the replay
    starts at true state 0.
    """
    gate = max(min_len, 1)
    cand = np.zeros(nb, bool)
    carry = 0
    run_start = 0
    for bidx in range(nb):
        li, mi, ti = int(lead[bidx]), int(mrun[bidx]), int(tail[bidx])
        if carry > 0 and carry + li >= gate:
            cand[run_start:bidx + 1] = True     # boundary-crossing run
        if mi >= gate:
            cand[bidx] = True                   # within-block run
        if li == block:
            # whole block positive: the boundary run continues
            if carry == 0:
                run_start = bidx
            carry += block
        elif ti > 0:
            carry = ti
            run_start = bidx
        else:
            carry = 0
    if not cand.any():
        return cand
    for bidx in range(nb):
        if cand[bidx] and (bidx == 0 or not cand[bidx - 1]):
            j = bidx
            while j > 0 and x_in[j] > 0:
                j -= 1
            cand[j:bidx] = True
    return cand


@dataclasses.dataclass
class TrPipelineResult:
    regions: list
    fallback: bool  # always False: every candidate block is pulled
    pull_batches: int = 0  # device gathers of at most C candidate blocks


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pull_batches(pipe, nbases_dev, blocks, halo=None):
    """Pull the given block indices in batches of pipe.cand_blocks.
    Returns ({block: (codes, seed, ext)}, number of batches)."""
    C = pipe.cand_blocks
    pulled = {}
    batches = 0
    for s0 in range(0, blocks.size, C):
        sub = blocks[s0:s0 + C]
        idx_pad = np.zeros(C, np.int64)
        idx_pad[:sub.size] = sub
        rows = [_np(v)[:sub.size] for v in pipe.pull(
            nbases_dev, torch.from_numpy(idx_pad), halo)]
        for r, b in enumerate(sub):
            pulled[int(b)] = tuple(v[r] for v in rows)
        batches += 1
    return pulled, batches


def _replay_stretches(cand, pulled, ks_table, ts_table, block, min_len,
                      seq_id, seq_len=None):
    """Replay each maximal stretch of candidate blocks from the pulled
    codes and the f64 tables in the host library (utils/native.py
    replay_tr)."""
    ks64 = np.asarray(ks_table, np.float64)
    ts64 = np.asarray(ts_table, np.float64)
    nb = cand.shape[0]
    regions = []
    i = 0
    while i < nb:
        if not cand[i]:
            i += 1
            continue
        j = i
        while j + 1 < nb and cand[j + 1]:
            j += 1
        codes, seed, ext = (np.concatenate([pulled[b][f]
                                            for b in range(i, j + 1)])
                            for f in range(3))
        regions.extend(
            (seq_id, int(bv), int(ev), float(sv))
            for bv, ev, sv in zip(*native.replay_tr(
                codes, seed, ext, ks64, ts64, i * block, min_len,
                seq_len)))
        i = j + 1
    return regions


def finish_tr_spans(
    out: dict,
    n: int,
    min_len: int,
    ks_table: np.ndarray,
    ts_table: np.ndarray,
    block: int = 8192,
    seq_id: int = 1,
    pipe=None,
    nbases_dev=None,
    ks_q_dev=None,
    ts_q_dev=None,
    seq_len: int | None = None,
) -> TrPipelineResult:
    """Host finisher: exact integer candidacy -> exact f64 replay.

    Composes the device's integer block summaries in int64
    (compose_summaries_exact) — S_ub >= scale*S_true at every block edge
    — then has the device recompute per-block positive-run stats at
    those exact incoming states (pipe.runstats) and stitches them into
    maximal S_ub-positive runs.  A region needs max_score > 0 and
    length >= min_len, both of which live inside one such run (regions
    never contain an interior zero of S — the reference emits and jumps
    back at every crossing, src/kmer_spans.c:369-385), so runs with
    runlen_ub < min_len provably emit nothing.  No floating point
    anywhere in candidacy.

    pipe/nbases_dev/ks_q_dev/ts_q_dev: the make_tr_pipeline object and
    its device-resident inputs.  The candidate blocks are pulled after
    candidacy (pipe.pull) in batches of pipe.cand_blocks, as many as they
    need: there is no fallback.  seq_len: the sequence's length, for the
    reference's end-of-sequence quirk (see the module's doc).

    ks_table/ts_table: the ORIGINAL f64 score tables — candidates replay
    from host f64 gathers of their pulled codes, so emitted positions and
    scores are bit-identical to the reference's f64 accumulation
    (src/kmer_spans.c:348-366); the device's integer tables only screen.
    """
    block_max, block_last = compose_summaries_exact(
        _np(out["tA"]), _np(out["tB"]), _np(out["maxA"]), _np(out["maxB"]))
    nb = block_max.shape[0]
    x_in = np.concatenate([[np.int64(0)], block_last[:-1]])
    if pipe is None or nbases_dev is None:
        raise ValueError("finish_tr_spans needs the pipeline programs "
                         "and device inputs (make_tr_pipeline)")
    # exact per-block positive-run stats at the composed incoming state
    # (clamped at 2^27: any x >= 2^27 - 2^26 yields identical positivity
    # since in-block |A| <= 2^26 away from seeds, and after a seed S is
    # x-independent — so the clamp is exact, not just sound)
    x32 = np.clip(x_in, 0, 1 << 27).astype(np.int32)
    lead, mrun, tail = (
        _np(v).astype(np.int64)
        for v in pipe.runstats(nbases_dev, ks_q_dev, ts_q_dev,
                               torch.from_numpy(x32)))

    cand = _tr_candidacy(lead, mrun, tail, x_in, min_len, nb, block)
    if not cand.any():
        return TrPipelineResult(regions=[], fallback=False)
    pulled, batches = _pull_batches(pipe, nbases_dev, np.nonzero(cand)[0])
    regions = _replay_stretches(cand, pulled, ks_table, ts_table, block,
                                min_len, seq_id, seq_len=seq_len)
    return TrPipelineResult(regions=regions, fallback=False,
                            pull_batches=batches)


def stream_tr_regions(
    nbases, k: int, ks_table: np.ndarray, ts_table: np.ndarray,
    min_len: int, seq_id: int = 1, chunk: int = 1 << 24,
    block: int = 8192, cand_blocks: int = 128, pipe=None, device="cuda",
) -> TrPipelineResult:
    """Chunked transition-score caller for genome-scale sequences.

    The sequence is staged on the device once and streams through fixed
    ``chunk``-position slices of it.  Exactness across chunk edges:

      * each chunk carries the previous chunk's last k bytes as a halo,
        so codes and the seed/ext masks are globally consistent;
      * per-block int32 summaries concatenate across chunks and compose
        in exact int64 (compose_summaries_exact) — the same
        integer-sound screen as the one-shot path, so candidacy is
        provably complete;
      * candidate blocks are pulled per chunk (batched at the pull
        capacity) and replayed stretch-wise with the reference-exact
        sequential caller, which applies the end-of-sequence quirk at
        the sequence's length.

    nbases: uint8 [n] with N as 4 (numpy or a tensor).  Reference parity:
    find_kmer_tr_lr_regions (src/kmer_spans.c:329-395).
    """
    if chunk % block:
        raise ValueError("chunk must be a multiple of block")
    if pipe is None:
        pipe = make_tr_pipeline(k, block=block, cand_blocks=cand_blocks,
                                device=device)
    dev = pipe.device
    if not torch.is_tensor(nbases):
        nbases = np.asarray(nbases, np.uint8)
    nbases = torch.as_tensor(nbases, device=dev)
    n0 = nbases.shape[0]
    nchunks = max(1, -(-n0 // chunk))
    staged = torch.full((nchunks * chunk,), 4, dtype=torch.uint8, device=dev)
    staged[:n0] = nbases
    ks_q, ts_q, _ = quantize_tr_tables(ks_table, ts_table, block)
    ksq_dev, tsq_dev = pipe.tables(ks_q, ts_q)

    def chunk_arr(ci):
        return staged[ci * chunk:(ci + 1) * chunk]

    def halo_arr(ci):
        if ci == 0:
            return None
        return staged[ci * chunk - k:ci * chunk]

    # pass 1: per-chunk integer summaries -> exact global composition
    parts = {kk: [] for kk in ("tA", "tB", "maxA", "maxB")}
    for ci in range(nchunks):
        out = pipe.summaries(chunk_arr(ci), ksq_dev, tsq_dev, halo_arr(ci))
        for kk in parts:
            parts[kk].append(_np(out[kk]))
    tA, tB, maxA, maxB = (np.concatenate(parts[kk]) for kk in
                          ("tA", "tB", "maxA", "maxB"))
    _, block_last = compose_summaries_exact(tA, tB, maxA, maxB)
    nb = block_last.shape[0]
    x_in = np.concatenate([[np.int64(0)], block_last[:-1]])
    x32 = np.clip(x_in, 0, 1 << 27).astype(np.int32)
    bpc = chunk // block

    # pass 2: per-block positive-run stats at the exact incoming states
    st = ([], [], [])
    for ci in range(nchunks):
        outs = pipe.runstats(
            chunk_arr(ci), ksq_dev, tsq_dev,
            torch.from_numpy(x32[ci * bpc: (ci + 1) * bpc]), halo_arr(ci))
        for acc, v in zip(st, outs):
            acc.append(_np(v))
    lead, mrun, tail = (np.concatenate(a).astype(np.int64) for a in st)
    cand = _tr_candidacy(lead, mrun, tail, x_in, min_len, nb, block)
    if not cand.any():
        return TrPipelineResult(regions=[], fallback=False)

    # pass 3: pull candidate blocks per chunk, batched at capacity
    pulled = {}
    batches = 0
    for ci in range(nchunks):
        loc = np.nonzero(cand[ci * bpc: (ci + 1) * bpc])[0]
        if loc.size == 0:
            continue
        got, nbat = _pull_batches(pipe, chunk_arr(ci), loc, halo_arr(ci))
        pulled.update((ci * bpc + b, v) for b, v in got.items())
        batches += nbat
    regions = _replay_stretches(cand, pulled, ks_table, ts_table, block,
                                min_len, seq_id, seq_len=n0)
    return TrPipelineResult(regions=regions, fallback=False,
                            pull_batches=batches)
