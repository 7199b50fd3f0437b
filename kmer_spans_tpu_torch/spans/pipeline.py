"""The k <= 15 span pipeline on one device: count -> rank -> screen.

Counterpart of ``kmer_spans_tpu/spans/pipeline.py`` make_span_pipeline,
with its three screens:

  * "class", fused (4 <= k <= 8, block >= 1024): rolling codes, k-mer
    validity and the scored mask packed into ONE aug word per position
    (code | valid << 16 | scored << 17); the 4^k spectrum from the aug
    words (K1, ops/histogram.py); the packed rank-class table; per-block
    max-plus summaries straight from the class gather (K2,
    ops/screen_scan.py);
  * "class", non-fused (2 <= k <= 9, or block < 1024): the spectrum of the
    codes (K3), the 4-bit class table, the class gather fused with the
    integer score (K4, ops/gather.py word_gather), then the summaries;
  * "sort" (10 <= k <= 15): the sort screen of ops/sortscreen.py (K3
    twice, K4), with no 4^k table on the device; the finisher replays
    from a host recount;
  * "fine": an int16 4096-level table gathered in plain torch (no kernel;
    kept for parity).

Each then composes the summaries exactly in int64, picks the top-C
candidate blocks run-aware, and returns them with their codes and scored
flags.  The host composes the summaries exactly and replays only
candidate blocks in f64 (spans/finish.py finish_spans).

``make_wide_span_pipeline`` is the sort screen at wide k (16 <= k <= 23,
int64 codes); spans/finish.py finish_wide_spans replays its candidates
from a sparse spectrum.

The arbitrary-weight pipeline (``make_weight_span_pipeline``, with
``quantize_weight_table``) is the device step of the api's exact path:
kmer_regions, the default kmer_low_comp_regions and kmer_spans.  It
screens with an int32 table quantized up from the caller's f64 weights
and adds the scan histogram (K3); spans/finish.py finish_weight_spans
replays its candidates from the f64 weights.  On CUDA, up to 2^20
positions (uses_graph), its step is the replay of a CUDA graph captured
once for each shape, which replaces the chain's ~116 launches by one.

Differences from the reference: ties in the top-C choice go to the lower
block index through a stable descending sort (lax.top_k's rule;
torch.topk promises none), and the summaries are composed exactly in
int64 where the reference composes in f32 (the same values wherever the
f32 ones are exact, i.e. every partial sum an integer below 2^24; see
ops/blocked.py compose_summaries_int64).  The reference's re-tiling of
short blocks into 8192-position tiles, a TPU compile-time measure, is
left out (the codes are the same either way).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..ops.blocked import (
    WIDE_MAX_K,
    block_rows_codes,
    blocked_codes,
    blocked_codes_wide,
    blocked_scan_summaries_int,
    blocked_scored,
    compose_summaries_int64,
)
from ..ops import gather, histogram, screen_scan
from ..ops.convert import wrap_int32
from ..ops.gather import (
    CLASS_BITS,
    class_table_from_mass,
    fine_class_table,
    fine_scores_int,
    screen_thr_q,
)
from ..ops.sortscreen import sort_screen_scores, sort_screen_scores_wide
from ..ops.screen_scan import MAX_BLOCK
from ..parallel.pipeline import _rank_mass


def aug_words(nbases: torch.Tensor, k: int, block: int, first_bases=None,
              first_valid=None, next_valid=None):
    """nbases uint8 [nb * block] -> (aug int32 [nb, block], scored bool).

    ONE aug word per position (code | kmer_valid << 16 | scored << 17)
    feeds the count, the screen and the candidate pull.  A chunk of a
    longer sequence passes its k-1 halo (first_bases/first_valid) and its
    successor's first byte validity (next_valid), as to blocked_codes and
    blocked_scored; by default the tile is a whole genome.
    """
    nb = nbases.shape[0] // block
    b2 = (nbases & 3).reshape(nb, block)
    v2 = (nbases < 4).reshape(nb, block)
    aug, kmer_valid = blocked_codes(b2, v2, k, first_bases=first_bases,
                                    first_valid=first_valid)
    scored = blocked_scored(v2, kmer_valid, next_valid=next_valid)
    aug |= kmer_valid.to(torch.int32) << 16
    aug |= scored.to(torch.int32) << 17
    return aug, scored


def _top_blocks(tA, tB, maxA, maxB, C: int, x_in: int = 0) -> torch.Tensor:
    """Indices (ascending, int64) of the C blocks of highest run max.

    Blocks chain into a run while the composed score stays positive
    across their boundary; every block of a run gets the run's max.  Ties
    go to the lower block index.  x_in is the exact composed bound
    entering block 0 (a chunk's carry): it seeds the composition, and
    block 0 then continues the previous chunk's run (linked[0]), which
    still opens the first run of this chunk's blocks.
    """
    block_max, block_last = compose_summaries_int64(tA, tB, maxA, maxB,
                                                    x0=x_in)
    linked = torch.cat([block_last.new_full((1,), x_in), block_last[:-1]]) > 0
    run = torch.cumsum(~linked, 0) - (~linked[0]).to(torch.int64)
    run_max = torch.full_like(block_max, -(1 << 62)).scatter_reduce(
        0, run, block_max, "amax")[run]
    top = torch.sort(run_max, descending=True, stable=True).indices[:C]
    return torch.sort(top).values


def pack_candidates(scored: torch.Tensor, codes: torch.Tensor):
    """Candidate blocks as the reference's packed words, int32 1-D each.

    scored: bool [C, block]; codes: [C, block] rolling codes, int32, or
    int64 wide codes (16 <= k <= 23).  Returns (scored flags, 32 a word;
    per block its first full code, the k-1 halo seed, then its 2-bit
    bases, 16 a word), from which spans/finish.py rebuild_codes (or
    rebuild_codes_wide) restores exact codes.  A wide seed travels as two
    words, code >> 16 and code & 0xFFFF (the reference's (hi, lo) pair).
    """
    C, block = codes.shape
    bits32 = torch.arange(32, device=codes.device)
    sc_words = (scored.reshape(C, block // 32, 32).to(torch.int64)
                << bits32).sum(dim=-1)
    shifts = 2 * torch.arange(16, device=codes.device)
    b16 = ((codes & 3).to(torch.int64).reshape(C, block // 16, 16)
           << shifts).sum(dim=-1)
    seed = codes[:, :1].to(torch.int64)
    if codes.dtype == torch.int64:
        seed = torch.cat([seed >> 16, seed & 0xFFFF], dim=1)
    cand_words = torch.cat([seed, b16], dim=1)
    return wrap_int32(sc_words).reshape(-1), wrap_int32(cand_words).reshape(-1)


def make_span_pipeline(
    k: int,
    block: int = 8192,
    cand_blocks: int = 128,
    screen: str = "auto",
    packed: bool = False,
    class_bits: int = CLASS_BITS,
    packed_counts: bool = True,
    device="cuda",
):
    """Build the device step fn(nbases, thr) for 1 <= k <= 15.

    nbases: uint8 [n] (tensor or numpy; moved to ``device``), N as 4;
    n a multiple of ``block``.  thr: float (or float32 tensor).

    screen: "auto" is "class" for k <= 9, else "sort".  "class" runs the
    fused kernels at 4 <= k <= 8 with block >= 1024 and the non-fused
    class screen otherwise (2 <= k <= 9); "sort" needs 4 <= k <= 15;
    "fine" takes any k.  The sort screen builds no spectrum: it forces
    packed_counts off and the dict's counts are None, so finish_spans
    needs counts= from a host recount.

    packed=False returns a dict: counts, total, tA, tB, maxA, maxB,
    top_idx, codes (the candidate blocks' codes), scored.  packed=True
    returns ONE int32 vector in the reference's layout (counts unless
    packed_counts is off, total, tA, tB, maxA, maxB, top_idx, bit-packed
    scored flags, candidate blocks as a seed code + 2-bit bases, 16 a
    word); decode it with spans/finish.py unpack_outputs(...,
    packed_bases=fn.packed_bases, packed_counts=fn.packed_counts).  The
    packed vector needs block % 32 == 0 (the scored flags go 32 a word),
    as in the reference, so candidates always travel as bases.

    class_bits: 4 (default) or 2 rank-class bits in the fused screen's
    table; the non-fused class screen always builds 4-bit classes, as
    the reference does.  The kernels are looked up on their modules at
    each call (``histogram.count_aug``, ``screen_scan.fused_screen_scan``,
    ``histogram.histogram``, ``gather.word_gather``).
    """
    if not 1 <= k <= 15:
        raise ValueError(f"k must be in [1, 15], got {k}")
    if screen == "auto":
        screen = "class" if k <= 9 else "sort"
    if screen not in ("class", "sort", "fine"):
        raise ValueError(f"unknown screen {screen!r}")
    if screen == "sort":
        # no 4^k spectrum on the device: the finisher replays from a host
        # recount (utils.native.host_spectrum)
        packed_counts = False
        if not 4 <= k <= 15:
            raise ValueError(f"the sort screen needs 4 <= k <= 15, got {k}")
    if packed and packed_counts and k > 13:
        raise ValueError(
            "packed_counts requires k <= 13 (device spectrum pull); use "
            "packed_counts=False + host recount for larger k")
    if screen == "class" and not 2 <= k <= 9:
        raise ValueError(
            f"the class screen needs 2 <= k <= 9 (4^k / 8 packed words, "
            f"at most {gather.MAX_GATHER_WORDS}), got k={k}")
    if class_bits not in (2, 4):
        raise ValueError(f"class_bits must be 2 or 4, got {class_bits}")
    if packed and block % 32:
        raise ValueError(
            f"block={block}: the packed vector needs block % 32 == 0")
    fuse = screen == "class" and 4 <= k <= 8 and block >= 1024
    if fuse and (block % 256 or block > MAX_BLOCK):
        raise NotImplementedError(
            f"block={block}: the fused screen kernel takes multiples of 256 "
            f"up to {MAX_BLOCK}")
    dev = resolve_device(device)

    def fn(nbases, thr):
        nbases = torch.as_tensor(nbases, device=dev)
        if nbases.dtype != torch.uint8 or nbases.dim() != 1:
            raise TypeError("nbases must be a 1-D uint8 array")
        thr = torch.as_tensor(thr, dtype=torch.float32, device=dev)
        n = nbases.shape[0]
        if n % block or n == 0:
            raise ValueError(f"n={n} is not a positive multiple of {block}")
        nb = n // block
        thr_q = screen_thr_q(thr)
        if fuse:
            aug, scored = aug_words(nbases, k, block)
            flat = aug.reshape(-1)
            counts = histogram.count_aug(flat, k)
            words = class_table_from_mass(
                _rank_mass(counts), counts.sum().to(torch.float32),
                class_bits)
            tA, tB, maxA, maxB = screen_scan.fused_screen_scan(
                words, flat, thr_q, class_bits, block)
            codes = aug  # candidate rows are masked after the pull
        else:
            b2 = (nbases & 3).reshape(nb, block)
            v2 = (nbases < 4).reshape(nb, block)
            codes, kmer_valid = blocked_codes(b2, v2, k)
            scored = blocked_scored(v2, kmer_valid)
            flat, valid = codes.reshape(-1), kmer_valid.reshape(-1)
            if screen == "sort":
                counts = None
                s_int, total = sort_screen_scores(
                    flat, valid, scored.reshape(-1), k, thr_q)
            else:
                counts = histogram.count_spectrum(flat, valid, k)
                mass = _rank_mass(counts)
                total_f32 = counts.sum().to(torch.float32)
                if screen == "class":
                    s_int = gather.word_gather(
                        class_table_from_mass(mass, total_f32), flat, thr_q)
                else:
                    s_int = fine_scores_int(
                        fine_class_table(mass, total_f32)[flat], thr_q)
            del valid, kmer_valid
            tA, tB, maxA, maxB = blocked_scan_summaries_int(
                s_int.reshape(nb, block), scored)
            del s_int
        if counts is not None:
            total = counts.sum()
        top_idx = _top_blocks(tA, tB, maxA, maxB, min(cand_blocks, nb))
        sc_cand = scored[top_idx]
        cand = codes[top_idx]
        if fuse:
            cand &= 0xFFFF
        if not packed:
            return {
                "counts": counts,
                "total": total,
                "tA": tA,
                "tB": tB,
                "maxA": maxA,
                "maxB": maxB,
                "top_idx": top_idx,
                "codes": cand,
                "scored": sc_cand,
            }
        return torch.cat([
            *([counts] if packed_counts else []),
            total.reshape(1).to(torch.int32),
            tA, tB, maxA, maxB,
            top_idx.to(torch.int32),
            *pack_candidates(sc_cand, cand),
        ])

    # the reference ships candidates as 2-bit bases whenever block % 16 == 0;
    # its other layouts are unreachable (the scored flags need block % 32)
    fn.packed_bases = packed
    fn.packed_counts = packed_counts
    fn.screen = screen
    return fn


def make_wide_span_pipeline(k: int, block: int = 8192,
                            cand_blocks: int = 128, device="cuda"):
    """The span pipeline for wide codes (16 <= k <= 23), past the C
    reference's MAX_K, where no 4^k table can exist (68 GB at k = 17).

    fn(nbases uint8 [n], thr float) -> ONE int32 vector: total, tA, tB,
    maxA, maxB, top_idx, bit-packed scored flags, candidate blocks as two
    seed words + 2-bit bases; decode it with spans/finish.py
    unpack_wide_outputs, finish it with finish_wide_spans and a sparse
    spectrum (parallel/device.py device_sparse_spectrum).  Codes are int64
    (ops/blocked.py blocked_codes_wide), the screen is the wide sort
    screen (ops/sortscreen.py: K3 twice, K4), device memory O(n).  n is a
    positive multiple of ``block``, and block % 32 == 0.  The top C comes
    from the exact int64 composition (_top_blocks), where the reference
    orders it in f32.
    """
    if not 16 <= k <= WIDE_MAX_K:
        raise ValueError(f"the wide pipeline needs 16 <= k <= {WIDE_MAX_K}, "
                         f"got k={k}")
    if block % 32:
        raise ValueError(
            f"block={block}: the packed vector needs block % 32 == 0")
    dev = resolve_device(device)

    def fn(nbases, thr):
        nbases = torch.as_tensor(nbases, device=dev)
        if nbases.dtype != torch.uint8 or nbases.dim() != 1:
            raise TypeError("nbases must be a 1-D uint8 array")
        thr = torch.as_tensor(thr, dtype=torch.float32, device=dev)
        n = nbases.shape[0]
        if n % block or n == 0:
            raise ValueError(f"n={n} is not a positive multiple of {block}")
        nb = n // block
        v2 = (nbases < 4).reshape(nb, block)
        codes, kmer_valid = blocked_codes_wide(
            (nbases & 3).reshape(nb, block), v2, k)
        scored = blocked_scored(v2, kmer_valid)
        del v2
        s_int, total = sort_screen_scores_wide(
            codes.reshape(-1), kmer_valid.reshape(-1), k, screen_thr_q(thr))
        del kmer_valid
        tA, tB, maxA, maxB = blocked_scan_summaries_int(
            s_int.reshape(nb, block), scored)
        del s_int
        top_idx = _top_blocks(tA, tB, maxA, maxB, min(cand_blocks, nb))
        return torch.cat([
            total.reshape(1), tA, tB, maxA, maxB, top_idx.to(torch.int32),
            *pack_candidates(scored[top_idx], codes[top_idx]),
        ])

    return fn


def quantize_weight_table(weights, threshold: float, block: int):
    """Sound integer upper-bound screen table for arbitrary f64 weights.

    Returns (w_q int32 [4^k], scale): w_q[c] / scale >= weights[c] -
    threshold always (floor(s * scale) + 2 covers the f64 product's
    rounding), with scale a power of two chosen from the largest finite
    |s| so that within-block int32 sums cannot overflow (scale * max|s| *
    block < 2^26).  For every finite table this is the reference's
    quantize_weight_table (kmer_spans_tpu/spans/pipeline.py:579).

    A weight of -inf (Log2MedianScoring's zero-count k-mers) takes
    -(2^26 // block): any finite value bounds -inf from above, and a block
    of such positions sums to about -2^26, inside int32.  In true units it
    is below -max|s| (it resets the screen as -inf resets the scan).  The
    reference takes max|s| over the whole table and fails there (ROADMAP
    queue 3).  A weight of +inf or NaN has no sound finite bound: ValueError.
    """
    s = np.asarray(weights, dtype=np.float64) - threshold
    neg_inf = np.isneginf(s)
    if np.isnan(s).any() or np.isposinf(s).any():
        raise ValueError("weights must be finite or -inf")
    finite = s[~neg_inf]
    maxabs = float(np.max(np.abs(finite))) if finite.size else 0.0
    w_q = np.full(s.shape, -((1 << 26) // block), np.int32)
    if maxabs <= 0.0:
        w_q[~neg_inf] = 2
        return w_q, 1.0
    e = int(np.floor(np.log2((1 << 26) / (block * maxabs))))
    e = max(min(e, 20), -40)
    scale = 2.0 ** e
    w_q[~neg_inf] = np.floor(finite * scale) + 2.0
    return w_q, scale


#: the step of make_weight_span_pipeline replays a captured CUDA graph on
#: CUDA for n <= GRAPH_MAX_N positions and k <= GRAPH_MAX_K: there its ~116
#: launches (~1.5 ms of host time) outweigh its device work (~0.14 ns a
#: position, ~0.15 ms at 2^20), while each captured size keeps a memory pool
#: of its own and a copy of the 4^k table (64 MB at k = 12); above either
#: bound the eager chain runs, as it does on the CPU
GRAPH_MAX_N = 1 << 20
GRAPH_MAX_K = 12
#: eager runs on the capture's stream before a capture (they set up the
#: sorts' workspaces, as torch.cuda.graphs asks)
GRAPH_WARMUPS = 2

#: steps run by a graph replay, and graphs captured (utils/metrics.py
#: COUNTERS)
graph_steps = 0
graph_captures = 0

#: the captured steps, by (k, block, cand_blocks, with_scan_counts, n,
#: device index): they outlive the fn that captured them, since the api
#: builds one a sequence
_graphs: dict[tuple, _Graph] = {}


def uses_graph(device_type: str, n: int, k: int) -> bool:
    """Whether the weight step on ``n`` positions replays a CUDA graph."""
    return device_type == "cuda" and n <= GRAPH_MAX_N and k <= GRAPH_MAX_K


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    nbases: torch.Tensor  # static inputs, outside the graph's pool
    w_q: torch.Tensor
    out: dict  # static outputs, in the graph's pool
    k3_launches: int  # K3 launches in one replay


def _capture(chain, nbases: torch.Tensor, w_q: torch.Tensor) -> _Graph:
    """Captures ``chain(nbases, w_q)`` on copies of its inputs, after
    GRAPH_WARMUPS eager runs; neither adds to histogram_launches (a replay
    does).  A capture's error propagates."""
    global graph_captures
    launches = histogram.histogram_launches
    dev = nbases.device
    nbases, w_q = nbases.clone(), w_q.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        for _ in range(GRAPH_WARMUPS):
            chain(nbases, w_q)
        before = histogram.histogram_launches
        graph.capture_begin()
        try:
            out = chain(nbases, w_q)
        finally:
            graph.capture_end()
        k3 = histogram.histogram_launches - before
    torch.cuda.current_stream(dev).wait_stream(side)
    histogram.histogram_launches = launches
    graph_captures += 1
    return _Graph(graph, nbases, w_q, out, k3)


def make_weight_span_pipeline(
    k: int,
    block: int = 4096,
    cand_blocks: int = 128,
    with_scan_counts: bool = False,
    device="cuda",
):
    """The device step of arbitrary-weight span calling (reference
    make_weight_span_pipeline; src/kmer_spans.c:490-546).

    fn(nbases uint8 [n], w_q int32 [4^k]) -> dict of the per-block integer
    summaries (tA, tB, maxA, maxB int32 [nb]), the top-C candidate blocks
    (top_idx int64, ascending) with their codes (int32, 0 where the k-mer
    is invalid) and scored rows, and with ``with_scan_counts`` the scan
    histogram (scan_hist int32 [4^k]: the codes at scored positions, K3).
    nbases (tensor or numpy; moved to ``device``) encodes N as 4; n is a
    multiple of ``block``.  The score is w_q[code], a plain torch gather
    (the reference's is an XLA gather too); the summaries compose exactly
    in int64 and the top C is run-aware, ties to the lower block index
    (spans/pipeline.py _top_blocks).

    Where ``uses_graph`` (CUDA, n <= GRAPH_MAX_N, k <= GRAPH_MAX_K) the
    step is a replay of a CUDA graph captured at the first step of its
    shape (counted in graph_captures; each replay in graph_steps): nbases
    and w_q are copied into the graph's static inputs, and the dict holds
    its static outputs, which the next step of the same shape overwrites,
    so the caller copies them out first.  ``fn.eager`` runs the same chain
    without a graph, at any size.

    ``fn.pull(nbases, idx)`` returns (codes, scored) of the blocks idx,
    equal to those rows of the main call (ops/blocked.py
    block_rows_codes): spans/finish.py finish_weight_spans pulls there the
    candidate blocks the top C missed.
    """
    if not 1 <= k <= 15:
        raise ValueError(f"k must be in [1, 15], got {k}")
    size = 1 << (2 * k)
    dev = resolve_device(device)

    def _genome(nbases):
        nbases = torch.as_tensor(nbases, device=dev)
        if nbases.dtype != torch.uint8 or nbases.dim() != 1:
            raise TypeError("nbases must be a 1-D uint8 array")
        n = nbases.shape[0]
        if n % block or n == 0:
            raise ValueError(f"n={n} is not a positive multiple of {block}")
        return nbases, n // block

    def _inputs(nbases, w_q):
        nbases, _ = _genome(nbases)
        w_q = torch.as_tensor(w_q, device=dev)
        if w_q.dtype != torch.int32 or tuple(w_q.shape) != (size,):
            raise TypeError(f"w_q must be int32 [{size}]")
        return nbases, w_q

    def chain(nbases, w_q):
        nb = nbases.shape[0] // block
        v2 = (nbases < 4).reshape(nb, block)
        codes, kmer_valid = blocked_codes((nbases & 3).reshape(nb, block),
                                          v2, k)
        scored = blocked_scored(v2, kmer_valid)
        codes = torch.where(kmer_valid, codes, 0)
        del v2, kmer_valid
        tA, tB, maxA, maxB = blocked_scan_summaries_int(w_q[codes], scored)
        top_idx = _top_blocks(tA, tB, maxA, maxB, min(cand_blocks, nb))
        out = {
            "tA": tA,
            "tB": tB,
            "maxA": maxA,
            "maxB": maxB,
            "top_idx": top_idx,
            "codes": codes[top_idx],
            "scored": scored[top_idx],
        }
        if with_scan_counts:
            out["scan_hist"] = histogram.histogram(
                codes.reshape(-1), scored.reshape(-1), size)
        return out

    def fn(nbases, w_q):
        global graph_steps
        nbases, w_q = _inputs(nbases, w_q)
        n = nbases.shape[0]
        if not uses_graph(nbases.device.type, n, k):
            return chain(nbases, w_q)
        key = (k, block, cand_blocks, with_scan_counts, n,
               nbases.device.index)
        g = _graphs.get(key)
        if g is None:
            g = _graphs[key] = _capture(chain, nbases, w_q)
        else:
            g.nbases.copy_(nbases)
            g.w_q.copy_(w_q)
        g.graph.replay()
        graph_steps += 1
        histogram.histogram_launches += g.k3_launches
        return dict(g.out)

    def pull(nbases, idx):
        nbases, _ = _genome(nbases)
        return block_rows_codes(nbases, torch.as_tensor(idx, device=dev), k,
                                block)

    fn.eager = lambda nbases, w_q: chain(*_inputs(nbases, w_q))
    fn.pull = pull
    return fn
