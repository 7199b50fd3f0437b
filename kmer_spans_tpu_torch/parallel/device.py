"""Single-device helpers: the spectrum count with power-of-two staging,
the sparse wide-k spectrum, windowed distributions and transition-score
regions of one sequence.

Counterpart of ``kmer_spans_tpu/parallel/device.py`` (``bucket_size``,
``device_count_spectrum``, ``device_codes_scored``, ``device_window_dist``,
``device_tr_regions``);
``device_sparse_spectrum`` computes on the device what the reference's
host recount ``native.host_spectrum_sparse`` computes.
Each sequence is staged on the device padded to a power-of-two bucket,
with N (4) in the padding, so padding counts nowhere; its codes come from
the blocked rolling codes (ops/blocked.py) and its 4^k spectrum from K3
(ops/histogram.py count_spectrum).  The reference's flat ``ops/codes.py``
and its scatter and sort counts are not ported: K3 computes the same
function.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..encoding import MAX_K, PackedSeq
from ..ops import histogram
from ..ops.blocked import blocked_codes, blocked_codes_wide, blocked_scored
from ..spans.tr_pipeline import (
    finish_tr_spans,
    make_tr_pipeline,
    quantize_tr_tables,
)
from .window_stream import get_engine

_MIN_BUCKET = 4096
#: positions a tile of the blocked codes (every bucket is a multiple of
#: this or smaller than it)
_COUNT_BLOCK = 8192
#: bytes staged_nbases has returned, for every caller (the count and the
#: span step of each sequence)
staged_bytes = 0


def bucket_size(n: int) -> int:
    """The power of two >= n, at least 4096."""
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


def staged_nbases(p: PackedSeq, npad: int) -> np.ndarray:
    """uint8 [npad]: the sequence's 2-bit bases with N as 4, N-padded."""
    global staged_bytes
    staged_bytes += npad
    arr = np.full(npad, 4, np.uint8)
    arr[: p.n] = np.where(p.valid, p.bases, 4)
    return arr


def device_count_spectrum(packed: list[PackedSeq], k: int, device="cuda"):
    """The 4^k spectrum over sequences, counted on ``device``.

    Returns (counts int64 np [4^k], n_words int).  Sequences shorter than k
    are skipped (reference binding behaviour, src/kmer_spans.c:478-479).
    Counts accumulate in int64 on the device; n_words is their sum, the
    number of valid k-mers.
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k should be in [1, {MAX_K}]")
    dev = resolve_device(device)
    total = None
    for p in packed:
        if p.n < k:
            continue
        npad = bucket_size(p.n)
        block = min(npad, _COUNT_BLOCK)
        nbases = torch.from_numpy(staged_nbases(p, npad)).to(dev)
        codes, kv = blocked_codes((nbases & 3).reshape(-1, block),
                                  (nbases < 4).reshape(-1, block), k)
        del nbases
        c = histogram.count_spectrum(codes.reshape(-1), kv.reshape(-1), k)
        del codes, kv
        total = c.to(torch.int64) if total is None else total + c
    if total is None:
        return np.zeros(1 << (2 * k), dtype=np.int64), 0
    counts = total.cpu().numpy()
    return counts, int(counts.sum())


def device_sparse_spectrum(nbases, k: int, device="cuda"):
    """The sparse spectrum of wide k-mers (16 <= k <= 23), on ``device``.

    nbases: uint8 [n] (tensor or numpy; moved to ``device``), N as 4.
    Returns (ucodes int64 np, the distinct codes ascending; ucounts int64
    np, their counts; n_words, the counted k-mers), what the reference's
    host recount native.host_spectrum_sparse returns, from one torch.sort
    of the valid int64 codes and their runs (library calls, no kernel).
    """
    dev = resolve_device(device)
    nbases = torch.as_tensor(nbases, device=dev)
    if nbases.dtype != torch.uint8 or nbases.dim() != 1:
        raise TypeError("nbases must be a 1-D uint8 array")
    codes, kv = blocked_codes_wide((nbases & 3).reshape(1, -1),
                                   (nbases < 4).reshape(1, -1), k)
    key = codes.reshape(-1)[kv.reshape(-1)]
    del codes, kv
    skey = torch.sort(key).values
    del key
    ucodes, ucounts = torch.unique_consecutive(skey, return_counts=True)
    return (ucodes.cpu().numpy(), ucounts.to(torch.int64).cpu().numpy(),
            int(skey.numel()))


def device_nbases(p: PackedSeq, npad: int, device) -> torch.Tensor:
    """uint8 [npad] on ``device``: the sequence's 2-bit bases with N as 4,
    N-padded; bases and validity are copied and merged on the device."""
    out = torch.full((npad,), 4, dtype=torch.uint8, device=device)
    bases = torch.from_numpy(np.ascontiguousarray(p.bases)).to(device)
    valid = torch.from_numpy(np.ascontiguousarray(p.valid)).to(device)
    out[:p.n] = torch.where(valid, bases, 4)
    return out


def device_window_dist(p: PackedSeq, tracked, k: int, window: int,
                       with_positions: bool, block: int = 8192,
                       device="cuda"):
    """Windowed k-mer distributions for one sequence, via the chunked
    streaming engine (parallel/window_stream.py): fixed chunk shapes
    whatever the sequence lengths, uint8/int16 packed positions pulled
    per chunk while the next chunk runs.

    The chunk is the sequence length rounded up to a power of two
    (clamped to [2^15, 2^22]), so a many-scaffold workload shares a
    handful of engines, and any scaffold > 4 Mb shares one.
    Returns (dist int64 [window+1, T], counts_pos int64 [n, T] or None).
    """
    dev = resolve_device(device)
    chunk = 1 << 15
    while chunk < p.n and chunk < (1 << 22):
        chunk *= 2
    eng = get_engine(k, window, len(tracked), chunk, block, dev)
    return eng.run(device_nbases(p, p.n, dev),
                   np.asarray(tracked, dtype=np.int32), with_positions)


def device_tr_regions(p: PackedSeq, k: int, ks: np.ndarray, ts: np.ndarray,
                      min_length: int, seq_id: int, block: int = 8192,
                      cand_blocks: int = 128, device="cuda"):
    """Transition-score regions for one sequence (spans/tr_pipeline).

    Candidate blocks pull their codes; the host replays them from the
    original f64 tables, so emitted positions and scores are bit-identical
    to the reference (src/kmer_spans.c:329-395).  The screen is integer-
    sound end to end: tables quantized up to int32 (quantize_tr_tables),
    per-block int32 summaries, exact int64 host composition.  The
    sequence is padded with N to the power of two >= max(n, 8192).
    Returns the TrPipelineResult (regions; pull_batches, the device
    gathers of at most cand_blocks candidate blocks).
    """
    dev = resolve_device(device)
    npad = max(block, 1 << 13)
    while npad < p.n:
        npad *= 2
    nbases = device_nbases(p, npad, dev)
    ks_q, ts_q, _ = quantize_tr_tables(ks, ts, block)
    pipe = make_tr_pipeline(k, block=block, cand_blocks=cand_blocks,
                            device=dev)
    ksq_dev, tsq_dev = pipe.tables(ks_q, ts_q)
    out = pipe.summaries(nbases, ksq_dev, tsq_dev)
    return finish_tr_spans(out, npad, min_length, ks, ts, block=block,
                           seq_id=seq_id, pipe=pipe, nbases_dev=nbases,
                           ks_q_dev=ksq_dev, ts_q_dev=tsq_dev, seq_len=p.n)


def device_codes_scored(p: PackedSeq, k: int, device="cuda"):
    """Codes and scored mask of one sequence, computed on ``device`` and
    trimmed back to its length: (int32 codes, 0 where the k-mer is
    invalid; bool scored), numpy."""
    dev = resolve_device(device)
    npad = bucket_size(p.n)
    block = min(npad, _COUNT_BLOCK)
    nbases = torch.from_numpy(staged_nbases(p, npad)).to(dev)
    v2 = (nbases < 4).reshape(-1, block)
    codes, kv = blocked_codes((nbases & 3).reshape(-1, block), v2, k)
    scored = blocked_scored(v2, kv)
    codes = torch.where(kv, codes, 0)
    return (codes.reshape(-1)[:p.n].cpu().numpy(),
            scored.reshape(-1)[:p.n].cpu().numpy())
