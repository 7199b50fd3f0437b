"""Chunked streaming windowed-distribution engine.

Counterpart of ``kmer_spans_tpu/parallel/window_stream.py``.  Every
sequence, of any length, streams through fixed-size chunks with a
``window``-base lookahead; window starts beyond the chunk are masked
(ops/window.py start_limit), so each window is counted exactly once and
chunk boundaries are invisible (windows never span N anyway).

The sequence is staged on the device once and the chunks are slices of
it.  With positions, each chunk's matrix leaves the device as uint8
(int16 when window+2 > 255) in [chunk, T] order, copied with
``non_blocking=True`` into one of two pinned host buffers; the host
widens chunk i to int64 while the device computes chunk i+1.

Bit-exactness: identical window validity and counts as the one-shot
function — a window starting in chunk c lies entirely inside
[c*chunk, c*chunk + chunk + window), which the lookahead covers; halo
codes at a chunk's first k-1 end positions belong to windows starting
before the chunk and are masked there.

Reference parity: windowed_kmer_count_distributions
(src/kmer_spans.c:413-449) and its ret_flag&1 positions matrices
(:763-783).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..ops.blocked import blocked_codes
from ..ops.window import windowed_counts_device


class StreamingWindowEngine:
    """Fixed chunk shapes on one device; sequences stream through them."""

    def __init__(self, k: int, window: int, n_tracked: int,
                 chunk: int = 1 << 22, block: int = 8192, device="cuda"):
        if chunk % block:
            raise ValueError("chunk must be a multiple of block")
        self.k = k
        self.window = window
        self.T = n_tracked
        self.chunk = chunk
        self.block = block
        self.device = resolve_device(device)
        # lookahead rounded up to whole blocks for the 2D reshape
        self._ext = -(-window // block) * block
        self._pos_dtype = torch.uint8 if window + 2 <= 255 else torch.int16
        self._buffers = None  # two pinned host buffers, made at first use

    def _chunk(self, ext_bases: torch.Tensor, tracked: torch.Tensor,
               with_positions: bool):
        """dist int32 [window+1, T] and, with positions, their matrix
        [chunk, T] (uint8 or int16) of one chunk and its lookahead."""
        b2 = (ext_bases & 3).reshape(-1, self.block)
        v2 = (ext_bases < 4).reshape(-1, self.block)
        codes, kv = blocked_codes(b2, v2, self.k)
        codes.masked_fill_(~kv, 0)
        dist, cpos, _ = windowed_counts_device(
            codes, kv, v2, tracked, self.k, self.window,
            with_positions=with_positions, start_limit=self.chunk)
        if cpos is not None:
            cpos = cpos[:, :self.chunk].to(self._pos_dtype).t().contiguous()
        return dist, cpos

    def _host_buffers(self):
        if self._buffers is None:
            self._buffers = [
                torch.empty((self.chunk, self.T), dtype=self._pos_dtype,
                            pin_memory=True)
                for _ in range(2)]
        return self._buffers

    def run(self, nbases, tracked, with_positions: bool):
        """Stream one sequence; returns (dist int64 [window+1, T],
        counts_pos int64 [n, T] or None).

        nbases: uint8 [n] with N as 4, a numpy array or a tensor (moved to
        the engine's device once).  Chunk i's positions are copied to a
        pinned host buffer as soon as they are made, and widened on the
        host while chunk i+1 runs.
        """
        dev = self.device
        nbases = torch.as_tensor(nbases, device=dev)
        n = nbases.shape[0]
        nchunks = -(-n // self.chunk)
        staged = torch.full((nchunks * self.chunk + self._ext,), 4,
                            dtype=torch.uint8, device=dev)
        staged[:n] = nbases
        tr = torch.as_tensor(np.asarray(tracked, dtype=np.int32), device=dev)
        dist = torch.zeros((self.window + 1, self.T), dtype=torch.int64,
                           device=dev)
        counts_pos = (np.empty((n, self.T), dtype=np.int64)
                      if with_positions else None)
        on_card = dev.type == "cuda"
        pending = None  # (chunk index, host matrix, event)

        def drain(item):
            ci, host, event = item
            if event is not None:
                event.synchronize()
            lo = ci * self.chunk
            m = min(self.chunk, n - lo)
            counts_pos[lo:lo + m] = host[:m].numpy()

        for ci in range(nchunks):
            lo = ci * self.chunk
            d, cpos = self._chunk(staged[lo:lo + self.chunk + self._ext], tr,
                                  with_positions)
            dist += d
            if cpos is None:
                continue
            event = None
            if on_card:
                host = self._host_buffers()[ci % 2]
                host.copy_(cpos, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host = cpos
            if pending is not None:
                drain(pending)
            pending = (ci, host, event)
        if pending is not None:
            drain(pending)
        return dist.cpu().numpy(), counts_pos


@functools.lru_cache(maxsize=8)
def get_engine(k: int, window: int, n_tracked: int, chunk: int,
               block: int = 8192, device="cuda") -> StreamingWindowEngine:
    """Engine cache: one engine (and its two pinned host buffers) per
    (k, window, T, chunk, device), so a many-scaffold cohort reuses them."""
    return StreamingWindowEngine(k, window, n_tracked, chunk, block, device)
