"""Windowed k-mer occurrence distributions on one device.

Counterpart of ``kmer_spans_tpu/ops/window.py`` windowed_counts_device.
The reference slides a two-pointer window with a full 4^k scratch array
(src/kmer_spans.c:413-449), one pass per sequence.  Here the occurrence
count of tracked k-mer w in the window starting at t is a local windowed
sum of w's indicator vector,

    occ[p]   = [code ending at p+k-1 == w]  (start-position convention)
    count[t] = sum of occ[t .. t+window-k]  (slots = window-k+1 starts)

for all T tracked k-mers at once.  The window starts go in groups of
2^22, each reading a ``window``-base lookahead, which bounds the device
memory of a call whatever its length.  ``window_values`` takes a group
from its codes to K3's input: on a CUDA tensor one launch of
csrc/window_counts.cu, which slides each count by one a start (counted in
``window_counts_launches``); on a CPU tensor the plain version,
``window_group`` (an int32 ``torch.cumsum`` along each row of a
[T, group + window] tile, exact below 2^31) and ``dist_values``.

The count histogram is K3 (ops/histogram.py histogram) over the combined
(kmer, count) indices, T·(window+2) bins rounded up to 128, or over
(scaffold, kmer, count) in the cohort mode: one launch per group.

Windows never span N gaps: a window is valid iff all its bases are non-N
(the windowed sum of invalidity == 0), which also kills windows that cross
the padded tail.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, histogram

#: window starts per group of windowed_counts_device (one K3 launch each)
GROUP = 1 << 22
#: window_values kernel launches since the count was last set to 0: one a
#: group of window starts on the card
window_counts_launches = 0


def window_group(flat_c: torch.Tensor, flat_kv: torch.Tensor,
                 flat_v: torch.Tensor, tracked: torch.Tensor, k: int,
                 window: int, lo: int, hi: int):
    """Counts and validity of the windows starting at lo .. hi-1.

    flat_c/flat_kv: [n] end-position codes and k-mer validity; flat_v: [n]
    non-N mask; tracked: int32 [T].  Positions at or past n read as N.
    Returns (counts int32 [T, hi-lo], 0 where the window is invalid;
    window_valid bool [hi-lo]).
    """
    n = flat_c.shape[0]
    m = hi - lo
    span = m + window  # the starts and their lookahead
    end = min(lo + span, n)
    T = tracked.shape[0]
    # a leading zero column makes the inclusive cumsum the exclusive one
    occ = torch.zeros((T, span + 1), dtype=torch.bool, device=flat_c.device)
    occ[:, 1:end - lo + 1] = ((flat_c[None, lo:end] == tracked[:, None])
                              & flat_kv[None, lo:end])
    S = torch.cumsum(occ, dim=1, dtype=torch.int32)
    del occ
    # count[t] = occ summed over start slots t..t+window-k (end positions
    # t+k-1 .. t+window-1)
    cnt = S[:, window:window + m] - S[:, k - 1:k - 1 + m]
    del S
    inv = torch.ones(span + 1, dtype=torch.int32, device=flat_c.device)
    inv[0] = 0
    inv[1:end - lo + 1] = (~flat_v[lo:end]).to(torch.int32)
    Pi = torch.cumsum(inv, 0, dtype=torch.int32)
    wv = (Pi[window:window + m] - Pi[0:m]) == 0
    cnt.masked_fill_(~wv[None, :], 0)
    return cnt, wv


def dist_values(cnt: torch.Tensor, wv: torch.Tensor, window: int,
                seg: torch.Tensor | None = None, n_seqs: int | None = None):
    """K3's input for a group of windows: the combined (kmer, count)
    indices, or (scaffold, kmer, count) with ``seg`` (int32 [m], each
    window start's scaffold), their mask and the bin count.

    Returns (values int32 [T, m], valid bool [T, m] (window validity
    broadcast over the T rows, made contiguous as K3 takes it), size).
    """
    T = cnt.shape[0]
    W2 = window + 2
    comb = cnt + (torch.arange(T, dtype=torch.int32, device=cnt.device)
                  * W2)[:, None]
    nbins = T * W2
    if seg is not None:
        comb += (seg.to(torch.int32) * nbins)[None, :]
        nbins *= int(n_seqs)
    size = -(-nbins // 128) * 128
    return comb, wv[None, :].expand(T, -1).contiguous(), size


def window_values_plain(flat_c: torch.Tensor, flat_kv: torch.Tensor,
                        flat_v: torch.Tensor, tracked: torch.Tensor, k: int,
                        window: int, lo: int, hi: int,
                        seg: torch.Tensor | None = None,
                        n_seqs: int | None = None, want_counts: bool = False):
    """Plain PyTorch window_values: window_group, then dist_values."""
    _check_window_inputs(flat_c, flat_kv, flat_v, tracked, k, window, lo, hi,
                         seg, n_seqs)
    cnt, wv = window_group(flat_c, flat_kv, flat_v, tracked, k, window, lo,
                           hi)
    values, valid, size = dist_values(
        cnt, wv, window, None if seg is None else seg[lo:hi], n_seqs)
    return values, valid, size, wv, cnt if want_counts else None


def _check_window_inputs(flat_c, flat_kv, flat_v, tracked, k, window, lo, hi,
                         seg, n_seqs) -> None:
    if flat_c.dtype != torch.int32 or tracked.dtype != torch.int32:
        raise TypeError(f"codes and tracked must be int32, got "
                        f"{flat_c.dtype} and {tracked.dtype}")
    if flat_kv.dtype != torch.bool or flat_v.dtype != torch.bool:
        raise TypeError(f"kv and v must be bool, got {flat_kv.dtype} and "
                        f"{flat_v.dtype}")
    n = flat_c.shape[0]
    flats = [flat_c, flat_kv, flat_v] + ([] if seg is None else [seg])
    if any(x.dim() != 1 or x.shape[0] != n for x in flats) \
            or tracked.dim() != 1:
        raise ValueError("codes, kv, v and seg must be 1-D of one length, "
                         "tracked 1-D")
    if any(x.device != flat_c.device for x in flats + [tracked]):
        raise ValueError("window_values: inputs on more than one device")
    if seg is not None and seg.dtype != torch.int32:
        raise TypeError(f"seg must be int32, got {seg.dtype}")
    if seg is not None and n_seqs is None:
        raise ValueError("window_values: seg without n_seqs")
    if not 1 <= k <= window or not 0 <= lo <= hi <= n:
        raise ValueError(f"window_values: k={k}, window={window}, starts "
                         f"{lo}..{hi} of {n}")


def window_values(flat_c: torch.Tensor, flat_kv: torch.Tensor,
                  flat_v: torch.Tensor, tracked: torch.Tensor, k: int,
                  window: int, lo: int, hi: int,
                  seg: torch.Tensor | None = None, n_seqs: int | None = None,
                  want_counts: bool = False):
    """K3's input for the windows starting at lo .. hi-1: what window_group
    followed by dist_values give.

    flat_c: int32 [n] end-position codes; flat_kv, flat_v: bool [n] k-mer
    validity and non-N mask; tracked: int32 [T]; seg: int32 [n], each
    position's scaffold (the cohort mode, with n_seqs).  Positions at or
    past n read as N.  Returns (values int32 [T, m], valid bool [T, m],
    size, wv bool [m], cnt int32 [T, m] or None): cnt, the counts with 0
    where the window is invalid, only ``want_counts``.  A CUDA tensor
    launches csrc/window_counts.cu (equal to the plain version bit for
    bit), a CPU tensor takes window_values_plain.
    """
    global window_counts_launches
    if flat_c.device.type == "cpu":
        return window_values_plain(flat_c, flat_kv, flat_v, tracked, k,
                                   window, lo, hi, seg, n_seqs, want_counts)
    _check_window_inputs(flat_c, flat_kv, flat_v, tracked, k, window, lo, hi,
                         seg, n_seqs)
    if flat_c.device.type != "cuda":
        raise ValueError(f"window_values: unsupported device {flat_c.device}")
    flats = [flat_c, flat_kv, flat_v, tracked] + ([] if seg is None else [seg])
    if not all(x.is_contiguous() for x in flats):
        raise ValueError("window_values: inputs must be contiguous")
    dev, m, T = flat_c.device, hi - lo, tracked.shape[0]
    stride = T * (window + 2)  # the bins of one scaffold
    nbins = stride * (1 if seg is None else int(n_seqs))
    if nbins >= 1 << 31:
        raise ValueError(f"window_values: {nbins} bins, not below 2^31")
    values = torch.empty((T, m), dtype=torch.int32, device=dev)
    valid = torch.empty((T, m), dtype=torch.bool, device=dev)
    wv = torch.empty(m, dtype=torch.bool, device=dev)
    cnt = (torch.empty((T, m), dtype=torch.int32, device=dev)
           if want_counts else None)
    size = -(-nbins // 128) * 128
    if m == 0:
        return values, valid, size, wv, cnt

    def at(x, i=0):
        return ctypes.c_void_p(x.data_ptr() + i * x.element_size())

    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.kst_window_counts(
            at(flat_c, lo), at(flat_kv, lo), at(flat_v, lo),
            flat_c.shape[0] - lo, at(tracked), T, k, window, m,
            ctypes.c_void_p(None) if seg is None else at(seg, lo),
            stride, at(values), at(valid), at(wv),
            ctypes.c_void_p(None) if cnt is None else at(cnt),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, "kst_window_counts")
    window_counts_launches += 1
    return values, valid, size, wv, cnt


def windowed_counts_device(
    codes2d: torch.Tensor,
    kmer_valid2d: torch.Tensor,
    valid2d: torch.Tensor,
    tracked,
    k: int,
    window: int,
    with_positions: bool = False,
    start_limit: int | None = None,
    seg2d: torch.Tensor | None = None,
    n_seqs: int | None = None,
):
    """Per-window occurrence counts + distributions for tracked k-mers.

    codes2d/kmer_valid2d: end-position blocked codes ([nb, B]).
    valid2d: non-N mask. tracked: [n_tracked] codes (a tensor, or anything
    torch.as_tensor takes).
    Returns (dist [window+1, n_tracked] int32,
             counts_pos [n_tracked, n] int16 or None,
             window_valid [n] bool) — counts_pos[w, t] is the count for the
    window starting at t (0 where invalid), matching the reference's
    kmer_counts_pos matrices.

    start_limit: treat window starts >= this position as invalid — the
    chunked streaming engine (parallel/window_stream.py) feeds each chunk
    with a ``window``-base lookahead and masks starts beyond the chunk so
    every window is counted exactly once across chunks.

    seg2d/n_seqs: per-sequence mode for many-scaffold batches (the
    reference's mclapply workload, test.R:553-567): scaffolds concatenate
    with single-N separators (no window survives a separator), seg2d
    carries each position's scaffold id, and the count histogram runs
    over combined (scaffold, kmer, count) indices, one call for the whole
    cohort.  dist is then [n_seqs, window+1, n_tracked].
    """
    n = codes2d.numel()
    dev = codes2d.device
    if with_positions and window + 2 > 32767:
        raise ValueError("positions matrix is int16; window too large")
    flat_c = codes2d.reshape(-1)
    flat_kv = kmer_valid2d.reshape(-1)
    flat_v = valid2d.reshape(-1)
    seg = None if seg2d is None else seg2d.reshape(-1)
    tr = torch.as_tensor(tracked, device=dev).to(flat_c.dtype)
    T = tr.shape[0]
    W2 = window + 2
    S = 1 if seg is None else int(n_seqs)
    dist_flat = None
    counts_pos = (torch.zeros((T, n), dtype=torch.int16, device=dev)
                  if with_positions else None)
    window_valid = torch.zeros(n, dtype=torch.bool, device=dev)
    starts = n if start_limit is None else max(0, min(n, start_limit))
    for lo in range(0, starts, GROUP):
        hi = min(starts, lo + GROUP)
        values, valid, size, wv, cnt = window_values(
            flat_c, flat_kv, flat_v, tr, k, window, lo, hi, seg, n_seqs,
            want_counts=counts_pos is not None)
        window_valid[lo:hi] = wv
        if cnt is not None:
            counts_pos[:, lo:hi] = cnt
        del cnt
        # a window's count moves by at most one from its neighbour's
        h = histogram.histogram(values, valid, size, "repeats")
        dist_flat = h if dist_flat is None else dist_flat + h
    if dist_flat is None:
        dist_flat = torch.zeros(S * T * W2, dtype=torch.int32, device=dev)
    dist = dist_flat[:S * T * W2].reshape(S, T, W2)[:, :, :window + 1]
    dist = dist.transpose(1, 2).contiguous()
    return (dist if seg is not None else dist[0]), counts_pos, window_valid
