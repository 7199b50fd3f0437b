"""Plain NumPy and PyTorch reference of ``kmer_low_comp_regions`` (exact
mode).

Written from the C reference's contract (lmjakt/kmer_spans,
src/kmer_spans.c: ``sequence_kmer_count`` :135-155, ``rank_kmers_w``
:189-202, ``kmer_regions`` :243-307, ``kmer_low_comp_regions`` :548-621),
independent of the program under test, and imports nothing of it:

  * the spectrum counts every k-mer inside each N-free stretch of each
    sequence, over all sequences together; ``n`` is their number;
  * a k-mer's weight is the share of counted mass strictly before it when
    the spectrum is sorted by (count, k-mer index), accumulated left to
    right in the working precision: ``r += counts[prev] / n``;
  * the span caller scores the end positions of the k-mers of each N-free
    stretch but its last, with s = weight - thr and
    S_i = max(S_{i-1} + s_i, 0) from 0 at the stretch's start.  A
    candidate runs from the first positive position to the first position
    of its maximum; when S returns to 0, or at the stretch's end, it is
    emitted if (end - beg >= min_w and max >= min_score), and then scoring
    restarts from 0 at the position after its maximum.

The fold is sequential, so every value of S is computed by adding the
scores one at a time in order, in the working precision, never from
prefix differences (see ``fold``).  A restart after an emission stays
within the emitted candidate's excursion: addition is monotone, so a fold
started from 0 there reaches 0 where the first one did, and from there
on both agree.  The restarts are therefore folded level by level, each
level over the tails that the level before emitted.

The integer work (the spectrum, the sort of the weights' chain) may run
on the card with torch; every floating-point step runs on the host with
NumPy, whose cumsum adds in order.

Coordinates: a region's ``beg`` and ``end`` are the 1-based positions of
the last base of the k-mer at its first positive and its first maximum
position.  ``dtype`` is the working precision of weights and scores:
float64 as the reference states, float32 for the control.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

#: positions whose k-mers are built and scored at once
_BATCH = 1 << 23
#: bounds of the fold's chunk width
_MIN_WIDTH, _MAX_WIDTH = 64, 4096

REGION_DTYPE = np.dtype([("seq_id", np.int64), ("beg", np.int64),
                         ("end", np.int64), ("score", np.float64)])


def stretches(valid: np.ndarray) -> list[tuple[int, int]]:
    """[a, b) of each maximal run of True in ``valid``."""
    v = np.concatenate([[False], np.asarray(valid, bool), [False]])
    edges = np.flatnonzero(v[1:] != v[:-1])
    return list(zip(edges[0::2].tolist(), edges[1::2].tolist()))


def _codes(b, k: int):
    """Codes of the k-mers of one N-free stretch by start position, from
    its bases as int32 (a numpy array or a torch tensor): base values
    concatenated two bits each, first base highest.  Codes of k = 2^i are
    built from those of 2^(i-1); others join two of them."""
    by_len = {1: b}
    j = 1
    while 2 * j <= k:
        c = by_len[j]
        by_len[2 * j] = (c[:-j] << (2 * j)) | c[j:]
        j *= 2
    codes, done = by_len[j], j
    while done < k:
        part = 1 << ((k - done).bit_length() - 1)
        n = codes.shape[0] - part
        codes = (codes[:n] << (2 * part)) | by_len[part][done:done + n]
        done += part
    return codes[:b.shape[0] - k + 1]


def kmer_codes(bases: np.ndarray, k: int) -> np.ndarray:
    """int32 codes of the k-mers of one N-free stretch, by start position."""
    return _codes(bases.astype(np.int32), k)


def _groups(seqs, k: int) -> list[list[tuple[int, int, np.ndarray]]]:
    """(seq_id, start, bases) of each N-free stretch of at least k bases,
    grouped so that a group spans about _BATCH positions."""
    groups, group, size = [], [], 0
    for sid, (bases, valid) in enumerate(seqs):
        for a, b in stretches(valid):
            if b - a < k:
                continue
            group.append((sid, a, bases[a:b]))
            size += b - a
            if size >= _BATCH:
                groups.append(group)
                group, size = [], 0
    if group:
        groups.append(group)
    return groups


def _map(fn, tasks, workers: int, initializer=None, initargs=()):
    """fn over the tasks, in order: in this process, or in ``workers``
    spawned processes that have all ended when this returns."""
    if workers <= 1 or len(tasks) <= 1:
        if initializer is not None:
            initializer(*initargs)
        return [fn(*t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(min(workers, len(tasks)), mp_context=ctx,
                             initializer=initializer,
                             initargs=initargs) as pool:
        return list(pool.map(fn, *zip(*tasks)))


def spectrum(seqs, k: int, device="cpu") -> tuple[np.ndarray, int]:
    """(counts int64 [4^k], n): every k-mer of every N-free stretch,
    counted with torch.bincount on ``device`` (integers: exact anywhere)."""
    import torch
    counts = torch.zeros(1 << (2 * k), dtype=torch.int64, device=device)
    for bases, valid in seqs:
        for a, b in stretches(valid):
            if b - a < k:
                continue
            stretch = torch.from_numpy(bases[a:b]).to(device, torch.int32)
            counts += torch.bincount(_codes(stretch, k),
                                     minlength=counts.shape[0])
    out = counts.cpu().numpy()
    return out, int(out.sum())


def weighted_ranks(counts: np.ndarray, n: int, dtype=np.float64,
                   device="cpu"):
    """Each k-mer's share of the mass before it, in the sorted order (a
    stable sort on ``device``: ties keep the k-mer index order), summed on
    the host in order."""
    import torch
    counts = np.asarray(counts, np.int64)
    ranks = np.zeros(counts.shape[0], dtype)
    if n == 0:
        return ranks
    order = torch.sort(torch.from_numpy(counts).to(device),
                       stable=True).indices.cpu().numpy()
    terms = counts[order[:-1]].astype(dtype) / dtype(n)
    chain = np.empty(counts.shape[0], dtype)
    chain[0] = 0
    np.cumsum(terms, out=chain[1:])
    ranks[order] = chain
    return ranks


def _transpose(a: np.ndarray) -> np.ndarray:
    """a.T in C order, copied a strip of 16 rows at a time (cache-kind)."""
    out = np.empty(a.shape[::-1], a.dtype)
    for r in range(0, a.shape[0], 16):
        out[:, r:r + 16] = a[r:r + 16].T
    return out


def fold(s: np.ndarray, range_starts: np.ndarray) -> np.ndarray:
    """S of the sequential fold S_i = max(S_{i-1} + s_i, 0), from 0 at
    each index of ``range_starts`` (sorted, the first 0).

    The elements are cut into chunks of about sqrt(n).  First every chunk is
    folded from 0, all chunks at once, one position of each per step (so
    every value is added in order).  Then, chunk by chunk in order, a
    chunk entered with S > 0 is folded again from that S with np.cumsum
    (in order too) up to its first zero or forced restart: from there on
    a fold from 0 and a fold from more agree, since addition is monotone
    and both are 0 there."""
    n = s.shape[0]
    dtype = s.dtype
    width = min(max(int(np.sqrt(n)), _MIN_WIDTH), _MAX_WIDTH)
    nc = -(-n // width)
    flat = np.zeros(nc * width, dtype)
    flat[:n] = s
    s2 = flat.reshape(nc, width)
    keep = np.ones(nc * width, dtype)
    keep[range_starts] = 0
    keep = keep.reshape(nc, width)
    s_t = _transpose(s2)
    keep_t = _transpose(keep)
    out_t = np.empty_like(s_t)
    run = np.zeros(nc, dtype)
    for j in range(width):
        np.multiply(run, keep_t[j], out=run)
        np.add(run, s_t[j], out=run)
        np.maximum(run, 0, out=run)
        out_t[j] = run
    out = _transpose(out_t)
    restarts = keep == 0
    first_restart = np.where(restarts.any(axis=1), restarts.argmax(axis=1),
                             width).tolist()
    ends = out[:, -1].tolist()
    carry = dtype.type(0)
    for c in range(nc):
        lim_r = first_restart[c]
        if carry > 0 and lim_r > 0:
            m = min(64, lim_r)
            while True:
                head = np.empty(m + 1, dtype)
                head[0] = carry
                head[1:] = s2[c, :m]
                cs = np.cumsum(head)[1:]
                z = np.flatnonzero(cs <= 0)
                if z.size or m == lim_r:
                    lim = int(z[0]) if z.size else m
                    break
                m = min(4 * m, lim_r)
            out[c, :lim] = cs[:lim]
            if lim == width:
                carry = cs[-1]
                continue
        carry = dtype.type(ends[c])
    return out.reshape(-1)[:n]


def _level(s, pos, range_starts, seq_of, min_w, min_score):
    """Emissions of one level: (regions, and the next level's ranges as
    index arrays [a, e] into this level's elements)."""
    c = fold(s, range_starts)
    idx = np.flatnonzero(c > 0)
    empty = np.zeros(0, np.int64)
    if idx.size == 0:
        return [], empty, empty
    is_start = np.zeros(s.shape[0], bool)
    is_start[range_starts] = True
    new = np.ones(idx.size, bool)
    new[1:] = (np.diff(idx) != 1) | is_start[idx[1:]]
    first = np.flatnonzero(new)
    ex = np.cumsum(new) - 1
    cp = c[idx]
    peak = np.maximum.reduceat(cp, first)
    at_peak = np.flatnonzero(cp == peak[ex])
    first_of = np.ones(at_peak.size, bool)
    first_of[1:] = ex[at_peak[1:]] != ex[at_peak[:-1]]
    m = idx[at_peak[first_of]]
    a = idx[first]
    e = idx[np.append(first[1:], idx.size) - 1]
    beg, end = pos[a], pos[m]
    emit = (end - beg >= min_w) & (peak >= min_score)
    rng_of = np.searchsorted(range_starts, a, side="right") - 1
    regions = list(zip(seq_of[rng_of[emit]].tolist(), beg[emit].tolist(),
                       end[emit].tolist(), peak[emit].astype(np.float64)
                       .tolist()))
    tail = emit & (m < e)
    return regions, m[tail] + 1, e[tail]


def _gather_ranges(a: np.ndarray, e: np.ndarray):
    """(element index of every position of the ranges [a, e], the start
    of each range in that list)."""
    lens = e - a + 1
    starts = np.cumsum(lens) - lens
    return np.repeat(a - starts, lens) + np.arange(int(lens.sum())), starts


#: the weight table of a worker process (set once by its initializer)
_weights = None


def _set_weights(weights: np.ndarray) -> None:
    global _weights
    _weights = weights


def _regions_group(k, group, thr, min_w, min_score):
    """Regions of one group's stretches, with the weights of _set_weights."""
    parts, pos, starts, seq_of = [], [], [], []
    at = 0
    for sid, a, bases in group:
        if bases.shape[0] < k + 1:
            continue  # one k-mer: its stretch has no scored position
        codes = kmer_codes(bases, k)[:-1]
        parts.append(_weights[codes] - thr)
        pos.append(np.arange(a + k, a + bases.shape[0], dtype=np.int64))
        starts.append(at)
        seq_of.append(sid)
        at += codes.shape[0]
    out = []
    if not parts:
        return out
    s = np.concatenate(parts)
    pos = np.concatenate(pos)  # 1-based positions of the k-mers' ends
    range_starts = np.array(starts, np.int64)
    seq_of = np.array(seq_of, np.int64)
    while s.size:
        found, ta, te = _level(s, pos, range_starts, seq_of, min_w,
                               min_score)
        out.extend(found)
        owner = seq_of[np.searchsorted(range_starts, ta, side="right") - 1]
        take, range_starts = _gather_ranges(ta, te)
        s, pos, seq_of = s[take], pos[take], owner
    return out


def regions(seqs, k: int, weights: np.ndarray, thr: float, min_w: int,
            min_score: float, dtype=np.float64,
            workers: int = 1) -> np.ndarray:
    """The regions of every sequence, in (seq_id, beg) order."""
    weights = np.asarray(weights, dtype)
    tasks = [(k, g, dtype(thr), min_w, min_score)
             for g in _groups(seqs, k)]
    found = _map(_regions_group, tasks, workers, _set_weights, (weights,))
    res = np.array([r for part in found for r in part], REGION_DTYPE)
    return res[np.lexsort((res["beg"], res["seq_id"]))]


def low_comp_regions(seqs, k: int, min_w: int, min_score: float,
                     thr: float, dtype=np.float64, workers: int = 1,
                     device="cpu") -> dict:
    """Spectrum, weights and regions of ``kmer_low_comp_regions`` over the
    sequences, each a pair (2-bit bases uint8, validity bool): the counts
    and the sort on ``device``, the regions in ``workers`` processes."""
    counts, n = spectrum(seqs, k, device)
    w = weighted_ranks(counts, n, dtype, device)
    return {"counts": counts, "n": n, "w_rank": w,
            "regions": regions(seqs, k, w, thr, min_w, min_score, dtype,
                               workers)}
