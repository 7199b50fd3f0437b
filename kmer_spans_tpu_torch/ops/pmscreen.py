"""Exact-mass sort screen for 10 <= k <= 23: every position's rank mass pm.

Counterpart of ``kmer_spans_tpu/ops/pmscreen.py`` (which imports JAX, so
the port keeps its own copy of the pure-Python strategy and layout
parameters; tests/test_torch_pmscreen.py holds them equal).

A position's exact cumulative mass pm (the integer numerator of the
reference's weighted rank, src/kmer_spans.c:189-202: the total count of
k-mers sorted strictly before its own under (count asc, code asc)) is the
START INDEX of its run when the positions are ordered by (count, code).
One stable sort by code gives each position its run length v (its k-mer's
exact count); then either

* "packed": a second stable sort by the key (min(v, 2^b - 1) << 2k) | code,
  b = 32 - 2k, orders (count, code) exactly for unclipped runs, and pm is
  the run's start index; clipped runs get pm = -1; or
* "smallv": one running count per value t < t_list gives
  pm = below(t) + t * (# earlier runs of count t); runs with v >= t_list
  get pm = -1.

Runs that got pm = -1 with v >= t_list ship as (code, v) records in a
fixed-capacity list, and every run's count feeds the run-value histogram
(K3, ops/histogram.py); the host rebuilds the exact pm of listed codes
and the value multiset from these alone (spans/pm_finish.py).

Sorts, cumsums and scans are library calls (torch.sort(stable=True) where
the reference's lax.sort is stable).  The packed key is built in int64:
torch has no CUDA sort for uint32, and int64 keeps the uint32 order.

Wide codes (16 <= k <= 23, pm_sort_screen_wide) sort as one int64 key,
where the reference sorts its (hi, lo) int32 pair with two keys; the
order, and so every output, is the same.

One deliberate difference: ``_extract_list``'s group-min compaction uses
groups of G = the largest power of two <= min(t_list, 8) positions, where
the reference takes G = 4 for every t_list < 8.  Flagged run heads sit at
least t_list apart, so only G <= t_list keeps one head per group; at
k = 15 with the packed strategy (t_list = 3) the reference's G = 4 can put
two heads in one group and lose a list record.
"""

from __future__ import annotations

import math

import torch

from . import histogram
from .blocked import WIDE_MAX_K
from .gather import SCREEN_SCALE

#: smallv strategy: values 1..SMALLV_T-1 get exact device pm via
#: per-value cumsums; runs with v >= SMALLV_T go to the list
SMALLV_T = 4
#: default list capacities (overflow -> flagged fallback)
PM_CAP_PACKED = 8192
PM_CAP_SMALLV = 1 << 17

#: the packed key's sentinel for invalid positions (sorts last)
_SENTINEL = 0xFFFFFFFF
_NO_INDEX = 0x7FFFFFFF


def pm_strategy(k: int) -> str:
    """Default strategy for narrow codes ignoring n (see choose_params)."""
    if not 10 <= k <= 15:
        raise ValueError("pm screen needs 10 <= k <= 15 (narrow codes)")
    return "packed" if k <= 14 else "smallv"


def _pois_tail(lam: float, t: int) -> float:
    """P(Poisson(lam) >= t), summed directly (t <= ~16 here)."""
    if lam <= 0:
        return 0.0
    if lam > 60:  # tail ~ 1 for any t <= 16
        return 1.0
    p = math.exp(-lam)
    cdf = p
    for i in range(1, t):
        p *= lam / i
        cdf += p
    return max(0.0, 1.0 - cdf)


def pm_cap(k: int) -> int:
    """Static list capacity per k (unpack layout must not depend on n)."""
    return PM_CAP_PACKED if k <= 12 else PM_CAP_SMALLV


def choose_params(k: int, n: int, wide: bool = False):
    """(strategy, t_list) chosen from the length n.

    smallv is taken whenever the expected number of runs with v >= T
    fits the list comfortably: with lam = n / 4^k, E[#codes v >= T] =
    4^k * P(Pois(lam) >= T), and the smallest T in [SMALLV_T, 13] with
    E <= cap / 8 wins.  Repeat-heavy inputs can still overflow the list at
    run time; that is flagged, never silent.  No usable T -> the packed
    key (k <= 14; k = 15 and wide codes take T = 13).
    """
    size = float(4 ** k)
    lam = n / size
    cap = PM_CAP_SMALLV if (wide or k >= 13) else pm_cap(k)
    if wide or k >= 13:
        for t in range(SMALLV_T, 14):
            if size * _pois_tail(lam, t) <= cap / 8:
                return "smallv", t
    if wide or k > 14:
        return "smallv", 13
    b = 32 - 2 * k
    return "packed", min(1 << b, 4096) - 1


def pm_params(k: int, strategy: str | None = None, n: int | None = None,
              wide: bool = False):
    """(strategy, t_list, stride, nbins, cap) for a pm screen build.

    t_list: runs with v >= t_list ship in the explicit list (for the
    packed strategy also the key clip, capped at 4095); stride: the
    decimation step of the packed extractor (<= t_list, a power of two;
    smallv uses the index compaction); nbins: value-histogram bins
    (covering [0, t_list]); cap: static per-k list capacity.
    """
    if strategy is None:
        if n is not None:
            strategy, t_list = choose_params(k, n, wide)
        else:
            strategy = "smallv" if wide else pm_strategy(k)
            t_list = None
    else:
        t_list = None
    if t_list is None:
        if strategy == "packed":
            t_list = min(1 << (32 - 2 * k), 4096) - 1
        else:
            t_list = SMALLV_T
    cap = PM_CAP_SMALLV if (wide or k >= 13) else pm_cap(k)
    stride = (4 if strategy == "smallv"
              else max(1, 1 << (max(t_list, 1).bit_length() - 1)))
    nbins = max(min((1 << (32 - 2 * k)) if not wide and k <= 12 else 256,
                    4096), 256)
    return strategy, t_list, stride, nbins, cap


def _first_in_run(x: torch.Tensor) -> torch.Tensor:
    """Run-head flags of a sorted 1-D tensor (the first element is one)."""
    head = torch.ones_like(x, dtype=torch.bool)
    head[1:] = x[1:] != x[:-1]
    return head


def _runs(head: torch.Tensor):
    """(run of each position, int64; start index of each run, int64).

    The reference takes a run's start as a running max of head indices
    (lax.cummax).  torch's cummax walks a 1-D tensor in one thread block:
    730 ms at 2^28 on an H100, against 8 ms for this compaction of the
    head indices plus a cumsum.
    """
    return torch.cumsum(head, 0) - 1, torch.nonzero(head).squeeze(1)


def _run_lengths(head: torch.Tensor) -> torch.Tensor:
    """Exact int32 run lengths from head flags over a sorted axis."""
    run, starts = _runs(head)
    ends = torch.cat([starts[1:], starts.new_full((1,), head.shape[0])])
    return (ends - starts).to(torch.int32)[run]


def sorted_runs(codes: torch.Tensor, kmer_valid: torch.Tensor, k: int):
    """Stable code sort of the positions, and the runs of equal codes.

    codes: int32 (k <= 15) or int64 wide codes (16 <= k <= 23).
    Returns (skey, spos, head, v, real): codes in sorted order (invalid
    positions as 4^k, last; 2^46 at k = 23), their genome positions
    (int64), run-head flags, run lengths (int32; a run's length is its
    k-mer's count) and not-invalid flags.
    """
    size = 1 << (2 * k)
    key = torch.where(kmer_valid, codes, size).to(
        torch.int32 if k <= 15 else torch.int64)
    skey, spos = torch.sort(key, stable=True)
    head = _first_in_run(skey)
    return skey, spos, head, _run_lengths(head), skey < size


def _extract_list(skey, v, head, real, t_list: int, stride: int, cap: int):
    """Fixed-capacity (code, v) records of every run with v >= t_list.

    skey: codes in sorted order (int32, or int64 wide codes); v: run
    lengths; head/real: run-head flags / not-sentinel.  Returns
    (list_codes of skey's dtype, list_v, count int32): records in code
    order, entries beyond the captured runs -1/-1, and the TRUE number of
    qualifying runs (overflow check).

    Two mechanisms with one contract:
      * stride >= 8 (packed strategy, k <= 14): decimate the sorted order
        by stride <= t_list (every qualifying run, of length >= t_list, is
        sampled), flag the first sample of each qualifying run, and
        compact with one stable sort of (flag-first, code);
      * stride < 8: the min index over each group of G positions, G the
        largest power of two <= min(t_list, 8), holds the one flagged run
        head the group can hold; one sort of those minima compacts.
    """
    n = v.shape[0]
    dev = v.device
    flag_full = head & real & (v >= t_list)
    count = flag_full.sum(dtype=torch.int32)
    if stride < 8:
        G = 1 << (min(t_list, 8).bit_length() - 1)
        while n % G:  # callers use block-multiple n; guard odd sizes
            G //= 2
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        masked = torch.where(flag_full, idx, _NO_INDEX)
        m = masked.reshape(n // G, G).amin(1) if G > 1 else masked
        sel = torch.sort(m).values[:cap]
        if n // G < cap:  # fixed output shape for short inputs
            sel = torch.cat([sel, sel.new_full((cap - n // G,), _NO_INDEX)])
        got = sel < n
        selc = torch.clamp(sel, max=n - 1).long()
        return (torch.where(got, skey[selc], -1),
                torch.where(got, v[selc], -1), count)
    dec = skey[::stride]
    vdec = v[::stride]
    flag = _first_in_run(dec) & real[::stride] & (vdec >= t_list)
    fkey = (~flag).to(torch.int64)
    order = torch.sort((fkey << 47) | dec.to(torch.int64), stable=True).indices
    got = flag[order[:cap]]  # flagged entries lead the order
    lc = dec[order[:cap]]
    lv = vdec[order[:cap]]
    pad = cap - lc.shape[0]
    if pad > 0:
        got = torch.cat([got, got.new_zeros(pad)])
        lc = torch.cat([lc, lc.new_zeros(pad)])
        lv = torch.cat([lv, lv.new_zeros(pad)])
    return torch.where(got, lc, -1), torch.where(got, lv, -1), count


def _pm_packed(skey, spos, v, real, k: int):
    """Packed-key second sort -> exact pm for unclipped runs (-1 at clip).

    Returns pm in the (v, code) sorted order, with the genome positions
    in that order.
    """
    vclip = (1 << (32 - 2 * k)) - 1
    pkey = (torch.clamp(v, max=vclip).to(torch.int64) << (2 * k)) \
        | skey.to(torch.int64)
    pkey = torch.where(real, pkey, _SENTINEL)
    pk2, perm = torch.sort(pkey, stable=True)
    run, starts = _runs(_first_in_run(pk2))
    start2 = starts.to(torch.int32)[run]
    clipped = (pk2 >> (2 * k)) == vclip
    return torch.where(clipped, -1, start2), spos[perm]


def _pm_smallv(v, head, real, t_list: int):
    """Exact pm for v < t_list via per-value running counts (code order).

    pm = below(v) + v * eqbelow(c): eqbelow = # earlier runs of the same
    count, which in code order is a running count per value; below(v),
    the mass of all smaller counts, is a scalar.  v >= t_list and
    sentinel positions get -1.
    """
    h = head & real
    pm = torch.full(v.shape, -1, dtype=torch.int32, device=v.device)
    below = torch.zeros((), dtype=torch.int32, device=v.device)
    for t in range(1, t_list):
        eq = v == t
        ct = torch.cumsum(h & eq, 0, dtype=torch.int32)
        pm = torch.where(real & eq, below + t * (ct - 1), pm)
        below = below + t * ct[-1]
    return pm


def pm_sort_screen(codes, kmer_valid, k: int, list_cap: int | None = None,
                   strategy: str | None = None) -> dict:
    """Exact-mass screen for narrow codes (10 <= k <= 15).

    codes: int32 [n] raw rolling codes (junk where invalid); kmer_valid:
    bool [n].  Returns a dict of tensors on the input's device:
      pm [n] int32, genome order: exact cumulative mass, -1 where the
          host must resolve it through the list (junk where invalid);
      total: int32, the counted k-mers;
      vh [nbins] int32: runs per count value (bin min(v, nbins - 1));
      list_codes/list_v [cap] int32: runs with v >= t_list, -1 padded;
      list_count: int32, the TRUE qualifying-run count (overflow check);
      t_list: python int, the list threshold.
    """
    strategy, t_list, stride, nbins, cap = pm_params(
        k, strategy, n=int(codes.shape[0]))
    return _screen(codes, kmer_valid, k, strategy, t_list, stride, nbins,
                   list_cap or cap)


def pm_sort_screen_wide(codes, kmer_valid, k: int,
                        list_cap: int | None = None) -> dict:
    """Exact-mass screen for wide codes (16 <= k <= 23): smallv always,
    since 4^k >> n makes the counts sparse.

    codes: int64 [n] wide codes (ops/blocked.py blocked_codes_wide, junk
    where invalid).  One stable int64 sort replaces the reference's
    2-key sort of (hi, lo).  The dict is pm_sort_screen's with the list
    codes in the reference's int32 layout, list_hi = code >> 16 and
    list_lo = code & 0xFFFF, both -1 where a slot is empty.
    """
    if not 16 <= k <= WIDE_MAX_K:
        raise ValueError(f"wide codes need 16 <= k <= {WIDE_MAX_K}, got {k}")
    _, t_list, stride, nbins, cap = pm_params(
        k, None, n=int(codes.shape[0]), wide=True)
    scr = _screen(codes, kmer_valid, k, "smallv", t_list, stride, nbins,
                  list_cap or cap)
    lc = scr.pop("list_codes")
    got = lc >= 0
    return {
        "pm": scr["pm"], "total": scr["total"], "vh": scr["vh"],
        "list_hi": torch.where(got, lc >> 16, -1).to(torch.int32),
        "list_lo": torch.where(got, lc & 0xFFFF, -1).to(torch.int32),
        "list_v": scr["list_v"], "list_count": scr["list_count"],
        "t_list": t_list,
    }


def _screen(codes, kmer_valid, k: int, strategy: str, t_list: int,
            stride: int, nbins: int, cap: int) -> dict:
    """The screen of both code widths: sort, runs, K3, pm and the list."""
    skey, spos, head, v, real = sorted_runs(codes, kmer_valid, k)
    total = kmer_valid.sum(dtype=torch.int32)
    vh = histogram.histogram(
        torch.clamp(v, max=nbins - 1), head & real, nbins, kind="runs")
    if strategy == "packed":
        pm_s, spos_s = _pm_packed(skey, spos, v, real, k)
    else:
        pm_s, spos_s = _pm_smallv(v, head, real, t_list), spos
    lc, lv, count = _extract_list(skey, v, head, real, t_list, stride, cap)
    del skey, head, v, real
    pm = torch.empty_like(pm_s)
    pm[spos_s] = pm_s  # back to genome order (spos_s is a permutation)
    return {
        "pm": pm, "total": total, "vh": vh,
        "list_codes": lc, "list_v": lv, "list_count": count,
        "t_list": t_list,
    }


def pm_scores_int(pm, total, thr_q):
    """Sound integer screen scores from exact pm (units of 2^-12 rank).

    s_int = trunc(f32(pm) * f32(SCREEN_SCALE / max(f32(total), 1)))
    + 3 - thr_q, an upper bound of SCREEN_SCALE * (rank - thr); pm < 0
    (listed or clipped runs, high counts) scores as rank 1.  The f32
    operation order is the reference's, step for step.
    """
    total_f = torch.clamp(total.to(torch.float32), min=1.0)
    # a tensor quotient: `number / tensor` would multiply by a reciprocal
    scale = torch.full_like(total_f, SCREEN_SCALE) / total_f
    q = (pm.to(torch.float32) * scale).to(torch.int32)
    s = q + 3 - thr_q
    return torch.where(pm < 0, SCREEN_SCALE + 3 - thr_q, s).to(torch.int32)
