"""Host finisher of the k >= 10 pm pipeline: copies of the reference's.

Copies of ``kmer_spans_tpu/spans/pm_pipeline.py``'s host code
(unpack_pm_outputs, _pm_host_tables, finish_pm_spans), which cannot be
imported without JAX: that module imports spans/pipeline.py, which pulls
in the Pallas kernels.  They differ in the imports and in the replay:
every candidate stretch folds through spans/extract.py
``extract_spans`` (the host library).  Both code widths are
decoded: narrow (10 <= k <= 15) and wide (16 <= k <= 23, two seed words a
candidate block and the list as (hi, lo) pairs).
tests/test_torch_pm_pipeline.py and tests/test_torch_wide.py hold every
copy equal to its original on the same inputs.

The host needs no spectrum: candidate ranks come from the pulled pm
values and the device's value histogram through the reference's exact
f64 chain (stats/ranks.py chain_ranks_from_mass), so emitted scores are
bit-identical to the sequential reference.
"""

from __future__ import annotations

import numpy as np

from ..ops.gather import SCREEN_SCALE
from ..stats.ranks import chain_ranks_from_mass
from .extract import extract_spans
from .finish import (
    SpanPipelineResult,
    compose_summaries_exact,
    rebuild_codes,
    rebuild_codes_wide,
)


def unpack_pm_outputs(vec, n: int, meta: dict) -> dict:
    """Decode the packed pm-pipeline vector into the finisher dict."""
    v = np.asarray(vec)
    block = meta["block"]
    cap = meta["list_cap"]
    nb = n // block
    C = min(meta["cand_blocks"], nb)
    off = 0

    def take(m):
        nonlocal off
        out = v[off:off + m]
        off += m
        return out

    total = int(take(1)[0])
    tA = take(nb)
    tB = take(nb)
    maxA = take(nb)
    maxB = take(nb)
    top_idx = take(C)
    sc_words = take(C * (block // 32)).copy().view(np.uint32)
    scored = (
        (sc_words[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    ).astype(bool).reshape(C, block)
    seeds = 2 if meta["wide"] else 1
    cand_words = take(C * (seeds + block // 16)).copy().view(
        np.uint32).reshape(C, seeds + block // 16)
    pm = take(C * block).reshape(C, block)
    vh = take(meta["nbins"])
    out = {
        "total": total, "tA": tA, "tB": tB, "maxA": maxA, "maxB": maxB,
        "top_idx": top_idx, "scored": scored, "cand_words": cand_words,
        "pm": pm, "vh": vh,
    }
    if meta["wide"]:
        lh = take(cap).astype(np.int64)
        ll = take(cap).astype(np.int64)
        out["list_codes"] = np.where(lh < 0, -1, (lh << 16) | ll)
    else:
        out["list_codes"] = take(cap).astype(np.int64)
    out["list_v"] = take(cap).astype(np.int64)
    out["list_count"] = int(take(1)[0])
    out["t_list"] = int(take(1)[0])
    assert off == v.shape[0], (off, v.shape)
    return out


def _pm_host_tables(out: dict, t_list: int):
    """Exact sparse value histogram + per-listed-code pm from the pull.

    Returns (v_vals, n_codes, list_codes_sorted, list_pm_sorted) or
    raises on any cross-check failure (loud, never silent):
      * list capacity overflow is the caller's fallback (checked there);
      * sum(v * n_v) must equal the counted total.
    """
    total = out["total"]
    vh = out["vh"].astype(np.int64)
    keep = out["list_codes"] >= 0
    lc = out["list_codes"][keep]
    lv = out["list_v"][keep]
    small_v = np.arange(1, t_list, dtype=np.int64)
    small_n = vh[1:t_list]
    uv, un = np.unique(lv, return_counts=True)
    nz = small_n > 0
    v_vals = np.concatenate([small_v[nz], uv])
    n_codes = np.concatenate([small_n[nz], un])
    mass_total = int((v_vals * n_codes).sum())
    if mass_total != total:
        raise AssertionError(
            f"pm screen mass mismatch: {mass_total} != total {total} "
            "(list extraction or histogram bug)")
    # exact pm of listed codes: below the list sits every unlisted run
    below_base = int((small_v * small_n).sum())
    order = np.lexsort((lc, lv))
    pm_sorted = below_base + np.concatenate(
        [[0], np.cumsum(lv[order])[:-1]])
    pm_entry = np.empty(lc.shape[0], np.int64)
    pm_entry[order] = pm_sorted
    corder = np.argsort(lc, kind="stable")
    return v_vals, n_codes, lc[corder], pm_entry[corder]


def finish_pm_spans(
    out: dict,
    n: int,
    meta: dict,
    thr: float,
    min_width: int,
    min_score: float,
    seq_id: int = 0,
) -> SpanPipelineResult:
    """Host finisher: exact candidacy + exact f64 replay from device pm.

    No spectrum input of any kind: candidate ranks come from
    chain_ranks_from_mass over the pulled pm values and the
    device-emitted value histogram — bit-identical to the reference's
    sequential chain (src/kmer_spans.c:198-202).  fallback=True when
    the top-C gather missed a candidate run OR the run list overflowed.
    """
    block = meta["block"]
    k = meta["k"]
    if out["list_count"] > meta["list_cap"]:
        return SpanPipelineResult(regions=[], fallback=True)
    block_max, block_last = compose_summaries_exact(
        out["tA"], out["tB"], out["maxA"], out["maxB"])
    top_idx = np.asarray(out["top_idx"])
    nb = block_max.shape[0]
    linked = np.zeros(nb, bool)
    linked[1:] = block_last[:-1] > 0
    starts = np.nonzero(~linked)[0]
    run_of = np.cumsum(~linked) - 1
    run_max = np.maximum.reduceat(block_max, starts)[run_of]
    cand = run_max >= float(min_score) * SCREEN_SCALE
    if not cand.any():
        return SpanPipelineResult(regions=[], fallback=False)
    have = np.zeros(nb, bool)
    have[top_idx] = True
    if (cand & ~have).any():
        return SpanPipelineResult(regions=[], fallback=True)

    v_vals, n_codes, lcodes, lpm = _pm_host_tables(out, out["t_list"])
    total = out["total"]
    pos_in_pull = {int(b): i for i, b in enumerate(top_idx)}
    scored = np.asarray(out["scored"])
    cand_words = np.asarray(out["cand_words"])
    pm_rows = np.asarray(out["pm"])

    # resolve pm for every scored candidate position (device value, or
    # list lookup for sentinel -1), then ranks for the distinct pm set
    rows_all = sorted({pos_in_pull[b] for b in np.nonzero(cand)[0]})
    if meta["wide"]:
        codes_all = rebuild_codes_wide(cand_words[rows_all], k, block)
    else:
        codes_all = rebuild_codes(cand_words[rows_all], k, block).astype(
            np.int64)
    pm_all = pm_rows[rows_all].astype(np.int64)
    sc_all = scored[rows_all]
    need = (pm_all < 0) & sc_all
    if need.any():
        qi = np.searchsorted(lcodes, codes_all[need])
        qi = np.minimum(qi, max(len(lcodes) - 1, 0))
        if len(lcodes) == 0 or not np.array_equal(
                lcodes[qi], codes_all[need]):
            raise AssertionError(
                "sentinel-pm candidate code missing from the run list "
                "(list extraction bug)")
        pm_all[need] = lpm[qi]
    uniq_pm = np.unique(pm_all[sc_all]) if sc_all.any() else \
        np.zeros(0, np.int64)
    ranks_u = chain_ranks_from_mass(uniq_pm, (v_vals, n_codes), total) \
        if uniq_pm.size else np.zeros(0)
    row_of = {r: i for i, r in enumerate(rows_all)}

    regions = []
    i = 0
    while i < nb:
        if not cand[i]:
            i += 1
            continue
        j = i
        while j + 1 < nb and cand[j + 1]:
            j += 1
        rr = [row_of[pos_in_pull[b]] for b in range(i, j + 1)]
        sc_flat = sc_all[rr].reshape(-1)
        pm_flat = pm_all[rr].reshape(-1)
        qi = np.searchsorted(uniq_pm, np.where(sc_flat, pm_flat, 0))
        qi = np.minimum(qi, max(uniq_pm.size - 1, 0))
        s_flat = np.where(sc_flat, ranks_u[qi] - thr, 0.0)
        regions.extend(extract_spans(s_flat, sc_flat, min_width, min_score,
                                     seq_id=seq_id, base_pos=i * block))
        i = j + 1
    return SpanPipelineResult(regions=regions, fallback=False)
