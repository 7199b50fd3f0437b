"""Row-gather screen: per-position 8-bit rank classes from a precomputed
table at any k (the streaming scan's screen for k >= 10 and for every
weight model).

Counterpart of ``kmer_spans_tpu/ops/rowgather.py``.  The stream screens
each chunk against the global spectrum, so the sort screen (chunk-local
run lengths) does not apply: it needs a per-position table lookup.  The
tables are built on the host in numpy with the reference's f32/f64
operation order (``host_row_table``, ``host_row_table_weights``: copies,
byte for byte).  The lookup is a plain torch gather,
``tab.reshape(-1)[codes]``: the reference's (1, 128) row fetch, lane
select and slabbing work around v5e's scalar gather and are not ported,
and the TPU ran an XLA gather here, not a Pallas kernel.

Table entries are 8-bit classes (256 levels, uint8).  Soundness is the
class-table family: the class upper edge (cls+1)/256 is never below the
f32 rank the table was built from, and one f32 rounding is covered by the
+3/-1 slack (ops/gather.py class_scores_int at unit = SCREEN_SCALE/256).
"""

from __future__ import annotations

import numpy as np
import torch

from .gather import SCREEN_SCALE

#: 8-bit classes: 256 levels
ROW_LEVELS = 256
_UNIT = SCREEN_SCALE // ROW_LEVELS
_LANES = 128


def host_row_table(mass: np.ndarray, total: int) -> np.ndarray:
    """(4^k/128, 128) uint8 class table from exact int64 mass, on the host.

    class[c] = clip(floor(rank_f32 * 256), 0, 255) with rank = mass/total
    in f32: the one-f32-rounding-slack family of
    ops.gather.class_table_from_mass, at 256 levels.
    """
    rank = mass.astype(np.float32) / np.float32(max(total, 1))
    cls = np.clip((rank * ROW_LEVELS).astype(np.int32), 0, ROW_LEVELS - 1)
    return cls.astype(np.uint8).reshape(-1, _LANES)


def row_classes(tab2d: torch.Tensor, codes_flat: torch.Tensor):
    """Per-position classes: tab2d uint8 [R, 128], codes int32 [n] in
    [0, 128 R) -> int32 [n]."""
    return tab2d.reshape(-1)[codes_flat].to(torch.int32)


def row_screen_scores(tab2d, codes_flat, thr_q):
    """Integer upper-bound screen scores from the row table's classes.

    s_int = (cls+1)*unit + 3 - thr_q >= SCREEN_SCALE*(rank - thr), the
    class_scores_int derivation at 256 levels.
    """
    return (row_classes(tab2d, codes_flat) + 1) * _UNIT + 3 - thr_q


def host_row_table_weights(weights, threshold: float, block: int):
    """uint8 row table + affine decode for arbitrary f64 weights.

    Any ScoringModel (arbitrary weights, frequency threshold, log2(f/f_med))
    quantizes to 256 sound upper-bound classes:

        s = W[c] - threshold,  cls[c] = clip(floor((s - a)/width*256)),
        s_int = (cls + 1)*step + off  >=  scale * s   always,

    with scale a power of two keeping within-block int32 sums exact
    (scale * max|s| * block < 2^26), step = ceil(width*scale/256), and off
    covering a + one class width + 2 for every f32 rounding in the class
    build.  -inf entries (log2 scoring's zero-count k-mers) clip to class
    0, a sound over-approximation; the exact f64 replay applies the true
    -inf reset.

    Returns (tab2d uint8 [ceil(4^k/128), 128], step int, off int, scale
    float); tables under one row (k < 4) are padded with class 0.  Host
    candidacy compares composed bounds against min_score * scale.
    """
    s = np.asarray(weights, dtype=np.float64) - threshold
    finite = np.isfinite(s)
    if not finite.any():
        a, width = -1.0, 1.0
    else:
        a = float(s[finite].min())
        width = float(s[finite].max()) - a
    if width <= 0.0:
        width = 1.0
    maxabs = max(abs(a), abs(a + width), 1e-30)
    e = int(np.floor(np.log2((1 << 26) / (block * maxabs))))
    e = max(min(e, 20), -40)
    scale = 2.0 ** e
    sc = np.clip(s, a, a + width)  # -inf -> lowest class (sound)
    cls = np.clip(((sc - a) * (ROW_LEVELS / width)).astype(np.int32),
                  0, ROW_LEVELS - 1)
    step = int(np.ceil(width * scale / ROW_LEVELS))
    off = int(np.floor(a * scale)) + step + 2
    pad = (-cls.shape[0]) % _LANES  # k < 4: tables smaller than one row
    if pad:
        cls = np.concatenate([cls, np.zeros(pad, cls.dtype)])
    return (cls.astype(np.uint8).reshape(-1, _LANES), step, off, scale)


def row_screen_scores_affine(tab2d, codes_flat, step: int, off: int):
    """Integer screen scores for the weight table: s_int = (cls+1)*step +
    off (host_row_table_weights soundness)."""
    return (row_classes(tab2d, codes_flat) + 1) * step + off
