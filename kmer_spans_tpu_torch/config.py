"""Configuration dataclasses: the port's own copy of
``kmer_spans_tpu/config.py``, with the same fields, defaults and checks.

Field names and defaults mirror the reference's function arguments:
thr=0.75 (kmer_spans.R:72), min_l=1e5 (:135), with_f=True (:18),
ret_flag=0 (:104); scoring function variants per README.md:25-54.

``backend`` takes the port api's values ("auto", the device path;
"host"; "native").  ``device`` ("cuda" by default, or "cpu" for the
kernels' plain versions) is where the "auto" backend runs: it stands in
for the reference's ``backend="jax"``.

No api function or CLI command reads these classes, as none of the
reference reads its own: they are a parity copy for callers that keep
their settings in one.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

ScoringKind = Literal["rank", "threshold", "log2_median", "weights"]


@dataclasses.dataclass
class SpanConfig:
    """Span-calling configuration (flagship pipeline)."""

    k: int = 8
    scoring: ScoringKind = "rank"
    thr: float = 0.75          # rank threshold (scoring="rank")
    f_t: float | None = None   # frequency threshold (scoring="threshold")
    min_width: int = 100
    min_score: float = 20.0
    backend: str = "auto"
    device: str = "cuda"

    # device execution shape
    block: int = 8192
    cand_blocks: int = 128
    chunk_bases: int = 1 << 25
    margin_blocks: int = 16

    # mesh
    mesh_axis: str = "data"
    n_devices: int | None = None  # None: all visible

    def validate(self) -> "SpanConfig":
        from .encoding import MAX_K

        if not 1 <= self.k <= MAX_K:
            raise ValueError(f"k must be in [1, {MAX_K}]")
        if self.scoring == "rank" and not 0 < self.thr < 1:
            raise ValueError("the threshold must be between 0 and 1")
        if self.chunk_bases % self.block:
            raise ValueError("chunk_bases must be a multiple of block")
        return self


@dataclasses.dataclass
class CountConfig:
    """Spectrum counting / persistence configuration."""

    k: int = 8
    with_f: bool = True
    min_l: int = 100_000  # FASTA length filter (kmers.to.file default)
    backend: str = "auto"
    device: str = "cuda"


@dataclasses.dataclass
class WindowConfig:
    """Windowed k-mer distribution configuration."""

    window: int = 200
    freq: bool = True
    ret_flag: int = 0
