"""Checkpoint / resume: the port's copy of ``kmer_spans_tpu/io/checkpoint.py``.

Two artifacts, in the same files as the JAX package writes (a checkpoint
written by either package loads in the other):

  * Spectrum checkpoints: flat .npy shards + a JSON manifest (format
    ``kmer_spans_tpu.spectrum.v1``) for large spectra (k >= 13, where 4^k
    counts do not fit one int32 file comfortably).
  * Stream checkpoints: the streaming pipeline's scan state at chunk
    granularity (chunk index, exact int64 screen carry, rolling k-mer
    halo, the open-excursion buffer and the regions so far), one .npz.  A
    killed host resumes the scan pass after the last completed chunk
    instead of restarting the genome.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

#: the manifest's format string, shared with the JAX package's files
SPECTRUM_FORMAT = "kmer_spans_tpu.spectrum.v1"


def save_spectrum_sharded(dir_path: str, counts: np.ndarray, k: int,
                          n_shards: int = 16) -> None:
    """Save a 4^k spectrum as n_shards flat shards + manifest."""
    os.makedirs(dir_path, exist_ok=True)
    counts = np.asarray(counts)
    shards = np.array_split(counts, n_shards)
    for i, sh in enumerate(shards):
        np.save(os.path.join(dir_path, f"shard_{i:05d}.npy"), sh)
    manifest = {
        "format": SPECTRUM_FORMAT,
        "k": int(k),
        "n_shards": n_shards,
        "sizes": [int(s.shape[0]) for s in shards],
        "dtype": str(counts.dtype),
        "total": int(counts.sum()),
    }
    with open(os.path.join(dir_path, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)


def load_spectrum_sharded(dir_path: str):
    """Load a sharded spectrum -> (counts, k); validates the manifest."""
    with open(os.path.join(dir_path, "manifest.json")) as fh:
        manifest = json.load(fh)
    if manifest.get("format") != SPECTRUM_FORMAT:
        raise ValueError("not a kmer_spans_tpu spectrum checkpoint")
    parts = [
        np.load(os.path.join(dir_path, f"shard_{i:05d}.npy"))
        for i in range(manifest["n_shards"])
    ]
    counts = np.concatenate(parts)
    if counts.sum() != manifest["total"]:
        raise ValueError("spectrum checkpoint corrupt: total mismatch")
    return counts, manifest["k"]


@dataclasses.dataclass
class StreamCheckpoint:
    """Scan-pass state after completing chunk ``chunk_idx``."""

    chunk_idx: int
    x_in: int  # exact int64 screen bound entering the next chunk
    halo_bytes: bytes  # previous chunk's trailing k-1 nbases
    open_start: int
    open_s: np.ndarray | None
    open_scored: np.ndarray | None
    regions: list

    def save(self, path: str) -> None:
        np.savez(
            path,
            chunk_idx=self.chunk_idx,
            x_in=np.int64(self.x_in),
            halo=np.frombuffer(self.halo_bytes, dtype=np.uint8),
            open_start=self.open_start,
            open_s=self.open_s if self.open_s is not None else np.zeros(0),
            open_scored=(
                self.open_scored
                if self.open_scored is not None
                else np.zeros(0, bool)
            ),
            has_open=self.open_s is not None,
            regions=np.array(
                [(r[0], r[1], r[2], r[3]) for r in self.regions],
                dtype=np.float64,
            ).reshape(-1, 4),
        )

    @classmethod
    def load(cls, path: str) -> "StreamCheckpoint":
        d = np.load(path)
        has_open = bool(d["has_open"])
        regions = [
            (int(a), int(b), int(c), float(s))
            for a, b, c, s in d["regions"]
        ]
        return cls(
            chunk_idx=int(d["chunk_idx"]),
            x_in=int(d["x_in"]),
            halo_bytes=d["halo"].tobytes(),
            open_start=int(d["open_start"]),
            open_s=d["open_s"] if has_open else None,
            open_scored=d["open_scored"] if has_open else None,
            regions=regions,
        )
