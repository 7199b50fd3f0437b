"""Binary spectrum files, bit-compatible with the reference.

The port's own copy of ``kmer_spans_tpu/io/spectrum_file.py``.  Format
(kmer_spans.R:126-134, little-endian int32 throughout):
  [0]   magic = 310572
  [1]   n_k   — number of spectra in the file
  [2..] n_k sizes (4^k for each spectrum)
  then the count vectors back to back.

k is recovered from each size as log2(size)/2 (kmer_spans.R:185).
"""

from __future__ import annotations

import numpy as np

KMER_MAGIC = 310572


def write_kmers(path, counts_list) -> None:
    """Write spectra (list of int arrays, each 4^k long) in reference format.

    Counts are written as int32 (the reference's width; values must fit)."""
    with open(path, "wb") as fh:
        header = np.array(
            [KMER_MAGIC, len(counts_list)] + [len(c) for c in counts_list],
            dtype="<i4",
        )
        fh.write(header.tobytes())
        for c in counts_list:
            arr = np.asarray(c)
            if arr.max(initial=0) > np.iinfo(np.int32).max:
                raise OverflowError("counts exceed int32 (reference format limit)")
            fh.write(arr.astype("<i4").tobytes())


def read_kmers(path):
    """Read a reference-format spectrum file -> dict(k=list[int], counts=list).

    Returns None if the magic number does not match (the reference returns
    FALSE, kmer_spans.R:171-174)."""
    with open(path, "rb") as fh:
        head = np.frombuffer(fh.read(8), dtype="<i4")
        if head.shape[0] < 2 or head[0] != KMER_MAGIC:
            return None
        n_k = int(head[1])
        if n_k < 1:
            return None
        sizes = np.frombuffer(fh.read(4 * n_k), dtype="<i4")
        counts = [
            np.frombuffer(fh.read(4 * int(sz)), dtype="<i4").astype(np.int64)
            for sz in sizes
        ]
    ks = [int(np.log2(sz) / 2) for sz in sizes]
    return {"k": ks, "counts": counts}
