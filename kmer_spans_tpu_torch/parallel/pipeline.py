"""Integer rank mass (counterpart of kmer_spans_tpu/parallel/pipeline.py).

Only ``_rank_mass`` is on the k <= 8 span pipeline's path; the mesh
pipeline around it waits for the multi-device port (ROADMAP queue 1).
"""

from __future__ import annotations

import torch


def _rank_mass(counts: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative mass of the stably sorted spectrum, scattered
    back to k-mer order: rank[kmer] = mass[kmer] / total, ties broken by
    k-mer index.  int32 in, int32 out (the mass of n positions is below
    2^31 for n < 2^31).
    """
    order = torch.sort(counts, stable=True).indices
    excl = torch.zeros_like(counts)
    excl[1:] = torch.cumsum(counts[order][:-1], 0)
    mass = torch.empty_like(counts)
    mass[order] = excl
    return mass
