"""The sequential reference the port is held against.

Re-exports the reference's jax-free host oracle (its exact f64 rank chain
and region recurrence, bit-identical to the C reference) and its golden
genome, so that callers of the port reach them through this package.
"""

from kmer_spans_tpu.oracle import count_spectrum, find_regions, weighted_ranks
from kmer_spans_tpu.utils.testgen import golden_genome

__all__ = ["count_spectrum", "find_regions", "golden_genome",
           "weighted_ranks"]
