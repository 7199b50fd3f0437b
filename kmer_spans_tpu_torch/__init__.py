"""kmer_spans_tpu_torch — the k-mer span engine in PyTorch, for NVIDIA Hopper.

A port of ``kmer_spans_tpu`` (the JAX/TPU package beside it, which stays
the reference).  Plain tensor code is PyTorch; the TPU kernels of the span
pipelines (the spectrum count, the fused screen, the value histogram and
the class gather) are CUDA C++ kernels for sm_90a (``csrc/``), each with a
plain PyTorch version that runs wherever its input lies on the CPU.

The port imports nothing of ``kmer_spans_tpu``: the host code it needs
(encoding, oracle, stats.ranks, spans.extract and the host C++ library
behind utils.native) is its own copy.
"""

from .encoding import (
    MAX_K,
    NUC,
    PackedSeq,
    all_kmers,
    code_to_kmer,
    kmer_to_code,
    pack,
)

__version__ = "0.1.0"
