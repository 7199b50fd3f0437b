"""kmer_spans_tpu_torch — the k-mer span engine in PyTorch, for NVIDIA Hopper.

A port of ``kmer_spans_tpu`` (the JAX/TPU package beside it, which stays
the reference).  Plain tensor code is PyTorch; the two TPU kernels of the
k <= 8 span pipeline are CUDA C++ kernels for sm_90a (``csrc/``), each with
a plain PyTorch version that runs wherever its input lies on the CPU.

Host-only modules of the reference that import no JAX (encoding, oracle,
stats, spans.extract, utils.native, utils.testgen) are reused as they are.
"""

__version__ = "0.1.0"
