"""The card's published peaks and the bytes a kernel's work needs.

NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): 3.35 TB/s of
HBM3.  A share of a roofline is the least time the bytes need at that
rate over the time the kernel took; the bytes are counted from the call's
shapes, each input read once and each output written once (K3 does no
arithmetic that would bound it first).
"""

HBM_BYTES_PER_S = 3.35e12


def bytes_seconds(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S


def k3_count_bytes(lengths, k: int) -> int:
    """K3 on the spectrum count of one call: per sequence of at least k
    bases, an int32 code and a validity byte read for each base, and the
    4^k int32 bins written once (the padding the program adds to a power
    of two is not work the count needs, so it is not counted)."""
    seqs = [n for n in lengths if n >= k]
    return sum(5 * n for n in seqs) + len(seqs) * 4 * (1 << (2 * k))
