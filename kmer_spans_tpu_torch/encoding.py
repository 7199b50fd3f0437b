"""2-bit nucleotide encoding on the host (numpy): the port's own copy.

Copied from ``kmer_spans_tpu/encoding.py`` (the parts the port calls), so
that the port imports nothing of the JAX package.  The contract is the
reference's (src/kmer_spans.c:6-41):

  * a byte c encodes to the 2-bit value ``(c >> 1) & 3``: A=0, C=1, T=2,
    G=3, case-insensitive by construction;
  * only 'n'/'N' break k-mer words; every other byte (IUPAC codes too) is
    2-bit encoded through the same map ('W' -> G, 'S' -> C, 'U' -> T);
  * a k-mer's code concatenates 2-bit values MSB-first, the rolling update
    ``code = (code << 2 | base) & (4^k - 1)``.

k is capped at 15, which keeps codes within int32 (4^15 = 2^30).  Decoded,
the 2-bit values read A, C, T, G (``NUC``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Decode table: 2-bit value -> nucleotide (index order A, C, T, G)
NUC = "ACTG"
NUC_BYTES = np.frombuffer(b"ACTG", dtype=np.uint8)

#: Maximum supported k (4^15 = 2^30 fits int32)
MAX_K = 15

_ASCII = np.arange(256, dtype=np.uint16)
#: 256-entry table: byte -> 2-bit base value via (c >> 1) & 3
BASE_TABLE = ((_ASCII >> 1) & 3).astype(np.uint8)
#: 256-entry table: True where the byte is a word-breaking 'n'/'N'
N_TABLE = np.zeros(256, dtype=bool)
N_TABLE[ord("n")] = True
N_TABLE[ord("N")] = True
#: Valid = not a word breaker (note: NOT "is ACGT")
VALID_TABLE = ~N_TABLE


@dataclasses.dataclass(frozen=True)
class PackedSeq:
    """A host-packed sequence: 2-bit base values plus an N-validity mask.

    ``bases[i]`` is the 2-bit value of byte i (meaningless where ``valid[i]``
    is False); ``valid[i]`` is False exactly at 'n'/'N' bytes.
    """

    bases: np.ndarray  # uint8 [n]
    valid: np.ndarray  # bool  [n]

    @property
    def n(self) -> int:
        return int(self.bases.shape[0])

    def __len__(self) -> int:
        return self.n


def pack(seq) -> PackedSeq:
    """Pack a str/bytes/ndarray sequence into 2-bit bases + validity mask."""
    if isinstance(seq, PackedSeq):
        return seq
    if isinstance(seq, str):
        raw = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    elif isinstance(seq, (bytes, bytearray, memoryview)):
        raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        raw = np.asarray(seq, dtype=np.uint8)
    return PackedSeq(bases=BASE_TABLE[raw], valid=VALID_TABLE[raw])


def kmer_to_code(kmer: str) -> int:
    """Encode a k-mer string to its integer code (MSB-first 2-bit packing)."""
    code = 0
    for ch in kmer:
        code = (code << 2) | ((ord(ch) >> 1) & 3)
    return code


def code_to_kmer(code: int, k: int) -> str:
    """Decode an integer code back to its k-mer string."""
    return "".join(NUC[(code >> shift) & 3]
                   for shift in range(2 * (k - 1), -1, -2))


def all_kmers(k: int) -> list[str]:
    """All 4^k k-mer strings in 2-bit index order (reference kmer_seq_r)."""
    if k < 1 or k > MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    n = 1 << (2 * k)
    codes = np.arange(n, dtype=np.int64)
    cols = []
    for shift in range(2 * (k - 1), -1, -2):
        cols.append(NUC_BYTES[(codes >> shift) & 3])
    mat = np.stack(cols, axis=1)  # [n, k] uint8
    flat = mat.tobytes().decode("ascii")
    return [flat[i * k : (i + 1) * k] for i in range(n)]


def kmer_codes_np(packed: PackedSeq, k: int):
    """Vectorized k-mer codes + validity, end-position convention (host numpy).

    Returns (codes, kmer_valid) where ``codes[p]`` is the code of the k-mer
    ending at 0-based position p (covering bases [p-k+1, p]); entries with
    p < k-1 or any invalid base in the window have kmer_valid False (their
    code value is unspecified).
    """
    bases = packed.bases.astype(np.int64)
    valid = packed.valid
    n = bases.shape[0]
    codes = np.zeros(n, dtype=np.int64)
    for j in range(k):
        # base at position p-j contributes << 2*j
        shifted = np.zeros(n, dtype=np.int64)
        shifted[j:] = bases[: n - j]
        codes |= shifted << (2 * j)
    # validity: all k bases in window valid
    cs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(valid.astype(np.int64), out=cs[1:])
    kmer_valid = np.zeros(n, dtype=bool)
    if n >= k:
        kmer_valid[k - 1 :] = (cs[k:] - cs[:-k]) == k
    return codes, kmer_valid
