"""FASTA reading and writing (plain or gzip), on the host.

The port's own copy of ``kmer_spans_tpu/io/fasta.py``: records come out
as contiguous byte strings ready for 2-bit packing.
"""

from __future__ import annotations

import gzip

from ..encoding import PackedSeq, pack


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_fasta(path) -> list[tuple[str, bytes]]:
    """Read a FASTA(.gz) file -> list of (name, sequence bytes).

    Whitespace inside records is stripped; record names are the first
    whitespace-delimited token after '>'.
    """
    with _open(path) as fh:
        data = fh.read()
    if not data:
        return []
    out: list[tuple[str, bytes]] = []
    # split on record starts; data may begin with comments/blank lines
    chunks = data.split(b">")
    for chunk in chunks[1:]:
        nl = chunk.find(b"\n")
        if nl < 0:
            header, body = chunk, b""
        else:
            header, body = chunk[:nl], chunk[nl + 1 :]
        name = header.split()[0].decode("ascii", "replace") if header.split() else ""
        seq = body.translate(None, b"\r\n \t")
        out.append((name, seq))
    return out


def read_fasta_packed(path, min_len: int = 0) -> list[tuple[str, PackedSeq]]:
    """Read and 2-bit pack, optionally dropping sequences shorter than min_len."""
    return [
        (name, pack(seq))
        for name, seq in read_fasta(path)
        if len(seq) >= min_len
    ]


def write_fasta(path, records, width: int = 60) -> None:
    """Write (name, sequence str/bytes) records as FASTA."""
    with open(path, "wb") as fh:
        for name, seq in records:
            if isinstance(seq, str):
                seq = seq.encode("ascii")
            fh.write(b">" + name.encode("ascii") + b"\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + b"\n")
