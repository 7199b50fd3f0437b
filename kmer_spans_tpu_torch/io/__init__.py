from .fasta import read_fasta, read_fasta_packed, write_fasta
from .spectrum_file import KMER_MAGIC, read_kmers, write_kmers

__all__ = [
    "read_fasta",
    "read_fasta_packed",
    "write_fasta",
    "read_kmers",
    "write_kmers",
    "KMER_MAGIC",
]
