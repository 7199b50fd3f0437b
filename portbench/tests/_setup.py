"""Puts the checkout's root and the benchmark's folder on sys.path (the
tests import the benchmark's modules as run.py does) and holds the small
traffic the CPU tests use."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
for _p in (str(BENCH), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: the cells' traffic cut to a CPU test's size: 2^20 bases, gaps every
#: 300 kb, scaffolds of at least 500 bases
SMALL = {"total_bases": 1 << 20, "n_gap_every": 300_000,
         "n_gap_first": 150_000, "min_sequence_bases": 500}
