"""The benchmark's own code: cell discovery, the genome generator, host
spans and counters, the profiler trace's reduction and the roofline
arithmetic.  Nothing here imports the program under test at import time."""
