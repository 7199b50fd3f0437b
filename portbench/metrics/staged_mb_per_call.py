"""staged_mb_per_call: MB (10^6 bytes) that parallel/device.py
staged_nbases returns for both of its callers (the count and the span
step), from the program's counter ``staged_bytes``."""

COUNTERS = {"staged_bytes":
            "kmer_spans_tpu_torch.parallel.device:staged_bytes"}


def read(run):
    if not run.done or "staged_bytes" not in run.counters:
        return None
    return run.counters["staged_bytes"] / 1e6 / len(run.done)
