"""replays_per_call: candidate excursions that spans/extract.py replays
sequentially, from the program's counter ``replays``."""

COUNTERS = {"replays": "kmer_spans_tpu_torch.spans.extract:replays"}


def read(run):
    if not run.done or "replays" not in run.counters:
        return None
    return run.counters["replays"] / len(run.done)
