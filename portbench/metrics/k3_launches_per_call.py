"""k3_launches_per_call: launches of K3 (ops/histogram.py histogram on
the card) a call, from the program's own counter."""

COUNTERS = {"k3_launches":
            "kmer_spans_tpu_torch.ops.histogram:histogram_launches"}


def read(run):
    if not run.done or not run.counters.get("k3_launches"):
        return None
    return run.counters["k3_launches"] / len(run.done)
