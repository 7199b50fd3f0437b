"""native_folds_per_call: spans/extract.py extract_spans calls that the
host library folded, from the program's counter ``native_folds`` (none
where the library does not load and the numpy layers extract)."""

COUNTERS = {"native_folds": "kmer_spans_tpu_torch.spans.extract:native_folds"}


def read(run):
    if not run.done or "native_folds" not in run.counters:
        return None
    return run.counters["native_folds"] / len(run.done)
