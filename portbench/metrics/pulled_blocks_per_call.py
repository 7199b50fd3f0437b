"""pulled_blocks_per_call: candidate blocks that spans/finish.py
finish_weight_spans pulls from the device beyond the step's top C, from
the program's counter ``pulled_blocks``."""

COUNTERS = {"pulled_blocks":
            "kmer_spans_tpu_torch.spans.finish:pulled_blocks"}


def read(run):
    if not run.done or "pulled_blocks" not in run.counters:
        return None
    return run.counters["pulled_blocks"] / len(run.done)
