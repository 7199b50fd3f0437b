"""pull_batches_per_call: the batches of candidate blocks that the host
finish pulls from the device beyond the step's top C (calls of the
step's ``pull``); repeats exactly for one assembly."""

SPANS = [{"name": "pull", "wrap": "result_attr", "attr": "pull",
          "targets": ["kmer_spans_tpu_torch.api:make_weight_span_pipeline"]}]


def read(run):
    if not run.done:
        return None
    return run.count("pull") / len(run.done)
