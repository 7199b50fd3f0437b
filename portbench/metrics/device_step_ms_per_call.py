"""device_step_ms_per_call: the steps of spans/pipeline.py
make_weight_span_pipeline (codes, weights, block summaries, top C), one a
sequence, each timed to a torch.cuda.synchronize() that the span adds."""

SPANS = [{"name": "device_step", "wrap": "result", "sync": True,
          "targets": ["kmer_spans_tpu_torch.api:make_weight_span_pipeline"]}]


def read(run):
    if not run.done or not run.count("device_step"):
        return None
    return 1e3 * run.span_seconds("device_step") / len(run.done)
