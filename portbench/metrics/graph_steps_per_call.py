"""graph_steps_per_call: device steps of spans/pipeline.py
make_weight_span_pipeline run as the replay of a captured CUDA graph, from
the program's counter ``graph_steps`` (none in a program without it)."""

COUNTERS = {"graph_steps": "kmer_spans_tpu_torch.spans.pipeline:graph_steps"}


def read(run):
    if not run.done or "graph_steps" not in run.counters:
        return None
    return run.counters["graph_steps"] / len(run.done)
