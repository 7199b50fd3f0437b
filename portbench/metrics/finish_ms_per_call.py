"""finish_ms_per_call: the host finish, spans/finish.py
finish_weight_spans (with its pulls of candidate blocks and the exact f64
replay of spans/extract.py), one a sequence."""

SPANS = [{"name": "finish",
          "targets": ["kmer_spans_tpu_torch.api:finish_weight_spans"]}]


def read(run):
    if not run.done or not run.count("finish"):
        return None
    return 1e3 * run.span_seconds("finish") / len(run.done)
