"""weights_ms_per_call: the weight table on the host, models/scoring.py
RankScoring (spans/finish.py host_rank_chain) and spans/pipeline.py
quantize_weight_table."""

API = "kmer_spans_tpu_torch.api"
SPANS = [{"name": "rank", "targets": [f"{API}:RankScoring"]},
         {"name": "quantize", "targets": [f"{API}:quantize_weight_table"]}]


def read(run):
    if not run.done or not run.count("rank"):
        return None
    s = run.span_seconds("rank") + run.span_seconds("quantize")
    return 1e3 * s / len(run.done)
