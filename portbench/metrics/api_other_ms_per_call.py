"""api_other_ms_per_call: a call's wall less the layers' spans that run
in no other of them: api.py's own work (the copies to and from the card,
the loop over sequences, the result's arrays)."""

API = "kmer_spans_tpu_torch.api"
LAYERS = ("count", "staging", "rank", "quantize", "device_step", "finish")
SPANS = [{"name": "count", "targets": [f"{API}:device_count_spectrum"]},
         {"name": "staging", "targets": [f"{API}:staged_nbases"]},
         {"name": "rank", "targets": [f"{API}:RankScoring"]},
         {"name": "quantize", "targets": [f"{API}:quantize_weight_table"]},
         {"name": "device_step", "wrap": "result", "sync": True,
          "targets": [f"{API}:make_weight_span_pipeline"]},
         {"name": "finish", "targets": [f"{API}:finish_weight_spans"]}]


def read(run):
    if not run.done or not run.count("count"):
        return None
    wall = sum(c.t1 - c.t0 for c in run.done)
    inside = sum(run.span_seconds(name, None) for name in LAYERS)
    return 1e3 * (wall - inside) / len(run.done)
