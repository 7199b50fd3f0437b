"""staging_ms_per_call: host staging, parallel/device.py staged_nbases
(the N-padded uint8 copy of each sequence), from both of its callers: the
spectrum count and the span step of api._call_regions."""

API = "kmer_spans_tpu_torch.api"
SPANS = [{"name": "staging",
          "targets": [f"{API}:staged_nbases",
                      "kmer_spans_tpu_torch.parallel.device:staged_nbases"]}]


def read(run):
    if not run.done or not run.count("staging"):
        return None
    return 1e3 * run.span_seconds("staging") / len(run.done)
