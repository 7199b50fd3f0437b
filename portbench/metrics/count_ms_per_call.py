"""count_ms_per_call: the spectrum count, parallel/device.py
device_count_spectrum (codes, K3, the int64 sum and the pull of the 4^k
spectrum), less the staging inside it."""

SPANS = [{"name": "count",
          "targets": ["kmer_spans_tpu_torch.api:device_count_spectrum"]},
         {"name": "staging",
          "targets": ["kmer_spans_tpu_torch.parallel.device:staged_nbases"]}]


def read(run):
    if not run.done or not run.count("count"):
        return None
    own = run.span_seconds("count") - run.span_seconds("staging", "count")
    return 1e3 * own / len(run.done)
