"""step_device_ms_per_call: the device time of the span step's kernels,
from the CUDA event pair the program puts around each ``regions.step``
(api._call_regions), read after the step's outputs reached the host (no
synchronize added)."""

from benchlib import program

SPANS = program.WINDOW


def read(run):
    ms = program.attr_sum(run, "regions.step", "device_ms")
    if ms is None or not run.done:
        return None
    return ms / len(run.done)
