"""k3_roofline: K3 on the spectrum count (csrc/histogram.cu), the
least time its bytes need on the card over its device time in the trace.

The bytes are what the count needs, each moved once: a code (int32) and
a validity byte read for every base of each sequence, and the 4^k int32
bins written once a sequence (roofline.k3_count_bytes).  The time is the
sum of the device durations of K3's kernels (every form's) in the traced
window."""

from benchlib import roofline

K3_KERNELS = ("masked_hist_kernel", "global_hist_kernel",
              "part_count_kernel", "part_scan_kernel", "part_scatter_kernel",
              "part_items_kernel")


def read(run):
    if run.device is None or not run.done:
        return None
    from benchlib.trace import base_name
    k3_s = sum(d for name, _, d in run.device.ops
               if base_name(name) in K3_KERNELS)
    if k3_s <= 0:
        return None
    nbytes = sum(roofline.k3_count_bytes(c.lengths, run.config["k"])
                 for c in run.done)
    return 100.0 * roofline.bytes_seconds(nbytes) / k3_s
