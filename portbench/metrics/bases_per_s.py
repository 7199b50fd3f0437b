"""bases_per_s: the bases of every call completed in the window, over the
window's seconds (host clock, first call's start to last call's end)."""


def read(run):
    if run.window_s <= 0 or not run.done:
        return None
    return sum(c.bases for c in run.done) / run.window_s
