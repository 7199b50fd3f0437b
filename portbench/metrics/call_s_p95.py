"""call_s_p95: the 95th percentile of the wall time of every call
completed in the window, host clock from call to return (linear
interpolation between order statistics)."""

import numpy as np


def read(run):
    walls = [c.t1 - c.t0 for c in run.done]
    return float(np.percentile(walls, 95)) if walls else None
