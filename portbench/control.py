"""The control of a cell's comparison: the plain reference in float32, the
precision below the configuration's float64, put in the program's place
and compared as the program's answers are.  It has to come out wrong.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints, for each seed, the numbers compared and whether each is within
its limit, on the assembly that a run of that seed checks, at the cell's
own size.  The benchmark's runs do not run it.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "portbench")]
    import numpy as np
    import torch

    from benchlib import cells, genome

    cell = cells.find_cell(ROOT, cells.load_benchmark(ROOT), args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    workers = min(8, os.cpu_count() or 1)
    all_fail = True
    for seed in args.seeds:
        pool = int(cell.traffic["pool"])
        checked = int(np.random.default_rng([seed, 1]).integers(pool))
        asm = genome.make_assembly(cell.traffic, seed, checked, device)
        t0 = time.perf_counter()
        want = cell.call.reference(asm, cell.config, np.float64, workers,
                                   device)
        t1 = time.perf_counter()
        control = cell.call.reference(asm, cell.config, np.float32, workers,
                                      device)
        got = cell.call.compare(control, want)
        fails = {n: got[n] > lim for n, lim in cell.call.CHECKS}
        all_fail &= any(fails.values())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": got, "over_limit": fails,
                          "regions": int(want["regions"].shape[0]),
                          "reference_s": t1 - t0}), flush=True)
    return 0 if all_fail else 1


if __name__ == "__main__":
    sys.exit(main())
