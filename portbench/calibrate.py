"""Region counts of the plain reference on a traffic mix: the calibration
of a mix's repeat parameters against published region counts.

    python3 portbench/calibrate.py --traffic <name> --configs <c> [<c> ...]
        --seed <n> [--vary '<json object>' ...]

makes assembly 0 of the seed from the traffic file (each ``--vary``
object overrides some of its parameters, one assembly each; none: the
file as it is) and prints, for each, the regions that the reference calls
under each configuration, a JSON line each, with the regions per Mb.
The benchmark's runs do not run it.
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
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--configs", nargs="+", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--vary", action="append", default=[])
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "portbench")]
    import numpy as np
    import torch

    from benchlib import cells, genome

    bench = cells.load_benchmark(ROOT)
    entries = {c["name"]: c for c in bench["configs"]}
    configs = []
    for name in args.configs:
        with open(ROOT / entries[name]["file"]) as fh:
            configs.append((name, json.load(fh)))
    with open(ROOT / cells.FOLDER / "traffic" / f"{args.traffic}.json") as fh:
        base = json.load(fh)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    workers = min(8, os.cpu_count() or 1)
    for vary in args.vary or ["{}"]:
        params = dict(base, **json.loads(vary))
        asm = genome.make_assembly(params, args.seed, 0, device)
        for name, cfg in configs:
            call = cells.load_module(ROOT / cells.FOLDER / "calls"
                                     / f"{cfg['call']}.py")
            t0 = time.perf_counter()
            want = call.reference(asm, cfg, np.float64, workers, device)
            n = int(want["regions"].shape[0])
            print(json.dumps({
                "traffic": args.traffic, "vary": json.loads(vary),
                "config": name, "seed": args.seed, "regions": n,
                "regions_per_mb": n / asm.total * 1e6,
                "arrays": int(asm.repeat_lengths.shape[0]),
                "reference_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
