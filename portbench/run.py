"""Run one cell of the benchmark of kmer_spans_tpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The cell is an entry of BENCHMARK.json's
``workloads``; its configuration, traffic mix and metrics are found by
name (benchlib/cells.py).  The run makes its inputs from the seed, warms
up, measures for the given seconds, compares what the window's calls
returned with the plain reference, and prints one JSON line last: the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``).  Without a CUDA card it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: the packages a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "kmer_spans_tpu")
#: caches of the libraries the program may use, at fixed paths in the
#: checkout (the program's own kernels build into its package's build/)
CACHE = ROOT / ".portbench_cache"


def _forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "portbench")]
    from benchlib import cells, runner

    cell = cells.find_cell(ROOT, cells.load_benchmark(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = runner.run_cell(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", T_START,
                             workers=min(8, os.cpu_count() or 1))
    loaded = _forbidden_loaded()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
