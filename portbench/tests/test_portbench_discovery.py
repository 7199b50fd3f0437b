"""A configuration, a traffic mix, a metric and a cell added as new files
and entries only, in a copy of the benchmark, are found and run."""

import json
import shutil

from _setup import BENCH, ROOT, SMALL
from benchlib import runner


def test_new_files_and_entries_only(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    folder = tmp_path / "portbench"
    cfg = json.loads((folder / "configs" / "lowcomp_k8.json").read_text())
    cfg.update(k=10, source="the same lines, k=10")
    (folder / "configs" / "lowcomp_k10.json").write_text(json.dumps(cfg))
    traffic = json.loads((folder / "traffic" / "scaffolds.json").read_text())
    traffic.update(SMALL, sequences=5, pool=2)
    (folder / "traffic" / "five.json").write_text(json.dumps(traffic))
    (folder / "metrics" / "regions_seen.py").write_text(
        '"""calls done in the window (a made-up metric)."""\n\n\n'
        "def read(run):\n    return float(len(run.done))\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "lowcomp_k10", "source": "the same lines, k=10",
        "file": "portbench/configs/lowcomp_k10.json", "reduced": [],
        "why": "a configuration added as a file"})
    bench["workloads"].append({
        "name": "lowcomp_k10.five", "config": "lowcomp_k10",
        "traffic": "five", "chips": 1, "why": "a cell added as an entry"})
    bench["per_layer"].append({
        "name": "regions_seen", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "api", "moves": "bases_per_s",
        "workloads": ["lowcomp_k10.five"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    traced = runner.run_cell(tmp_path, "lowcomp_k10.five", 31, 0.2, True,
                             "cpu")
    plain = runner.run_cell(tmp_path, "lowcomp_k10.five", 31, 0.2, False,
                            "cpu")
    assert traced["correct"] and plain["correct"]
    # the new cell reports the new metric, which lists it, and every
    # metric already there that lists no cells and finds something to read
    assert traced["metrics"]["regions_seen"] == {
        "value": traced["attempted"], "unit": "calls"}
    layer = {m["name"] for m in bench["per_layer"]}
    assert {"staging_ms_per_call", "finish_ms_per_call",
            "pull_batches_per_call"} <= set(traced["metrics"]) <= layer
    assert set(plain["metrics"]) == {"bases_per_s", "call_s_p95", "setup_s"}
    for path, data in before.items():
        assert path.read_bytes() == data, path
