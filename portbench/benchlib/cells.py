"""What a cell is made of, found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Everything else is found by those names, so a later change adds a
configuration, a mix, a metric or a cell with new files and entries only:

  * the configuration's file is the one its entry names (``file``), and
    its ``call`` names ``calls/<call>.py``, which runs the program and
    holds the comparison, beside ``reference/<call>.py``, the plain
    reference;
  * the traffic mix is ``traffic/<traffic>.json``, parameters that the one
    generator (benchlib/genome.py) reads;
  * each metric is ``metrics/<name>.py``, a reader of the run's record.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType

#: the benchmark's folder in a checkout
FOLDER = "portbench"


@dataclasses.dataclass
class Cell:
    name: str
    folder: Path  # the benchmark's folder of the checkout
    chips: int
    config: dict  # the configuration's file, with its entry's name
    traffic: dict  # the traffic file's parameters
    call: ModuleType  # calls/<call>.py
    end_to_end: list[dict]  # the entries of the metrics this cell reports
    per_layer: list[dict]


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_module(path: Path) -> ModuleType:
    """Import a file of the benchmark under a name of its own."""
    tag = hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:8]
    name = re.sub(r"\W", "_", f"bench_{path.parent.name}_{path.stem}_{tag}")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: Path, bench: dict, name: str) -> Cell:
    """The cell ``name`` of the benchmark in the checkout ``root``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    folder = root / FOLDER
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / entry["file"]) as fh:
        config = dict(json.load(fh), name=entry["name"])
    with open(folder / "traffic" / f"{w['traffic']}.json") as fh:
        traffic = json.load(fh)
    return Cell(
        name=name, folder=folder, chips=int(w["chips"]), config=config,
        traffic=traffic,
        call=load_module(folder / "calls" / f"{config['call']}.py"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(cell: Cell, metric: dict) -> ModuleType:
    """The reader of a metric: metrics/<name>.py."""
    return load_module(cell.folder / "metrics" / f"{metric['name']}.py")
