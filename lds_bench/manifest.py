"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration (`configs/<name>.json`)
and a traffic mix (`traffic/<name>.json`); a metric named `<name>` is read
by `metrics/<name>.py`, whose `read(run)` returns a number or None.  A
metric belongs to a cell when its `workloads` list names the cell; an
end-to-end metric without the list belongs to every cell.  Every per-layer
metric lists its cells.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {[w['name'] for w in bench['workloads']]})")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str, here: Path = HERE) -> dict:
    return _json(here / "configs" / f"{name}.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return _json(here / "traffic" / f"{name}.json")


def metric_reader(name: str, here: Path = HERE) -> ModuleType:
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"lds_bench.metrics.{name}", path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _names(entry: dict, cell: str) -> bool:
    return cell in entry.get("workloads", [cell])


def end_to_end(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if _names(m, cell)]


def per_layer(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["per_layer"] if cell in m["workloads"]]
