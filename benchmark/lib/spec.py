"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout names every cell with its
configuration and its traffic mix, and every metric with the cells that
report it. Everything else a cell needs is a file named after it:

- ``configs/<config>.json``: the model configuration (``BENCHMARK.json``'s
  ``configs[].file``);
- ``traffic/<traffic>.json``: the traffic mix, whose ``kind`` names the
  generator ``kinds/<kind>.py``;
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

Nothing here imports torch or the program.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One cell: its entry in ``BENCHMARK.json`` and the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(name: str, root: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` (root: the checkout)
    with its configuration, traffic mix, limits and metrics."""
    root = Path(root or ROOT)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "benchmark" / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer)


def kind_module(kind: str):
    """``kinds/<kind>.py``: the generator and loop of a traffic kind."""
    return importlib.import_module(f"benchmark.kinds.{kind}")


def metric_reader(name: str, root: Optional[Path] = None):
    """``read`` of ``metrics/<name>.py`` (names may hold dots, so the file
    is loaded by its path)."""
    path = Path(root or ROOT) / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(cell: Cell, run, root: Optional[Path] = None
                 ) -> Dict[str, dict]:
    """The cell's per-layer metrics that their readers find something to
    read for, as ``{name: {"value", "unit"}}``."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
