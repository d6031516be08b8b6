"""Find a cell's files by name: its configuration, its traffic mix, its
limits, its entry and the readers of its metrics.

A later benchmark change adds a cell, a mix, a configuration or a metric by
adding files here and entries to ``BENCHMARK.json``; nothing in this module
names one of them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_json() -> dict:
    return _json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<mix>.json
    limits: dict        # cells/<cell>.json "limits": {number: limit}
    end_to_end: List[dict]   # BENCHMARK.json metrics this cell reports
    per_layer: List[dict]
    chips: int

    @property
    def entry(self) -> str:
        return self.traffic["entry"]


def _reports(metric: dict, cell: str, e2e_names: Optional[set]) -> bool:
    """Whether a cell reports ``metric``: listed under its ``workloads``,
    or, without that key, in every cell that reports the end-to-end metric
    it moves (an end-to-end metric without the key: in every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_names is None:
        return True
    return metric["moves"] in e2e_names


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = benchmark_json()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                         f"{sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    cell_file = _json(HERE / "cells" / f"{name}.json")
    return Cell(name=name,
                config=_json(HERE / "configs" / f"{w['config']}.json"),
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=cell_file["limits"], end_to_end=e2e,
                per_layer=per_layer, chips=int(w["chips"]))


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise SystemExit(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model(config: dict):
    """The configuration's model module, ``reference/<model>.py``: its
    reference, dense leaves and counts (``reference/__init__.py``)."""
    return load_module("reference", config["model"])


def metric_readers(metrics: List[dict]) -> Dict[str, object]:
    return {m["name"]: load_module("metrics", m["name"]) for m in metrics}
