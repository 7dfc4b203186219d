"""A cell and everything of it, found by name: ``BENCHMARK.json`` at the
checkout's root names the cell's configuration (its ``file``), traffic
mix and per-layer metrics; the benchmark's folder holds one file for each
traffic mix (``traffic/<name>.json``), each cell's window and limits
(``cells/<cell>.json``) and each per-layer metric's reader
(``metrics/<name>.py``, a function ``read(run)``). Adding a cell, a
configuration, a traffic mix or a metric adds files and entries; it edits
none."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
ROOT = HERE.parent  # the checkout


@dataclass
class Cell:
    name: str
    chips: int
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list
    config: dict
    traffic: dict
    window_events_per_s: float  # the fixed work: n = this times --seconds
    warmup_batches: int
    limits: dict


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find(cell: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell named ``cell`` of ``root / BENCHMARK.json``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    own = load_json(here / "cells" / f"{cell}.json")
    return Cell(
        name=cell,
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, cell)],
        per_layer=[m for m in bench["per_layer"] if reports(m, cell)],
        config=load_json(root / configs[w["config"]]["file"]),
        traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        window_events_per_s=float(own["window_events_per_s"]),
        warmup_batches=int(own["warmup_batches"]),
        limits=own["limits"],
    )


def metric_reader(name: str, here: Path = HERE):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
