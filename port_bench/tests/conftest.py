"""Fixtures of the benchmark's own tests (run with ``python -m pytest
port_bench/tests`` from the repository's root; the ``cuda`` tests run
where torch finds a card and skip elsewhere)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = ("configs", "traffic", "cells", "metrics", "kernel_names.json")


def make_checkout(dest: Path, events_per_batch: int = 4,
                  warmup_batches: int = 1, hold_events: int = 8, window_events_per_s: float = 400.0
                  ) -> Path:
    """A checkout's BENCHMARK.json and the benchmark's data files, cut to
    a size the CPU runs in seconds."""
    bench = dest / "port_bench"
    bench.mkdir(parents=True)
    for name in DATA:
        src = BENCH / name
        if src.is_dir():
            shutil.copytree(src, bench / name)
        else:
            shutil.copy(src, bench / name)
    for cfg in (bench / "configs").glob("*.json"):
        d = json.loads(cfg.read_text())
        d["engine"]["events_per_batch"] = events_per_batch
        cfg.write_text(json.dumps(d))
    for traffic in (bench / "traffic").glob("*.json"):
        d = json.loads(traffic.read_text())
        if d["hold_events"] > 0:
            d["hold_events"] = hold_events
        traffic.write_text(json.dumps(d))
    for cell in (bench / "cells").glob("*.json"):
        d = json.loads(cell.read_text())
        d.update(warmup_batches=warmup_batches,
                 window_events_per_s=window_events_per_s)
        cell.write_text(json.dumps(d))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


@pytest.fixture
def checkout(tmp_path):
    return make_checkout(tmp_path / "checkout")


def cuda_or_skip():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch finds none")
