"""Cells, configurations, traffic mixes and per-layer metrics are found by
name, and a new one is added with new files and entries alone."""

import json

import pytest

from pbench import cells


def test_every_cell_finds_its_files():
    bench = cells.load_json(cells.ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        cell = cells.find(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["hold_events"] >= 0
        assert cell.limits["missing_events"] == 0
        assert cell.window_events_per_s > 0 and cell.warmup_batches > 0
        assert [m["name"] for m in cell.end_to_end] == ["events_per_s",
                                                        "setup_s"]
        for m in cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))


def test_configuration_files_hold_their_source_and_cuts():
    bench = cells.load_json(cells.ROOT / "BENCHMARK.json")
    for c in bench["configs"]:
        cfg = cells.load_json(cells.ROOT / c["file"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["assumed"]


def test_a_cell_added_as_new_files_and_entries(checkout):
    """A new configuration, traffic mix, cell and metric: files and
    BENCHMARK.json entries only, nothing that is there edited."""
    here = checkout / "port_bench"
    before = {w["name"]: cells.find(w["name"], checkout, here)
              for w in cells.load_json(checkout / "BENCHMARK.json")[
                  "workloads"]}
    cfg = json.loads((here / "configs" / "c16dd_d2_184MeV.json").read_text())
    cfg["name"] = "c16dd_longer"
    cfg["kinematics"]["beam_energy"] = 200.0
    (here / "configs" / "c16dd_longer.json").write_text(json.dumps(cfg))
    (here / "traffic" / "hold1k.json").write_text(json.dumps(
        {"hold_events": 1000}))
    (here / "cells" / "longer.hold1k.json").write_text(json.dumps(
        {"window_events_per_s": 900, "warmup_batches": 2,
         "limits": {"missing_events": 0}}))
    (here / "metrics" / "driver.read_ms_per_batch.py").write_text(
        "def read(run):\n"
        "    return 1e3 * run.phase_seconds['read'] / run.batches\n")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "c16dd_longer", "source": "x",
                             "file": "port_bench/configs/c16dd_longer.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "longer.hold1k",
                               "config": "c16dd_longer", "traffic": "hold1k",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "driver.read_ms_per_batch",
                               "unit": "ms/batch", "better": "lower",
                               "source": "program_span", "layer": "driver",
                               "moves": "events_per_s",
                               "workloads": ["longer.hold1k"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.find("longer.hold1k", checkout, here)
    assert cell.config["kinematics"]["beam_energy"] == 200.0
    assert cell.traffic["hold_events"] == 1000
    assert cell.window_events_per_s == 900
    assert [m["name"] for m in cell.per_layer] == ["driver.read_ms_per_batch"]
    read = cells.metric_reader("driver.read_ms_per_batch", here)

    class Run:
        phase_seconds = {"read": 0.5}
        batches = 10

    assert read(Run()) == pytest.approx(50.0)
    # the cells that were there keep their metrics and files
    for name, cell in before.items():
        assert cells.find(name, checkout, here) == cell
        own = [m for m in bench["per_layer"]
               if name in m.get("workloads", [name])]
        assert cell.per_layer == own and len(own) > 0


def test_an_unknown_cell_is_refused(checkout):
    with pytest.raises(KeyError):
        cells.find("no.such.cell", checkout, checkout / "port_bench")
