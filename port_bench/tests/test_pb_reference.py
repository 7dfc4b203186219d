"""The comparison that decides ``correct``, on the CPU at a tiny size: the
reference agrees with the port's plain path to the bit, the control (the
reference in bfloat16) fails, and a run whose timed path is broken
underneath comes out not correct, once for each fault a detector cell can
have: half of each batch left out, and an answer altered where it is
produced (an event's pads; its amplitudes alone; its charges alone). The
harness's look for a card is skipped (``run.py`` makes it); the rest of a
run is driven as on the chip."""

import time

import numpy as np
import pytest
import torch

from pbench import cells, compare, runner
from pbench.inputs import Events


def run_cpu(checkout, cell="c16dd.discard", seed=2147483901):
    result, lines = runner.run(cell, seed, 0.01, False, time.perf_counter(),
                               device="cpu", root=checkout,
                               here=checkout / "port_bench")
    assert lines and lines == [f"{k}: {c['value']!r} (limit {c['limit']!r})"
                               for k, c in result["checks"].items()]
    return result


@pytest.mark.parametrize("cell", ["c16dd.discard", "chain.discard",
                                  "c16dd.keep"])
def test_reference_agrees_with_the_port_to_the_bit(checkout, cell):
    result = run_cpu(checkout, cell)
    assert result["correct"]
    assert result["failed"] == 0
    compared = result["compared"]
    assert compared["events"] == result["attempted"]
    assert compared["rows"] > 1000 * compared["events"]
    for name in ("missing_events", "rows_unmatched", "event_unmatched_max",
                 "charge_l1", "amplitude_l1", "event_charge_l1_max",
                 "event_amplitude_l1_max", "assembly_bits"):
        assert compared[name] == 0, name
    assert set(result["metrics"]) == {"events_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    # set-up's phases follow one another from the process's start to the
    # window's
    setup = result["driver"]["setup_seconds"]
    assert list(setup) == [*runner.SETUP_PHASES, "kernel_library"]
    assert all(setup[p] >= 0 for p in runner.SETUP_PHASES)
    assert sum(setup[p] for p in runner.SETUP_PHASES) == pytest.approx(
        result["metrics"]["setup_s"]["value"])


def test_the_control_fails(checkout):
    """The reference in bfloat16 against the reference in f32 over a run's
    sampled events."""
    from benchref import nuclear_map
    from benchref.detector.plain import PlainDetector

    cell = cells.find("c16dd.discard", checkout, checkout / "port_bench")
    seed = 77
    events = Events(cell.config, 6, seed, "cpu")
    ids = np.arange(6)
    nuclei = (events.proton_numbers, events.mass_numbers, nuclear_map, "cpu")
    args = (events.vertices, events.momenta, ids, seed)
    ref = PlainDetector(cell.config, *nuclei).simulate(*args)
    low = PlainDetector(cell.config, *nuclei, low=torch.bfloat16).simulate(
        *args)
    ok, checks = compare.judge(compare.compare(low, ref),
                               cells.find("c16dd.discard").limits)
    assert not ok
    assert checks["rows_unmatched"]["value"] > 0.1


def test_half_of_each_batch_left_out_is_not_correct(checkout, monkeypatch):
    from attpc_engine_tpu_torch.detector.simulator import DetectorSimulator

    real = DetectorSimulator.simulate_batch

    def half(self, vertices, momenta, *args, **kw):
        momenta = momenta.copy()
        momenta[len(momenta) // 2:] = 0.0  # no track: the event is skipped
        return real(self, vertices, momenta, *args, **kw)

    monkeypatch.setattr(DetectorSimulator, "simulate_batch", half)
    result = run_cpu(checkout)
    assert not result["correct"]
    check = result["checks"]["event_unmatched_max"]
    assert check["value"] > check["limit"]


def alter_first_event(monkeypatch, change):
    """Each batch's first event leaves the card with its rows [n, 8]
    changed in place by ``change``."""
    from attpc_engine_tpu_torch.detector.simulator import DetectorSimulator

    real = DetectorSimulator.assemble_device

    def altered(self, packed, counts, event_ids, seed):
        spyral, labels = real(self, packed, counts, event_ids, seed)
        spyral = spyral.clone()
        change(spyral[:int(torch.as_tensor(counts)[0])])
        return spyral, labels

    monkeypatch.setattr(DetectorSimulator, "assemble_device", altered)


def test_an_answer_altered_where_it_is_produced_is_not_correct(
        checkout, monkeypatch):
    alter_first_event(monkeypatch, lambda rows: rows[:, 5].add_(1.0))
    result = run_cpu(checkout)
    assert not result["correct"]
    check = result["checks"]["event_unmatched_max"]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("column, name", [
    (compare.AMPLITUDE, "event_amplitude_l1_max"),
    (compare.CHARGE, "event_charge_l1_max"),
])
def test_one_event_with_wrong_amplitudes_or_charges_is_not_correct(
        checkout, monkeypatch, column, name):
    alter_first_event(monkeypatch, lambda rows: rows[:, column].mul_(1.5))
    result = run_cpu(checkout)
    assert not result["correct"]
    check = result["checks"][name]
    assert check["value"] == pytest.approx(0.5)
    assert check["value"] > check["limit"]
    assert result["checks"]["rows_unmatched"]["value"] == 0  # keys agree


def test_the_worst_event_shows_what_the_pooled_gap_dilutes():
    rows = np.ones((10, 8))
    rows[:, 5] = np.arange(10)
    labels = np.zeros(10, np.int64)
    ref = {ev: (rows.copy(), labels) for ev in range(300)}
    got = {ev: (rows.copy(), labels) for ev in range(300)}
    got[7][0][:, compare.CHARGE] *= 1.2
    got[9][0][:, compare.AMPLITUDE] *= 0.7
    numbers = compare.compare(got, ref)
    assert numbers["charge_l1"] == pytest.approx(0.2 / 300)
    assert numbers["amplitude_l1"] == pytest.approx(0.3 / 300)
    assert numbers["event_charge_l1_max"] == pytest.approx(0.2)
    assert numbers["event_amplitude_l1_max"] == pytest.approx(0.3)
    assert numbers["assembly_bits"] == 0  # neither column is compared bit for bit


def test_lost_events_are_not_correct():
    got = {1: (np.zeros((0, 8)), np.zeros(0, np.int64))}
    numbers = compare.compare(got, got, missing=3)
    ok, checks = compare.judge(numbers, {"missing_events": 0})
    assert not ok and checks["missing_events"]["value"] == 3
    ok, _ = compare.judge({}, {"missing_events": 0})
    assert not ok  # a number that is not there fails


@pytest.mark.cuda
def test_a_cell_is_correct_on_the_card(tmp_path):
    """One tiny run of a cell through the card's kernels, the reference on
    the card: correct, and the comparison not vacuous."""
    from conftest import cuda_or_skip, make_checkout

    cuda_or_skip()
    checkout = make_checkout(tmp_path / "checkout", events_per_batch=64,
                             window_events_per_s=640)
    result, _ = runner.run("chain.discard", 5, 0.2, False,
                           time.perf_counter(), device="cuda", root=checkout,
                           here=checkout / "port_bench")
    assert result["correct"], result["checks"]
    assert result["compared"]["rows"] > 0
