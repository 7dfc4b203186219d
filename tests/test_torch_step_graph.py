"""The default step as one CUDA graph a budget key (``step_graph.py``), on
the CPU: the key's life through a stand-in for the capture, and the CPU
path of ``simulate_batch``, which takes no graph.

A CUDA graph runs only on the card (``tests/test_torch_cuda.py`` holds
its replays to the eager step there, bit for bit). Here ``FakeCapture``
stands in for CUDA: its "graph" is the captured step, which a replay runs
again on the graph's static inputs, writing into the graph's static
outputs, as a replay overwrites them. The step is a function of its
inputs alone (the batch's seed and first event id ride in the inputs'
Fano words), so a replay of a later batch gives that batch's rows.

This file imports nothing of JAX.
"""

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from attpc_engine_tpu_torch import nuclear_map
from attpc_engine_tpu_torch.detector import (
    Config,
    DetectorParams,
    DetectorSimulator,
    ElectronicsParams,
    EngineParams,
    PadParams,
)
from attpc_engine_tpu_torch.detector.simulator import StepMeta, overflow_kinds
from attpc_engine_tpu_torch.detector.step_graph import StepGraphs
from attpc_engine_tpu_torch.nuclear import GasTarget
from attpc_engine_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
SMOKE = np.load(REPO / "attpc_engine_tpu_torch" / "data"
                / "smoke_kinematics.npz")
N_STEPS, E = 400, 4
BUDGETS = dict(point_budget=256, uniq_budget=4096, out_budget=2048,
               n_steps=N_STEPS)
COMPARED = ("packed", "spyral_counts", "meta_i32")


class FakeCapture:
    """The CPU's stand-in for ``step_graph.CudaBackend``: a capture runs
    the step once to make its outputs (a CUDA capture allocates them
    without running), a replay runs the captured step again on the
    captured inputs, its counts on a tape of its own (a graph runs no
    Python), and copies the result into the captured outputs."""

    event = None  # no timing events on the CPU

    def __init__(self):
        self.captures = self.replays = 0

    def capture(self, step, inputs):
        self.captures += 1
        outputs = step(inputs)
        return (step, inputs, outputs), outputs

    def replay(self, graph):
        self.replays += 1
        step, inputs, outputs = graph
        with profiling.taping(profiling.Tape()):
            fresh = step(inputs)
        for name, t in outputs.items():
            t.copy_(fresh[name])


def _config() -> Config:
    gas = GasTarget([(1, 2, 2)], 300.0, nuclear_map)
    return Config(
        DetectorParams(1.0, 45000.0, 2.85, 175000, gas, 0.277, 0.2, 34.0),
        ElectronicsParams(6.25, 900, 1000, 10, 560, 40), PadParams())


def _simulator(graphs: bool):
    sim = DetectorSimulator(
        _config(), SMOKE["proton_numbers"], SMOKE["mass_numbers"],
        engine=EngineParams(n_time_steps=N_STEPS, chunk_steps=100,
                            events_per_batch=E),
        device="cpu")
    fake = None
    if graphs:
        fake = FakeCapture()
        sim._graphs = StepGraphs(sim.device, backend=fake)
    return sim, fake


def _batch(sim, start: int, n: int = E, seed: int = 11, **budgets):
    return sim.simulate_batch(SMOKE["vertices"][start:start + n],
                              SMOKE["momenta"][start:start + n], seed=seed,
                              event_start=start, assemble=False,
                              **{**BUDGETS, **budgets})


def _same(got: dict, ref, start: int, **kw) -> None:
    """``got`` holds the rows of ``_batch(ref, start, **kw)``, which
    counts in a recorder of its own."""
    token = profiling.begin_run(profiling.PhaseTimes())
    try:
        want = _batch(ref, start, **kw)
    finally:
        profiling.end_run(token)
    for name in COMPARED:
        assert torch.equal(got[name], want[name]), name


@pytest.fixture
def recorder():
    rec = profiling.PhaseTimes()
    token = profiling.begin_run(rec)
    yield rec
    profiling.end_run(token)


def test_a_key_runs_eagerly_then_captured_then_replayed(recorder):
    """Four batches at one key: eager, capture, replay, replay, each with
    the eager step's rows of its own events and seed words; a replay's
    tensors are the graph's static ones; ``step.graph`` counts each way
    and ``fano.draws`` every batch."""
    sim, fake = _simulator(graphs=True)
    ref, _ = _simulator(graphs=False)
    outs = []
    for start in (0, 4, 8, 12):
        out = _batch(sim, start, seed=11 + start)
        _same(out, ref, start, seed=11 + start)
        outs.append({name: out[name] for name in COMPARED})
    assert (fake.captures, fake.replays) == (1, 3)
    held = sim._graphs.held
    assert held is not None and held.key == (sim.device, E, 256, 4096, 2048,
                                             N_STEPS)
    for out in outs[1:]:
        for name in COMPARED:
            assert out[name] is held.outputs[name]
    assert outs[0]["packed"] is not held.outputs["packed"]
    k = sim.k_tracks
    assert recorder.counters["step.graph"] == {"eager": 1, "capture": 1,
                                               "replay": 2}
    assert recorder.counters["fano.draws"] == {"plain": 4 * N_STEPS * E * k}


def test_the_static_inputs_take_each_batch():
    """At the held key the batch's inputs are copied into the graph's
    static inputs; at any other key they go to a new tensor."""
    sim, _ = _simulator(graphs=True)
    for start in (0, 4):
        _batch(sim, start)
    graphs = sim._graphs
    key = graphs.held.key
    host = sim._stage_inputs(SMOKE["vertices"][8:12], SMOKE["momenta"][8:12],
                             3, 8)
    got = graphs.inputs(key, host)
    assert got is graphs.held.inputs and torch.equal(got, host)
    other = graphs.inputs(key[:-1] + (2 * N_STEPS,), host)
    assert other is not graphs.held.inputs and torch.equal(other, host)


def test_a_budget_change_drops_the_graph_and_a_new_key_recaptures(recorder):
    """A new key (a doubled point budget, as a retry or the tuning makes
    it) runs eagerly and drops the held graph; its second call captures;
    a short batch, a key seen once, runs eagerly and never captures."""
    sim, fake = _simulator(graphs=True)
    ref, _ = _simulator(graphs=False)
    graphs = sim._graphs
    for start in (0, 4):
        _batch(sim, start)
    assert graphs.held is not None
    _same(_batch(sim, 8, point_budget=512), ref, 8, point_budget=512)
    assert graphs.held is None and fake.captures == 1
    _same(_batch(sim, 12, point_budget=512), ref, 12, point_budget=512)
    assert graphs.held.key[2] == 512 and fake.captures == 2
    _same(_batch(sim, 0, point_budget=512), ref, 0, point_budget=512)
    assert fake.replays == 3  # each capture's own run, then this replay
    _same(_batch(sim, 4, n=3), ref, 4, n=3)
    assert graphs.held is None and fake.captures == 2
    assert recorder.counters["step.graph"] == {"eager": 3, "capture": 2,
                                               "replay": 1}


def test_noise_and_the_raw_cloud_take_no_graph(recorder):
    """Given noise or a raw-cloud pool, the step runs eagerly every time,
    outside the graph's counter."""
    sim, fake = _simulator(graphs=True)
    k = sim.k_tracks
    noise = np.random.default_rng(1).standard_normal(
        (N_STEPS, E * k)).astype(np.float32)
    for start in (0, 4, 8):
        _batch(sim, 0, noise=noise)
        sim.simulate_batch(SMOKE["vertices"][:E], SMOKE["momenta"][:E],
                           seed=1, assemble=False, compact=True,
                           cloud_cap=1024, **BUDGETS)
    assert fake.captures == fake.replays == 0
    assert recorder.counters["step.graph"] == {}


@pytest.fixture(scope="module")
def bench():
    path = str(REPO / "port_bench")
    if path not in sys.path:
        sys.path.insert(0, path)
    return (importlib.import_module("pbench.inputs"),
            importlib.import_module("pbench.runner"))


@pytest.mark.parametrize("name", ["c16dd_d2_184MeV", "b10_3he_chain_24MeV"])
def test_the_cpu_step_takes_no_graph_and_keeps_its_rows(bench, name,
                                                        recorder):
    """``simulate_batch`` on the CPU: no graph, and each event's assembled
    rows those of the benchmark's frozen plain reference (``benchref``)
    bit for bit, over a physics window of 2,000 steps, for three calls at
    one key."""
    from benchref import nuclear_map as ref_map
    from benchref.detector.plain import PlainDetector

    inputs, runner = bench
    cfg = json.loads((REPO / "port_bench" / "configs" / f"{name}.json")
                     .read_text())
    cfg["engine"] = {**cfg["engine"], "n_time_steps": 2000}
    events = inputs.Events(cfg, 3 * E, cfg["kinematics"]["seed"], "cpu")
    sim = DetectorSimulator(runner.port_config(cfg), events.proton_numbers,
                            events.mass_numbers,
                            engine=runner.port_engine(cfg), device="cpu")
    assert sim._graphs is None
    # budgets that hold every event's points and rows: nothing is cut
    budgets = dict(point_budget=4096, uniq_budget=32768, out_budget=8192)
    seed = 2**33 + 5
    got = {}
    for start in range(0, 3 * E, E):
        out = sim.simulate_batch(events.vertices[start:start + E],
                                 events.momenta[start:start + E], seed=seed,
                                 event_start=start, assemble=False,
                                 **budgets)
        assert not overflow_kinds(StepMeta.decode(out["meta_i32"].numpy()))
        total = int(out["spyral_counts"].sum())
        spyral, labels = sim.assemble_device(
            out["packed"][:total], out["spyral_counts"],
            torch.arange(start, start + E), seed)
        ends = np.cumsum(out["spyral_counts"].numpy())
        for i, (lo, hi) in enumerate(zip(np.r_[0, ends[:-1]], ends)):
            got[start + i] = (spyral[lo:hi].numpy(), labels[lo:hi].numpy())
    ids = np.arange(3 * E)
    ref = PlainDetector(cfg, events.proton_numbers, events.mass_numbers,
                        ref_map, "cpu").simulate(events.vertices,
                                                 events.momenta, ids, seed)
    assert sorted(got) == sorted(ref)
    for ev, (rows, labels) in ref.items():
        assert np.array_equal(got[ev][0], rows), ev
        assert np.array_equal(got[ev][1], labels), ev
    assert sum(len(r[0]) for r in ref.values()) > 100 * 3 * E
    assert recorder.counters["step.graph"] == {}


# ----------------------------------------------------------------------- #
# the driver with one batch in flight, over the stand-in's graphs


class _Reader:
    """The first ``n`` committed flagship events."""

    def __init__(self, n: int):
        self.n_events = n
        self.proton_numbers = SMOKE["proton_numbers"]
        self.mass_numbers = SMOKE["mass_numbers"]

    def read_range(self, start, stop):
        return SMOKE["vertices"][start:stop], SMOKE["momenta"][start:stop]

    def close(self):
        pass


class _PoolWriter:
    """``write_spyral_pool``: each batch's assembled rows, as seen."""

    def __init__(self):
        self.seen = []

    def write_spyral_pool(self, spyral, labels, counts, event_numbers,
                          raw_counts=None):
        self.seen.append((np.asarray(event_numbers).copy(), spyral.copy(),
                          labels.copy(), np.asarray(counts).copy()))

    def close(self):
        pass


class _PackedWriter(_PoolWriter):
    """``write_packed``: each batch's packed rows, as seen."""

    def write_packed(self, packed, counts, event_numbers, raw_counts=None,
                     wiggle_seed=0):
        self.seen.append((np.asarray(event_numbers).copy(), packed.copy(),
                          np.asarray(counts).copy()))


def _faked(monkeypatch) -> list:
    """Every simulator made from here on steps through ``FakeCapture``'s
    graphs, as on the card: a replay overwrites the graph's outputs when it
    is dispatched. The stand-ins, in the order made."""
    fakes = []
    real = DetectorSimulator.__init__

    def init(self, *args, **kw):
        real(self, *args, **kw)
        fakes.append(FakeCapture())
        self._graphs = StepGraphs(self.device, backend=fakes[-1])

    monkeypatch.setattr(DetectorSimulator, "__init__", init)
    return fakes


def _drive(writer, n: int, **kw) -> dict:
    from attpc_engine_tpu_torch.detector.driver import run_reader

    auto_tune = kw.pop("auto_tune", True)
    engine = EngineParams(n_time_steps=N_STEPS, chunk_steps=100,
                          events_per_batch=E, **kw)
    return run_reader(_config(), _Reader(n), writer, engine=engine,
                      seed=11, show_progress=False, device="cpu",
                      auto_tune=auto_tune)


def _eager_batches(writer, n: int, budgets: dict) -> list:
    """The batches ``writer`` would see from the eager step, each run on
    its own at ``budgets`` (where nothing overflows), in order."""
    sim, _ = _simulator(graphs=False)
    seen = []
    token = profiling.begin_run(profiling.PhaseTimes())
    try:
        for start in range(0, n, E):
            out = _batch(sim, start, seed=11,
                         point_budget=budgets["point"],
                         uniq_budget=budgets["uniq"],
                         out_budget=budgets["out"], n_steps=N_STEPS)
            assert not overflow_kinds(StepMeta.decode(out["meta_i32"]))
            counts = out["spyral_counts"].numpy()
            packed = out["packed"][:counts.sum()]
            ids = np.arange(start, start + E)
            if isinstance(writer, _PackedWriter):
                seen.append((ids, packed.numpy(), counts))
            else:
                spyral, labels = sim.assemble_device(
                    packed, out["spyral_counts"], torch.from_numpy(ids), 11)
                seen.append((ids, spyral.numpy(), labels.numpy(), counts))
    finally:
        profiling.end_run(token)
    return seen


def _assert_seen(got: list, want: list) -> None:
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("writer_cls", [_PoolWriter, _PackedWriter],
                         ids=["assembled", "packed"])
def test_a_batch_in_flight_keeps_the_rows_of_the_one_before(
        monkeypatch, writer_cls):
    """A tuned run over six batches, each dispatched (eagerly, captured,
    then replayed, each replay overwriting the graph's outputs at once)
    before the batch before it is pulled: every batch's rows survive the
    next replay, and the writer sees the eager step's rows of each batch,
    in order. ``driver.ahead`` counts the probe and the batch after it
    serial, every later batch queued."""
    fakes = _faked(monkeypatch)
    writer = writer_cls()
    stats = _drive(writer, 6 * E)
    monkeypatch.undo()
    (fake,) = fakes
    assert fake.captures == 1 and fake.replays >= 3
    c = stats["counters"]
    assert c["driver.ahead"] == {"serial": 2, "queued": 4}
    # the probe's 100-step window climbs once, to the physics window
    assert c["step.graph"]["replay"] >= 2 and c["retries"] == {"steps": 1}
    _assert_seen(writer.seen, _eager_batches(writer, 6 * E,
                                             stats["budgets"]))


def test_an_overflow_before_a_batch_in_flight_runs_again_alone(
        monkeypatch):
    """From a point budget (320) that batch 0 overflows and batch 1 fits,
    without tuning, so that batch 1 is in flight, as a captured graph's
    run, when batch 0 runs again: the retry waits for batch 1 (``syncs``
    at ``retry``) and drops the graph, batch 1 keeps its rows, and the
    writer sees every event once with the eager step's rows."""
    fakes = _faked(monkeypatch)
    calls = []
    real = DetectorSimulator.simulate_batch

    def spy(self, vertices, momenta, *args, **kw):
        calls.append((kw["event_start"], kw["point_budget"]))
        return real(self, vertices, momenta, *args, **kw)

    monkeypatch.setattr(DetectorSimulator, "simulate_batch", spy)
    writer = _PoolWriter()
    stats = _drive(writer, 4 * E, point_budget=320, auto_tune=False)
    monkeypatch.undo()
    (fake,) = fakes
    c = stats["counters"]
    # batch 1 dispatched at 320 before batch 0 ran again at 640; batches 2
    # and 3 at 640, the second of them a capture
    assert calls[:3] == [(0, 320), (E, 320), (0, 640)]
    assert calls[3:] == [(2 * E, 640), (3 * E, 640)]
    assert c["retries"] == {"point": 1} and c["syncs"]["retry"] == 1
    assert c["driver.ahead"] == {"serial": 1, "queued": 3}
    assert fake.captures == 2 and stats["budgets"]["point"] == 640
    events = np.concatenate([s[0] for s in writer.seen])
    np.testing.assert_array_equal(events, np.arange(4 * E))
    _assert_seen(writer.seen, _eager_batches(writer, 4 * E,
                                             stats["budgets"]))
