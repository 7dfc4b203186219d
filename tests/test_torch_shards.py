"""The driver over several devices: ``run_reader`` with a list of devices
cuts each batch into contiguous shards, one a device, each run on a host
thread of its own. On the CPU (``device=["cpu"] * k``), what must hold:

- the writer sees, bit for bit, the rows, labels, counts and merged counts
  of the one-device run, through each writer protocol (assembled rows,
  packed rows, each event's raw cloud), for two and four shards and on a
  short tail batch;
- a shard that overflows its point budget runs again alone, on its own
  device, and the batches dispatched after it is pulled start from the
  grown budget (the decay chain);
- a sharded run agrees with the benchmark's plain reference
  (``port_bench/benchref/detector/plain.py``) within ``chain.discard``'s
  limits;
- on one device the recorder's span names, counter names and sync sites
  are those of the one-device path; over several each card's thread has
  its ``shard.step``, ``shard.dispatch`` and ``shard.turn`` spans (the
  turns leave out the waits on the card and for the baton), its
  ``shard.events`` and its own sync sites, which the benchmark's shard
  metrics read;
- ``"cuda"`` means every card torch finds, ``"cuda:k"`` one card.

This file imports nothing of JAX; its ``cuda`` test runs the sharded path
on the card (two shards on one card where the machine has one).
"""

import contextvars
import importlib
import json
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from attpc_engine_tpu_torch import kernels, nuclear_map
from attpc_engine_tpu_torch.detector import (
    Config,
    DetectorParams,
    DetectorSimulator,
    ElectronicsParams,
    EngineParams,
    PadParams,
    sort_cuda,
)
from attpc_engine_tpu_torch.detector.driver import _shards
from attpc_engine_tpu_torch.detector.simulator import run_reader
from attpc_engine_tpu_torch.nuclear import GasTarget
from attpc_engine_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
SMOKE = np.load(REPO / "attpc_engine_tpu_torch" / "data"
                / "smoke_kinematics.npz")
SEED = 2
N_EVENTS = 5  # two batches of 4, the second a short tail of 1


def config() -> Config:
    """The upstream guide's default AT-TPC in D2 at 300 Torr."""
    gas = GasTarget([(1, 2, 2)], 300.0, nuclear_map)
    return Config(
        DetectorParams(length=1.0, efield=45000.0, bfield=2.85,
                       mpgd_gain=175000, gas_target=gas, diffusion=0.277,
                       fano_factor=0.2, w_value=34.0),
        ElectronicsParams(clock_freq=6.25, amp_gain=900, shaping_time=1000,
                          micromegas_edge=10, windows_edge=560,
                          adc_threshold=40),
        PadParams())


class Reader:
    """Events held in host arrays (the first ``n`` committed flagship
    events by default)."""

    def __init__(self, n: int = N_EVENTS, vertices=None, momenta=None,
                 z=None, a=None):
        self.vertices = SMOKE["vertices"] if vertices is None else vertices
        self.momenta = SMOKE["momenta"] if momenta is None else momenta
        self.proton_numbers = SMOKE["proton_numbers"] if z is None else z
        self.mass_numbers = SMOKE["mass_numbers"] if a is None else a
        self.n_events = n

    def read_range(self, start, stop):
        return self.vertices[start:stop], self.momenta[start:stop]

    def close(self):
        pass


class PoolWriter:
    """``write_spyral_pool``: each batch's assembled rows, as seen."""

    def __init__(self):
        self.seen = []

    def write_spyral_pool(self, spyral, labels, counts, event_numbers,
                          raw_counts=None):
        self.seen.append((spyral.copy(), labels.copy(),
                          np.asarray(counts).copy(),
                          np.asarray(event_numbers).copy(),
                          np.asarray(raw_counts).copy()))

    def close(self):
        pass


class PackedWriter(PoolWriter):
    """``write_packed`` (SpyralWriterProc's protocol): packed rows."""

    def write_packed(self, packed, counts, event_numbers, raw_counts=None,
                     wiggle_seed=0):
        self.seen.append((packed.copy(), np.asarray(counts).copy(),
                          np.asarray(event_numbers).copy(),
                          np.asarray(raw_counts).copy(), wiggle_seed))


class RawWriter:
    """``write`` (the reference protocol): each event's raw cloud."""

    def __init__(self):
        self.seen = []

    def write(self, data, labels, config, event_number):
        self.seen.append((data.copy(), labels.copy(), event_number))

    def close(self):
        pass


WRITERS = {"write_spyral_pool": PoolWriter, "write_packed": PackedWriter,
           "write": RawWriter}


@pytest.fixture(scope="module", autouse=True)
def one_thread_each():
    """One intra-op thread a PyTorch call, in the one-device runs as in
    the sharded ones: k host threads each fanning out to every core would
    oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(**kw) -> EngineParams:
    # the flagship's tracks live ~330 steps: the probe's 250-step window
    # climbs to the whole 500-step window
    base = dict(n_time_steps=500, chunk_steps=250, events_per_batch=4)
    return EngineParams(**{**base, **kw})


def _run(writer, devices, reader=None, engine=None, **kw) -> dict:
    return run_reader(config(), reader or Reader(), writer,
                      engine=engine or _engine(), seed=SEED,
                      show_progress=False, device=devices, **kw)


def _assert_same(seen_a: list, seen_b: list) -> None:
    assert len(seen_a) == len(seen_b) and seen_a
    for a, b in zip(seen_a, seen_b):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def one_device():
    """{writer protocol: (what the writer saw, the run's result)} on one
    device."""
    out = {}
    for name, cls in WRITERS.items():
        writer = cls()
        out[name] = (writer.seen, _run(writer, "cpu"))
    return out


# events each card runs: batch 0 (4 events) and the tail batch 1 (1)
CARD_EVENTS = {2: {"card-0": 3, "card-1": 2},
               4: {"card-0": 2, "card-1": 1, "card-2": 1, "card-3": 1}}


@pytest.mark.parametrize("protocol", list(WRITERS))
@pytest.mark.parametrize("k", [2, 4])
def test_sharded_run_writes_the_one_device_rows(one_device, k, protocol):
    writer = WRITERS[protocol]()
    stats = _run(writer, ["cpu"] * k)
    seen, ref = one_device[protocol]
    _assert_same(writer.seen, seen)
    assert stats["rows"] == ref["rows"] and stats["events"] == N_EVENTS
    # the probe's statistics, the largest of the shards', tune the budgets
    # as the whole batch's do on one device
    assert stats["budgets"] == ref["budgets"]
    assert set(stats["counters"]["retries"]) == set(
        ref["counters"]["retries"])
    assert stats["counters"]["shard.events"] == CARD_EVENTS[k]


def test_shards_cut_a_batch_into_contiguous_ranges():
    assert _shards(1536, 4) == [(0, 384), (384, 768), (768, 1152),
                                (1152, 1536)]
    assert _shards(3, 4) == [(0, 1), (1, 2), (2, 3)]
    assert _shards(5, 2) == [(0, 3), (3, 5)]
    assert _shards(1, 4) == [(0, 1)]


# ----------------------------------------------------------------------- #
# the decay chain, and the benchmark's plain reference


@pytest.fixture(scope="module")
def bench():
    """The benchmark's harness modules (``port_bench/``) and the decay
    chain's configuration file."""
    path = str(REPO / "port_bench")
    if path not in sys.path:
        sys.path.insert(0, path)
    cells = importlib.import_module("pbench.cells")
    cell = cells.find("chain.discard")
    return SimpleNamespace(
        cells=cells, cell=cell,
        compare=importlib.import_module("pbench.compare"),
        inputs=importlib.import_module("pbench.inputs"),
        runner=importlib.import_module("pbench.runner"),
        sink=importlib.import_module("pbench.sink"))


@pytest.fixture(scope="module")
def chain(bench):
    """Sixteen events of the decay chain (the benchmark's configuration,
    its own kinematics seed)."""
    cfg = bench.cell.config
    return bench.inputs.Events(cfg, 16, cfg["kinematics"]["seed"], "cpu")


def _chain_reader(chain, ids) -> Reader:
    return Reader(len(ids), chain.vertices[ids], chain.momenta[ids],
                  chain.proton_numbers, chain.mass_numbers)


def test_a_shard_that_overflows_runs_again_alone(bench, chain,
                                                 monkeypatch):
    """Three batches of the chain over two shards, from a point budget that
    batch 0's first shard fits and its second does not: only the second
    runs again, at twice the budget, on its own card's thread; batch 1,
    dispatched before batch 0 is pulled, keeps the first budget and each
    of its shards runs again only where it overflows that itself; batch 2
    is handed out at the grown budget. The writer sees the one-device
    run's rows, whose whole first batch ran again. (The merged windows of
    the chain's events need more than the default uniq budget.)"""
    ids = np.r_[0:4, 8:16]
    engine = dict(n_time_steps=2000, chunk_steps=500, events_per_batch=4,
                  uniq_budget=32768)
    sim = DetectorSimulator(config(), chain.proton_numbers,
                            chain.mass_numbers, device="cpu",
                            engine=EngineParams(**engine, point_budget=8192))
    peaks = []  # [batch][shard]
    for b in range(3):
        e = ids[4 * b:4 * b + 4]
        meta = sim.simulate_batch(chain.vertices[e], chain.momenta[e],
                                  seed=SEED, assemble=False)["meta_i32"]
        assert not meta[-5:-2].any()  # no overflow at these budgets
        points = meta[4:8].numpy()
        peaks.append([int(points[:2].max()), int(points[2:].max())])
    budget = min(peaks[0])
    assert budget < max(peaks[0])
    expected = []
    for b, handed in enumerate((budget, budget, 2 * budget)):
        for k in range(2):
            expected.append((f"card-{k}", 4 * b + 2 * k, handed))
            if peaks[b][k] > handed:
                assert peaks[b][k] <= 2 * handed
                expected.append((f"card-{k}", 4 * b + 2 * k, 2 * handed))
    assert len([c for c in expected if c[1] < 4]) == 3  # one shard again
    # batch 1's first shard again, as it overflows the first budget, and
    # no other
    assert [c[1] for c in expected if c[2] > budget] == [2, 4, 8, 10]
    calls = []
    real = DetectorSimulator.simulate_batch

    def spy(self, vertices, momenta, *args, **kw):
        calls.append((threading.current_thread().name, kw["event_start"],
                      kw["point_budget"]))
        return real(self, vertices, momenta, *args, **kw)

    monkeypatch.setattr(DetectorSimulator, "simulate_batch", spy)
    small = EngineParams(**engine, point_budget=budget)
    writer = PoolWriter()
    stats = _run(writer, ["cpu", "cpu"], _chain_reader(chain, ids), small,
                 auto_tune=False)
    assert sorted(calls) == sorted(expected)
    assert stats["counters"]["retries"] == {"point": len(expected) - 6}
    assert stats["budgets"]["point"] == 2 * budget
    calls.clear()
    one = PoolWriter()
    ref = _run(one, "cpu", _chain_reader(chain, ids), small,
               auto_tune=False)
    # batch 1 is dispatched at the first budget before batch 0 runs again,
    # and runs again itself where one of its events needs more
    again = [2 * budget] if max(peaks[1]) > budget else []
    assert [c[2] for c in calls] == [budget, budget, 2 * budget,
                                     2 * budget, *again]
    _assert_same(writer.seen, one.seen)
    assert ref["budgets"] == stats["budgets"]


def test_sharded_run_agrees_with_the_plain_reference(bench, chain):
    """Two shards of the decay chain through the benchmark's sink, held to
    ``benchref``'s plain detector by ``pbench/compare.py`` within
    ``chain.discard``'s limits (on the CPU, to the bit), both over a
    physics window of 2,000 steps."""
    from benchref import nuclear_map
    from benchref.detector.plain import PlainDetector

    cfg = dict(bench.cell.config)
    cfg["engine"] = {**cfg["engine"], "events_per_batch": 4,
                     "n_time_steps": 2000}
    ids = np.arange(4)
    sink = bench.sink.Sink(bench.cell.traffic, 4, ids)
    run_reader(bench.runner.port_config(cfg), _chain_reader(chain, ids),
               sink, engine=bench.runner.port_engine(cfg), seed=SEED,
               show_progress=False, device=["cpu"] * 2)
    assert sink.events == 4 and sink.missing() == 0 and sink.closed
    ref = PlainDetector(cfg, chain.proton_numbers, chain.mass_numbers,
                        nuclear_map, "cpu").simulate(
        chain.vertices[ids], chain.momenta[ids], ids, SEED)
    numbers = bench.compare.compare(sink.kept(), ref)
    ok, checks = bench.compare.judge(numbers, bench.cell.limits)
    assert ok, checks
    assert numbers["rows_unmatched"] == 0 and numbers["assembly_bits"] == 0
    assert sum(len(r[0]) for r in ref.values()) > 1000 * 4


# ----------------------------------------------------------------------- #
# spans and counters


def _traced(devices) -> tuple[dict, profiling.PhaseTimes]:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        stats = _run(PoolWriter(), devices, auto_tune=False)
    return stats, profiling.last_run()


def _names(rec) -> tuple:
    return ({s.name for s in rec.spans},
            {(name, site) for name, c in rec.counters.items()
             if isinstance(c, dict) for site in c},
            {name for name in rec.counters})


def test_one_device_keeps_its_names():
    """``["cpu"]`` is one device: the same spans, counters and sync sites
    as ``"cpu"``, and none of a card's."""
    _, rec = _traced("cpu")
    names = _names(rec)
    _, rec_list = _traced(["cpu"])
    assert _names(rec_list) == names
    spans, sites, counters = names
    assert spans == {"init", "read", "dispatch", "pull-meta",
                     "assemble-device", "pull-start", "pull-spyral",
                     "h5py-write", "step.prepare", "step.transport",
                     "step.fano", "step.deposit", "step.merge",
                     "step.convert"}
    # the merge sort's rows by route, as the events' prefixes fall
    routes = {site for name, site in sites if name == "merge_sort.rows"}
    assert routes and routes <= {"empty", "wide"} | {
        f"cluster-{n}" for n in sort_cuda.CLUSTER_SIZES}
    assert sites - {("merge_sort.rows", r) for r in routes} == {
        ("syncs", "pull-meta"), ("fano.draws", "plain"),
        ("driver.ahead", "serial"), ("driver.ahead", "queued")}
    assert counters == {"syncs", "pinned_allocs", "pinned_bytes", "retries",
                        "batches", "merge_sort.lanes",
                        "merge_sort.width_lanes", "merge_sort.rows",
                        "fano.draws", "step.graph", "driver.ahead"}
    assert {s.thread for s in rec.spans} == {"MainThread", "spyral-writer"}


def test_each_card_has_its_spans_and_sites():
    stats, rec = _traced(["cpu", "cpu"])
    by_thread: dict = {}
    for s in rec.spans:
        by_thread.setdefault(s.thread, set()).add(s.name)
    assert by_thread["MainThread"] == {"init", "read", "pull-start"}
    for k in (0, 1):
        assert by_thread[f"card-{k}"] == {
            "shard.step", "shard.dispatch", "shard.turn", "pull-meta",
            "assemble-device",
            "step.prepare", "step.transport", "step.fano", "step.deposit",
            "step.merge", "step.convert"}
    # a card's turn at each batch it dispatches, which pulls the shard in
    # flight on it; then a turn that pulls only: card-1's at the tail
    # batch (of one event, on card-0) and card-0's at the run's end
    steps = [s for s in rec.spans if s.name == "shard.step"]
    assert sorted((s.thread, s.batch) for s in steps) == [
        ("card-0", 0), ("card-0", 4), ("card-0", 4), ("card-1", 0),
        ("card-1", 0)]
    for s in rec.spans:
        if s.thread.startswith("card-") and s.name != "shard.step":
            top = s
            while top.parent is not None:
                top = top.parent
            assert top.name == "shard.step" and top.thread == s.thread
            # a pull of the batch before, in a turn that dispatched
            assert s.batch == top.batch or (
                s.name in ("pull-meta", "assemble-device")
                and (s.batch, top.batch) == (0, 4))
    c = stats["counters"]
    assert c["driver.ahead"] == {"serial": 1, "queued": 1}
    assert c["shard.events"] == {"card-0": 3, "card-1": 2}
    assert set(c["syncs"]) == {"pull-meta.card-0", "pull-meta.card-1"}
    assert c["syncs"]["pull-meta.card-0"] == 2
    assert c == rec.traced


def _metrics(bench) -> dict:
    return {name: bench.cells.metric_reader(name)
            for name in ("shard.step_ms_max_per_batch", "shard.imbalance",
                         "shard.idle_share_max", "driver.feed_ms_per_batch")}


def test_shard_metrics_read_the_cards_spans(bench):
    """The benchmark's readers of the shard spans: on the CPU no span is
    timed on a card, so the device-time metrics report nothing and the
    feed reads the cards' turns' host time; with device times set, the
    readers' arithmetic; on a one-device run's recorder, nothing."""
    readers = _metrics(bench)
    _, rec = _traced("cpu")
    run = SimpleNamespace(recorder=rec, trace=None)
    assert all(read(run) is None for read in readers.values())

    _, rec = _traced(["cpu", "cpu"])
    run = SimpleNamespace(recorder=rec, trace=None)
    turns = [s for s in rec.spans if s.name == "shard.turn"]
    assert readers["driver.feed_ms_per_batch"](run) == pytest.approx(
        1e-6 * sum(s.end_ns - s.start_ns for s in turns) / 2)
    for name in ("shard.step_ms_max_per_batch", "shard.imbalance",
                 "shard.idle_share_max"):
        assert readers[name](run) is None
    steps = sorted((s for s in rec.spans if s.name == "shard.step"),
                   key=lambda s: (s.batch, s.thread))
    # the tail is on one card; card-1 pulls its shard of batch 0 in a turn
    # of its own at the tail, and card-0 the tail's at the run's end
    assert [(s.batch, s.thread) for s in steps] == [
        (0, "card-0"), (0, "card-1"), (0, "card-1"), (4, "card-0"),
        (4, "card-0")]
    for s, t in zip(steps, (0.010, 0.030, 0.005, 0.020, 0.004)):
        s.device_s = t
    assert readers["shard.step_ms_max_per_batch"](run) == pytest.approx(25.0)
    # each card's turns in a batch: card-0 4 ms, card-1 12 ms in batch 0,
    # card-0 6 ms in the tail
    work = {(0, "card-0"): 0.004, (0, "card-1"): 0.012, (4, "card-0"): 0.006}
    assert set(work) == {(s.batch, s.thread) for s in turns}
    for s in turns:
        n = sum((t.batch, t.thread) == (s.batch, s.thread) for t in turns)
        s.device_s = work[s.batch, s.thread] / n
    assert readers["shard.imbalance"](run) == pytest.approx((1.5 + 1.0) / 2)
    wall = 1e-9 * (max(s.end_ns for s in steps)
                   - min(s.start_ns for s in steps))
    assert readers["shard.idle_share_max"](run) == pytest.approx(
        1 - 0.010 / wall)  # card-0's turns took 10 ms, card-1's 12


@pytest.mark.parametrize("devices", ["cpu", ["cpu", "cpu"]],
                         ids=["one_device", "two_shards"])
def test_ahead_share_reads_the_runs_counter(bench, devices):
    """The benchmark's ``driver.ahead_share`` on a traced run's recorder:
    of its two batches without tuning, the first is dispatched with
    nothing in flight and the second behind it, on one device as over
    several."""
    trace = importlib.import_module("pbench.trace").Trace.from_chrome(
        {"traceEvents": []}, batches=2, dispatches=[])
    read = bench.cells.metric_reader("driver.ahead_share")
    stats, rec = _traced(devices)
    assert stats["counters"]["driver.ahead"] == {"serial": 1, "queued": 1}
    run = SimpleNamespace(recorder=rec, trace=trace)
    assert read(run) == pytest.approx(0.5)


def test_turns_leave_out_the_waits():
    """A card thread's turns under a profiler: a ``shard.turn`` span from
    the block's start to each wait on the card and from each wait's end to
    the block's end, none of which holds the wait's time; the baton is
    given up inside the wait, and held again after it."""
    times = profiling.PhaseTimes()
    baton = threading.Lock()
    token = profiling.begin_run(times)
    held = []

    def card():
        profiling.on_card("card-0", torch.device("cpu"), baton)
        with baton, profiling.card_turns(times, 8):
            for _ in range(2):
                with profiling.device_wait():
                    held.append(baton.locked())
                    time.sleep(0.05)
                held.append(baton.locked())

    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            t = threading.Thread(target=contextvars.copy_context().run,
                                 args=(card,), name="card-0")
            t.start()
            t.join(timeout=60)
    finally:
        profiling.end_run(token)
    assert held == [False, True, False, True]
    turns = sorted((s for s in times.spans if s.name == "shard.turn"),
                   key=lambda s: s.start_ns)
    assert len(turns) == 3
    assert all(s.batch == 8 and s.thread == "card-0" for s in turns)
    for a, b in zip(turns, turns[1:]):
        assert b.start_ns - a.end_ns >= 0.05e9
    assert sum(s.end_ns - s.start_ns for s in turns) < 0.05e9
    # no profiler: no turn
    times = profiling.PhaseTimes()
    t = threading.Thread(target=contextvars.copy_context().run, args=(card,))
    t.start()
    t.join(timeout=60)
    assert times.spans == []


def test_card_counts_under_many_threads():
    """The recorder's counters from more card threads than cores, under a
    short switch interval: no count is lost, and each card's sync site is
    its own."""
    times = profiling.PhaseTimes()
    token = profiling.begin_run(times)
    n_threads, n = 16, 500

    def work(k):
        profiling.on_card(f"card-{k}", torch.device("cpu"))
        for _ in range(n):
            profiling.count("syncs", "pull-meta")
            profiling.count("shard.events", f"card-{k}", 2)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=contextvars.copy_context().run,
                                    args=(work, k))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        profiling.end_run(token)
    assert not any(t.is_alive() for t in threads)
    assert times.counters["syncs"] == {
        f"pull-meta.card-{k}": n for k in range(n_threads)}
    assert times.counters["shard.events"] == {
        f"card-{k}": 2 * n for k in range(n_threads)}


# ----------------------------------------------------------------------- #
# devices


def test_cuda_means_every_card(monkeypatch):
    assert kernels.require_devices("cpu") == [torch.device("cpu")]
    assert kernels.require_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="one type"):
        kernels.require_devices(["cpu", "meta"])
    with pytest.raises(ValueError, match="one type"):
        kernels.require_devices([])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert kernels.require_devices("cuda") == [
        torch.device("cuda", k) for k in range(4)]
    assert kernels.require_devices(torch.device("cuda")) == [
        torch.device("cuda", k) for k in range(4)]
    assert kernels.require_devices("cuda:2") == [torch.device("cuda", 2)]
    assert kernels.require_devices(torch.device("cuda", 1)) == [
        torch.device("cuda", 1)]


def test_manifest_records_the_devices_used(tmp_path):
    class Dir(PoolWriter):
        def get_directory_name(self):
            return tmp_path

    _run(Dir(), ["cpu", "cpu"])
    (path,) = tmp_path.glob("run_manifest_*.json")
    backend = json.loads(path.read_text())["backend"]
    assert backend["n_devices"] == 2 and backend["devices"] == ["cpu", "cpu"]


@pytest.mark.cuda
def test_sharded_run_on_the_card(tmp_path):
    """The sharded path on CUDA devices: two shards (two cards, or two
    threads on one card) write the one-card run's rows bit for bit, and
    each card's ``shard.step`` and turns are timed on its stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch finds none")
    n = min(torch.cuda.device_count(), 2)
    devices = [f"cuda:{k % n}" for k in range(2)]
    one = PoolWriter()
    _run(one, "cuda:0")
    two = PoolWriter()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        stats = _run(two, devices)
    _assert_same(two.seen, one.seen)
    rec = profiling.last_run()
    # each card's turns at the probe (its dispatch, then its pull before
    # any other dispatch), card-0's at the one-event tail and at the run's
    # end, where it pulls the tail
    steps = [s for s in rec.spans if s.name == "shard.step"]
    assert sorted((s.thread, s.batch) for s in steps) == [
        ("card-0", 0), ("card-0", 0), ("card-0", 4), ("card-0", 4),
        ("card-1", 0), ("card-1", 0)]
    assert all(s.device_s > 0 for s in steps)
    turns = [s for s in rec.spans if s.name == "shard.turn"]
    assert len(turns) > 3 and all(s.device_s >= 0 for s in turns)
    assert rec._pending == []
    assert {site for site in stats["counters"]["syncs"]
            if site.startswith("copy-finish")} == {
        "copy-finish.card-0", "copy-finish.card-1"}
