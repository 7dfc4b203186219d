"""The port's spans and counters (``utils/profiling.py``) through its
driver loop ``run_reader``, on the CPU; the CUDA events of the step's
stages in the ``cuda``-marked test. This file imports nothing of JAX, so
that it also runs on a card's machine (``--noconftest``).

What must hold:

- the step's stages nest in their batch's ``dispatch`` span and share its
  batch id;
- ``phase_seconds`` keeps its keys, plus ``init``;
- with no profiler no span is kept, no ``record_function`` range entered
  and no CUDA event made, while the counters count;
- under ``trace_to`` every span of the thread that ran the profiler has a
  ``user_annotation`` twin in the Chrome file, stamped on Kineto's time
  base (Unix seconds rounded down to a multiple of 7,889,238, which
  reproduces the file's ``baseTimeNanoseconds``) between the clock's two
  readings around the span's entry, to the trace's 1 us;
- a run forced into one "point" overflow counts one retry, and the wait
  for the batch in flight before it runs again;
- the merge sort's counters ("merge_sort.*") are the prefixes the steps
  handed K3's live route, and the routes those prefixes take;
- ``run_reader``'s result and the run manifest hold the counters and spans.
"""

import glob
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from attpc_engine_tpu_torch import nuclear_map
from attpc_engine_tpu_torch.detector import (
    Config,
    DetectorParams,
    EngineParams,
    ElectronicsParams,
    PadParams,
)
from attpc_engine_tpu_torch.detector import deposition, sort_cuda
from attpc_engine_tpu_torch.detector.simulator import run_reader
from attpc_engine_tpu_torch.nuclear import GasTarget
from attpc_engine_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
SMOKE = np.load(REPO / "attpc_engine_tpu_torch" / "data"
                / "smoke_kinematics.npz")
TRIMESTER_NS = 7_889_238 * 10**9
PHASES = {"read", "dispatch", "pull-meta", "assemble-device", "pull-start",
          "pull-spyral", "h5py-write"}
STAGES = ["step.prepare", "step.transport", "step.fano", "step.deposit",
          "step.merge", "step.convert"]


def config() -> Config:
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
    """The first ``n`` committed flagship events."""

    def __init__(self, n: int = 8):
        self.n_events = n
        self.proton_numbers = SMOKE["proton_numbers"]
        self.mass_numbers = SMOKE["mass_numbers"]

    def read_range(self, start, stop):
        return SMOKE["vertices"][start:stop], SMOKE["momenta"][start:stop]

    def close(self):
        pass


class Writer:
    """A ``write_spyral_pool`` writer that keeps nothing, with a
    directory for the run manifest."""

    def __init__(self, directory: Path):
        self.directory = directory
        self.batches = 0

    def write_spyral_pool(self, spyral, labels, counts, event_numbers,
                          raw_counts=None):
        self.batches += 1

    def get_directory_name(self):
        return self.directory

    def close(self):
        pass


def run(directory: Path, device="cpu", **engine) -> dict:
    # the tracks live ~330 steps: two 250-step windows, no "steps" retry
    eng = EngineParams(**{"n_time_steps": 500, "chunk_steps": 250,
                          "events_per_batch": 4, **engine})
    directory.mkdir(parents=True, exist_ok=True)
    return run_reader(config(), Reader(), Writer(directory), engine=eng,
                      seed=2, show_progress=False, auto_tune=False,
                      device=device)


def manifest(directory: Path) -> dict:
    (path,) = glob.glob(str(directory / "run_manifest_*.json"))
    return json.loads(Path(path).read_text())


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One run under ``trace_to``: (result, recorder, Chrome trace, the
    run's directory)."""
    d = tmp_path_factory.mktemp("traced")
    with profiling.trace_to(d / "trace"):
        stats = run(d / "out")
    (path,) = glob.glob(str(d / "trace" / "trace_*.json"))
    return stats, profiling.last_run(), json.loads(Path(path).read_text()), d


def test_step_stages_nest_in_dispatch_and_share_its_batch(traced):
    _, rec, _, _ = traced
    dispatches = [s for s in rec.spans if s.name == "dispatch"]
    assert [s.batch for s in dispatches] == [0, 4]
    for name in STAGES:
        steps = [s for s in rec.spans if s.name == name]
        assert len(steps) == 2, name
        for s in steps:
            assert s.parent in dispatches and s.batch == s.parent.batch
            assert s.parent.start_ns <= s.start_ns <= s.end_ns <= (
                s.parent.end_ns)
            assert s.device_s is None  # no card, no CUDA events
    # the phases are at the top of their thread, with their batch
    for s in rec.spans:
        if s.name in PHASES:
            assert s.parent is None and s.batch in (0, 4)
    (init,) = [s for s in rec.spans if s.name == "init"]
    assert init.batch is None and init.end_ns <= min(
        s.start_ns for s in rec.spans if s.name == "read")


def test_phase_seconds_keep_their_keys_plus_init(traced, tmp_path):
    for stats in (traced[0], run(tmp_path)):
        assert set(stats["phase_seconds"]) == PHASES | {"init"}
        assert all(v > 0 for v in stats["phase_seconds"].values())


def test_no_profiler_no_span_no_range_no_event(tmp_path, monkeypatch):
    made = {"record_function": 0, "Event": 0}
    real_rf, real_event = (torch.autograd.profiler.record_function,
                           torch.cuda.Event)

    def counting(name, real):
        def make(*args, **kw):
            made[name] += 1
            return real(*args, **kw)
        return make

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting("record_function", real_rf))
    monkeypatch.setattr(torch.cuda, "Event", counting("Event", real_event))
    stats = run(tmp_path)
    rec = profiling.last_run()
    assert made == {"record_function": 0, "Event": 0}
    assert rec.spans == [] and stats["spans"] == {}
    # a stage is one flag check: the same shared block, nothing allocated
    assert profiling.stage("step.fano") is profiling.stage("step.merge")
    # the counters count all the same; none while no profiler records
    c = stats["counters"]
    assert c["syncs"]["pull-meta"] == 2
    # the transport windows are gated on the device: no sync between them
    assert "transport.window" not in c["syncs"]
    assert c["batches"] == 0 and rec.traced["syncs"] == {}


def test_spans_are_on_the_profilers_clock(traced):
    _, rec, data, _ = traced
    first = min(s.start_ns for s in rec.spans)
    base = first // TRIMESTER_NS * TRIMESTER_NS
    assert data["baseTimeNanoseconds"] == base
    twins: dict = {}
    for ev in data["traceEvents"]:
        if ev.get("cat") == "user_annotation":
            twins.setdefault(ev["name"], []).append(float(ev["ts"]))
    main = [s for s in rec.spans if s.thread == "MainThread"]
    assert {s.name for s in main} == {"init", "read", "dispatch",
                                      "pull-meta", "assemble-device",
                                      "pull-start", *STAGES}
    # the nth range of a name was stamped while the nth span of the name
    # entered it: between the clock's two readings around the entry, give
    # or take the trace's rounding to 1 us (however long the host took)
    for name in {s.name for s in main}:
        spans = sorted((s for s in main if s.name == name),
                       key=lambda s: s.start_ns)
        assert len(twins[name]) == len(spans), name
        for s, ts in zip(spans, sorted(twins[name])):
            lo, hi = ((t - base) * 1e-3 for t in s.entered_ns)
            assert lo - 1.0 <= ts <= hi + 1.0, (name, lo, ts, hi)
            assert lo <= (s.start_ns - base) * 1e-3 <= hi, name
    # the writer thread's spans enter no range (torch records the ranges
    # of the profiler's own thread) but are kept on the same clock
    writer = [s for s in rec.spans if s.thread != "MainThread"]
    assert {s.name for s in writer} == {"pull-spyral", "h5py-write"}
    assert "pull-spyral" not in twins and "h5py-write" not in twins
    assert all(first <= s.start_ns <= s.end_ns
               <= max(m.end_ns for m in main) + 10**9 for s in writer)


def test_the_step_alone_enters_its_ranges(traced):
    """``simulate_batch`` called outside ``run_reader`` has no recorder:
    under a profiler its stages are ranges of the trace all the same, and
    no run's recorder gains a span."""
    from attpc_engine_tpu_torch.detector import DetectorSimulator

    rec = traced[1]
    kept = len(rec.spans)
    sim = DetectorSimulator(config(), SMOKE["proton_numbers"],
                            SMOKE["mass_numbers"], device="cpu",
                            engine=EngineParams(n_time_steps=500,
                                                chunk_steps=250))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sim.simulate_batch(SMOKE["vertices"][:2], SMOKE["momenta"][:2],
                           seed=2, assemble=False)
    names = {e.name for e in prof.events()}
    assert set(STAGES) <= names
    assert len(rec.spans) == kept


def test_a_point_overflow_counts_one_retry(tmp_path):
    # the first batch's busiest event deposits 404 points, the second's
    # 287: at 320 the first runs again at 640, and the second, dispatched
    # at 320 before the first is pulled, fits; the retry waits for it
    stats = run(tmp_path, point_budget=320)
    assert stats["counters"]["retries"] == {"point": 1}
    assert stats["budgets"]["point"] == 640
    assert stats["counters"]["syncs"] == {"pull-meta": 3, "retry": 1}


@pytest.mark.parametrize("merge", ["sorts", "fused"])
def test_merge_sort_counters_are_the_prefixes_the_sort_took(
        tmp_path, monkeypatch, merge):
    """Every step of the default configuration (the retried one included)
    hands K3's live route each event's prefix; "merge_sort.lanes" is their
    sum, "merge_sort.width_lanes" the rows' lanes, "merge_sort.rows" the
    events by the route their prefix takes. The fused merge sorts nothing
    on that route and counts nothing."""
    seen = []
    real = deposition.sort_rows_live

    def spy(rows, lanes):
        seen.append((rows.shape, lanes.clone()))
        return real(rows, lanes)

    monkeypatch.setattr(deposition, "sort_rows_live", spy)
    stats = run(tmp_path, point_budget=320, merge=merge)
    c = stats["counters"]
    if merge == "fused":
        assert not seen and c["merge_sort.lanes"] == 0
        assert c["merge_sort.width_lanes"] == 0 and c["merge_sort.rows"] == {}
        return
    assert len(seen) == 3 and c["retries"] == {"point": 1}
    lanes = np.concatenate([la.numpy() for _, la in seen])
    assert c["merge_sort.lanes"] == int(lanes.sum()) > 0
    assert c["merge_sort.width_lanes"] == sum(e * w for (e, w), _ in seen)
    assert c["merge_sort.lanes"] < c["merge_sort.width_lanes"]
    assert c["merge_sort.rows"] == sort_cuda.live_sites(lanes)
    assert sum(c["merge_sort.rows"].values()) == 12


def test_result_and_manifest_hold_counters_and_spans(traced):
    stats, rec, _, d = traced
    m = manifest(d / "out")
    assert m["counters"] == stats["counters"]
    assert m["spans"] == json.loads(json.dumps(stats["spans"]))
    c = stats["counters"]
    assert c["batches"] == 2 and c["retries"] == {}
    assert c["syncs"] == {"pull-meta": 2}
    assert c == rec.traced  # the profiler recorded the whole run
    assert c["pinned_allocs"] == c["pinned_bytes"] == 0  # no card
    s = stats["spans"]
    assert set(s) == PHASES | {"init", *STAGES}
    assert s["dispatch"]["count"] == 2 and s["init"]["count"] == 1
    assert all(v["host_s"] > 0 and v["device_s"] is None for v in s.values())
    assert s["dispatch"]["host_s"] >= sum(s[k]["host_s"] for k in STAGES)


@pytest.mark.cuda
def test_step_stages_time_the_card(tmp_path):
    """On the card every stage span holds the stream's time between its
    two CUDA events, read after the batch's metadata sync; the copies
    count their page-locked buffers and waits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch finds none")
    run(tmp_path / "warm", device="cuda")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        stats = run(tmp_path / "out", device="cuda")
    rec = profiling.last_run()
    for name in STAGES:
        steps = [s for s in rec.spans if s.name == name]
        assert len(steps) == 2 and all(s.device_s > 0 for s in steps), name
        assert stats["spans"][name]["device_s"] == pytest.approx(
            sum(s.device_s for s in steps))
    dispatch = sum(s.end_ns - s.start_ns for s in rec.spans
                   if s.name == "dispatch") * 1e-9
    c = stats["counters"]
    assert c["pinned_allocs"] >= 2 and c["pinned_bytes"] > 0
    assert c["syncs"]["copy-finish"] == 4  # rows and labels, two batches
    assert rec._pending == [] and dispatch > 0
