"""One run of a cell: set-up, the measured window, the traced window's
per-layer metrics, and the comparison with the reference.

Set-up (``setup_s``, from the process's start to the window's start), in
the phases of ``SETUP_PHASES``: the imports and the CUDA context; the
detector's ``Config`` and its tables; the window's kinematics; one warm-up
run of ``run_reader`` over the window's first ``warmup_batches`` batches
(the probe and the tuned shapes), inside which the port loads its kernel
library on its first launch (built by nvcc on the first run in a
checkout), and the window's sink made ready. The window is one
``run_reader`` call over ``n`` events, a fixed amount of work (the cell's
``window_events_per_s`` times ``--seconds``, in whole batches), probe batch
and all, from the call to its return with the writer closed. The
kinematics come from the configuration's own seed where it names one, else
from ``--seed``; the detector's draws and the compared sample always from
``--seed``.
"""

from __future__ import annotations

import math
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import cells, compare, roofline
from .inputs import ArrayReader, Events
from .sink import Sink
from .trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "attpc_engine_tpu")
MAIN_PHASES = ("read", "dispatch", "pull-meta", "assemble-device",
               "pull-start")
WRITER_PHASES = ("pull-spyral", "h5py-write")
TRACE_SKIP = 2  # the probe batch and the first tuned one
TRACE_BATCHES = 24
# set-up's phases, each from the end of the one before (the first from the
# process's start, the last to the window's start)
SETUP_PHASES = ("imports", "config", "kinematics", "warmup")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def port_config(cfg: dict):
    """The port's ``Config`` of a configuration file's detector."""
    from attpc_engine_tpu_torch import nuclear_map
    from attpc_engine_tpu_torch.detector import (
        Config,
        DetectorParams,
        ElectronicsParams,
        PadParams,
    )
    from attpc_engine_tpu_torch.nuclear import GasTarget

    d = cfg["detector"]
    gas = GasTarget([tuple(c) for c in d["gas_components"]],
                    float(d["gas_pressure_torr"]), nuclear_map)
    return Config(
        DetectorParams(length=d["length"], efield=d["efield"],
                       bfield=d["bfield"], mpgd_gain=d["mpgd_gain"],
                       gas_target=gas, diffusion=d["diffusion"],
                       fano_factor=d["fano_factor"], w_value=d["w_value"]),
        ElectronicsParams(**cfg["electronics"]),
        PadParams(),
    )


def port_engine(cfg: dict):
    """The port's ``EngineParams``: the configuration's batch and physics
    window, every budget and path at the port's default."""
    from attpc_engine_tpu_torch.detector import EngineParams

    e = cfg["engine"]
    return EngineParams(events_per_batch=int(e["events_per_batch"]),
                        n_time_steps=int(e["n_time_steps"]),
                        dt=float(e["dt"]), chunk_steps=int(e["chunk_steps"]))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def kernel_library_s() -> float | None:
    """Seconds the port spent finding or building its kernel library
    (``kernels.build_seconds``), inside the warm-up; None where it has not
    loaded one."""
    from attpc_engine_tpu_torch import kernels

    built = kernels.build_seconds()
    return None if built is None else built["seconds"]


def drive(config, engine, events: Events, n: int, sink, seed: int, device,
          on_read=None) -> tuple[dict, float, float]:
    """``run_reader`` over events [0, n) into ``sink``: (its statistics,
    the call's wall seconds, the perf_counter at its start)."""
    from attpc_engine_tpu_torch.detector.simulator import run_reader

    reader = ArrayReader(events, n, on_read)
    sync(device)
    t0 = time.perf_counter()
    stats = run_reader(config, reader, sink, engine=engine, seed=seed,
                       show_progress=False, auto_tune=True, device=device)
    wall = time.perf_counter() - t0
    if not sink.closed:
        raise RuntimeError("run_reader did not close its writer")
    return stats, wall, t0


class RecordDispatches:
    """While entered, every ``DetectorSimulator.simulate_batch`` call tells
    ``tracer`` its events and budgets (for the rooflines' bytes)."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer

    def __enter__(self):
        from attpc_engine_tpu_torch.detector.simulator import DetectorSimulator

        self.cls = DetectorSimulator
        self.real = real = DetectorSimulator.simulate_batch
        tracer = self.tracer

        def simulate_batch(sim, vertices, momenta, *args, **kw):
            eng = sim.engine
            tracer.record_dispatch(
                len(vertices), kw.get("point_budget") or eng.point_budget,
                kw.get("uniq_budget") or eng.uniq_budget)
            return real(sim, vertices, momenta, *args, **kw)

        DetectorSimulator.simulate_batch = simulate_batch
        return self

    def __exit__(self, *exc):
        self.cls.simulate_batch = self.real
        return False


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda", root=cells.ROOT,
        here=cells.HERE) -> tuple[dict, list[str]]:
    """One run: (the result's JSON object, the lines of numbers compared
    beside their limits)."""
    cell = cells.find(cell_name, root, here)
    cfg, traffic = cell.config, cell.traffic
    eb = int(cfg["engine"]["events_per_batch"])
    sync(device)  # makes the CUDA context, a part of "imports"
    marks = [time.perf_counter()]
    config, engine = port_config(cfg), port_engine(cfg)
    marks.append(time.perf_counter())

    n = max(1, round(cell.window_events_per_s * seconds / eb)) * eb
    events = Events(cfg, n, cfg["kinematics"].get("seed", seed), device)
    marks.append(time.perf_counter())
    n_warm = min(cell.warmup_batches * eb, n)
    drive(config, engine, events, n_warm, Sink(traffic, n_warm, []), seed,
          device)
    rng = np.random.default_rng(seed)
    sample = rng.choice(n, min(compare.SAMPLE_EVENTS, n), replace=False)
    sink = Sink(traffic, n, sample)

    tracer = Tracer(TRACE_SKIP, TRACE_BATCHES, eb) if trace else None
    if tracer is not None:
        with RecordDispatches(tracer):
            stats, wall, t0 = drive(config, engine, events, n, sink, seed,
                                    device, tracer.on_read)
        tracer.stop(math.ceil(n / eb))
    else:
        stats, wall, t0 = drive(config, engine, events, n, sink, seed, device)
    setup_s = t0 - t_start
    bounds = [t_start, *marks, t0]
    setup = {p: b - a for p, a, b in zip(SETUP_PHASES, bounds, bounds[1:])}
    setup["kernel_library"] = kernel_library_s()  # inside "warmup"
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    batches = math.ceil(n / eb)
    received, missing = sink.events, sink.missing() + sink.malformed
    got = sink.kept()
    del sink, config, engine
    traced = tracer.trace() if tracer is not None else None
    if cuda:
        torch.cuda.empty_cache()

    # the reference, after the window, over the sampled and longest events
    from benchref import nuclear_map
    from benchref.detector.plain import PlainDetector

    t_ref = time.perf_counter()
    ids = np.array(sorted(set(int(i) for i in sample) | set(got)))
    ref = PlainDetector(cfg, events.proton_numbers, events.mass_numbers,
                        nuclear_map, device).simulate(
        events.vertices[ids], events.momenta[ids], ids, seed)
    ref_s = time.perf_counter() - t_ref
    numbers = compare.compare(got, ref, missing)
    ok, checks = compare.judge(numbers, cell.limits)

    metrics: dict = {}
    if not trace:
        values = {"events_per_s": (received / wall, "events/s"),
                  "setup_s": (setup_s, "s")}
        for m in cell.end_to_end:
            if m["name"] in values:
                v, unit = values[m["name"]]
                metrics[m["name"]] = {"value": v, "unit": unit}
    else:
        phases = dict(stats["phase_seconds"])
        phases["read"] = phases.get("read", 0.0) - tracer.own_s
        view = SimpleNamespace(
            phase_seconds=phases, batches=batches, trace=traced,
            setup_seconds=setup,
            main_phases=MAIN_PHASES, writer_phases=WRITER_PHASES,
            kernel_names=cells.load_json(here / "kernel_names.json"),
            roofline=roofline)
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"], here)(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    result = {
        "correct": bool(ok),
        "attempted": n,
        "failed": missing,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": int(peak),
                   "card": card() if cuda else "cpu"},
    }
    if traced is not None:
        result["device"]["busy_s"] = traced.busy_s()
        result["device"]["window_s"] = traced.window_s()
        result["breakdown"] = traced.breakdown()
    result["driver"] = {"phase_seconds": stats["phase_seconds"],
                        "budgets": stats["budgets"], "batches": batches,
                        "setup_seconds": setup}
    result["compared"] = {"events": len(ref),
                          "rows": int(sum(len(r[0]) for r in ref.values())),
                          "reference_s": ref_s, "window_s": wall,
                          **numbers}
    result["checks"] = checks
    lines = [f"{k}: {c['value']!r} (limit {c['limit']!r})"
             for k, c in checks.items()]
    return result, lines
