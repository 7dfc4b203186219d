"""Smoke run of the PyTorch port (attpc_engine_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each raises on failure, and nothing is caught):

1. The card's name and power limit (nvidia-smi); a CUDA device is required.
2. Build the CUDA kernels from ``attpc_engine_tpu_torch/csrc`` with nvcc
   for sm_90a (one nvcc per source, in parallel) into the git-ignored build
   directory, as ``libattpc_kernels-<hash of the sources>.so``; printed:
   whether this run built it or found it built from the same sources.
3. Each kernel against its plain PyTorch version on the card, at the shapes
   of the flagship batch (384 events): K1 transport (768 tracks, one
   500-step window; alive flags exact, positions within 1e-6 m, |dKE|
   within 1e-4 MeV, and bit for bit its own run with every step through
   the compiler's IEEE operators, ``force_ieee``), the deposit-rows kernel
   (the default step's mesh, lookup and charges in one kernel; bit-exact
   against its plain version, on the flagship's own points taken from a
   default batch and on synthetic points with every edge
   case), K2 pad lookup (393,216 points of random cells and one fewer, so
   that the last block holds fewer quads than threads; and the flagship's
   own points, taken from a fused batch; bit-exact, one launch a call), K3
   row sort ([384, 102400] and [384, 12288] int64; bit-exact), K6 one-stage
   lookup (393,216 points of random cells and one fewer, so that the last
   warp holds fewer than 32 rows; and the flagship's own points;
   bit-exact against its plain version and K2), K7 pad ids (the same
   inputs as K2; bit-exact, one launch a call), K5 fused merge (key2 and
   n_uniq exact, c2 bit-exact; on the route ``merge_cuda.route`` gives the
   width, whose own counter must count the launch; the cluster route,
   ``csrc/merge_cluster.cu``, must allocate nothing but its outputs) on the
   flagship's own merge keys ([384, 102400], rank_bits 1, taken from a
   fused batch), on synthetic keys at [384, 102400] (rank_bits 2), at one
   width for each cluster size (12,288, 25,600, 51,200 and 204,800 for 1,
   2, 4 and 16 CTAs), at the route's widest rows [384, 213760] with a row
   of sentinels only, a row with no sentinel, a row of one live lane and
   cap 1,000 (below n_uniq, not a multiple of 128), at the width 100,003
   (not a multiple of 128), and at [384, 250000] on the two-launch route
   (pack64, K3, then ``csrc/merge_fused.cu``); each timed beside the
   two-launch route on the same rows, with the rows' live share. K3 is held
   on each of its shapes and routes: synthetic
   merge rows and the flagship's own merge rows (taken from a default
   batch) at [384, 102400] and convert rows at [384, 12288] on the cluster
   route (8 and 1 CTAs), the first overflow-retry doubling [384, 204800]
   (16 CTAs), and on the wide route (chunk sorts by the cluster kernel,
   then ``csrc/merge_rows.cu``'s merge passes) merge rows [384, 409600]
   and [384, 819200] (point budgets 4,096 and 8,192), signed convert rows
   [384, 393216] (five uniq-budget doublings), the odd width [384,
   262145] and [384, 409600] rows of one value; each must take the route
   and plan ``sort_cuda.route`` gives it, the cluster route must allocate
   nothing but its output and the wide route nothing but its output, one
   scratch of the rows' size and its split table; the wide route's
   design floor (1 + log2 chunks times the bound) is printed beside its
   bound. Times by CUDA events, beside each kernel's
   bound (bytes over 3.35 TB/s or f32 operations over 67 TFLOP/s,
   whichever is larger; for K1 also its latency bound: the critical path
   of one step in the SASS of this checkout's ``transport.cu``, at
   latencies measured on the card in this run
   (``tools/k1_critical_path.py``), times the steps of the longest-lived
   track at the highest SM clock) and, where one PyTorch call computes the
   same function, that call's time; for the deposit-rows kernel also the
   time of the rows built as the default step built them before it
   (``deposit_rows_plain`` with K2 as its lookup). How ATen's CUDA division
   by a CPU scalar rounds is printed beside them.
4. The main path: the flagship configuration (12C(d,p) at 120 MeV through
   D2 at 300 Torr, the default AT-TPC detector) at the default engine
   parameters with 384 events per batch, four batches of the committed
   kinematics (``attpc_engine_tpu_torch/data/smoke_kinematics.npz``)
   through ``DetectorSimulator.simulate_batch`` and the host Spyral
   assembly. h5py is not required on the card, so the HDF5 writers are not
   driven here. K1, the deposit-rows kernel and K3 must have been launched
   by this phase, K2 not, K3 on its cluster route only; the rows must be
   well formed; eight events run on the card must agree with the same
   eight run on the CPU through the plain versions.
4b. The fused configuration, ``EngineParams(merge="fused",
   lookup="one_stage")``, over the same four batches at full width: K1, K5
   on its cluster route (once a batch), K3 (once a batch, the convert sort,
   cluster route only) and K6 must have been launched, and K5's two-launch
   route, K2 and the deposit-rows kernel not; its first batch's merged
   cloud must equal the default configuration's in every integer, with
   charges within rtol 1e-5 and a one-electron floor.
4g. The fused two-stage configuration, ``EngineParams(merge="fused",
   lookup="two_stage")``, the port's counterpart of the JAX package's
   ``pallas_sort="fused"`` with its default two-stage lookup, over the
   same four batches at full width: K1 must have been launched, K2, K5 on
   its cluster route and K3 (the convert sort, cluster route only) once a
   batch each, and K6, K7, the deposit-rows kernel, K5's two-launch
   route and K3's wide route not; its first batch's ``meta_i32`` and
   packed rows must equal phase 4b's first batch bit for bit (K2 and K6
   share one contract).
4e. The retry-width step: the default configuration at point_budget=4096,
   the budget ``run_simulation``'s overflow retry reaches after two
   doublings, over two batches (the first is warm-up): K1, the
   deposit-rows kernel and K3 must have been launched, K3 on its wide route
   for both merge sorts of each batch ([384, 409600] rows) and on its
   cluster route for the convert sort; the first batch's ``meta_i32`` and
   packed rows must equal, bit for bit, phase 4's first batch (point
   budget 1,024).
4f. The fused configuration at point_budget=2500, whose merge rows of
   250,000 lanes are past K5's cluster route, over two batches (the first is
   warm-up): K5 on its two-launch route once a batch, with K3 on its wide
   route for it and on its cluster route for the convert sort, K6 and K1;
   the first batch's ``meta_i32`` and packed rows must equal phase 4b's
   first batch bit for bit.
4h. The driver: ``run_simulation``'s batch loop (``simulator.run_reader``;
   the card has no h5py, so a reader over the committed kinematics stands
   in for the HDF5 one) at the flagship's ``EngineParams(events_per_batch=
   384)`` with ``auto_tune=True``, over the 1,536 events, with a writer
   that takes assembled rows (``write_spyral_pool``, so that assembly runs
   on the driver's writer thread) and keeps them. Run A: the first batch
   must run the 500-step probe; the tuned budgets (printed) must be no
   wider than the defaults; K1, the deposit-rows kernel and K3 (cluster
   route only) must have been launched, K2 not; every batch's assembled
   rows must equal, bit for bit, the host assembly of phase 4's packed
   rows of the same events (same seed and wiggle seed) at the full
   10,000-step window and the default budgets, which catches a race in
   the pinned copy. Run B: two batches from ``point_budget=256``, whose
   first batch must run again exactly once, on "point", and whose rows
   must equal run A's. Printed: the driver's phase times and end-to-end
   events/s, and the default step alone at run A's tuned window and
   budgets (four batches, its first equal to phase 4's bit for bit)
   beside phase 4's; K3 on the flagship's merge rows at the tuned width.
4k. The kinematics stage on the card at full width (no kernel of the port:
   it is PyTorch on the card, as the JAX package's is XLA): four cases of
   65,536 events each, ``run_kinematics_pipeline``'s default batch, through
   ``run_kinematics`` into an in-memory writer: (A) the flagship (12C(d,p)
   at 120 MeV, ground state, polar angle uniform in [0, pi], no target),
   (B) the flagship through D2 at 300 Torr (z in [0.2, 0.8] m, rho sigma
   0.007 m), (C) the three-step chain 10B(3He,4He)9B, 9B -> 4He + 5Li,
   5Li -> 4He + p, (D) 12C(d,p) at 16 MeV with Ex uniform in [0, 30] MeV
   (about 0.55 of lanes accepted a draw). Each: momentum conserved on all
   events within 1e-8 MeV; its first 4,096 events equal to the port's CPU
   run of the same seed (accepted lanes and the draw that accepted each
   exact, momenta within 1e-9 MeV, vertices within 1e-12 m); its number of
   draws printed, and (C) and (D) must need more than one. No kernel may
   launch. Printed: (A)'s events/s, sampling plus the copy to the host,
   warm (mean of five runs).
4i. The two-stage chain on the card: the first 1,536 events of 4k's (A)
   through the driver loop as phase 4h runs the committed ones
   (``run_reader``, ``EngineParams(events_per_batch=384)``,
   ``auto_tune=True``, a writer of assembled rows): the first dispatch the
   probe, the tuned budgets no wider than the defaults, K1, the
   deposit-rows kernel and K3 (cluster route only) launched, K2 not; every
   assembled row well formed; eight events of the first batch agree with
   the same eight run on the CPU through the plain versions. Printed: its
   end-to-end events/s.
4m. One process per slice on the card: the first 6,144 events of 4k's
   (A), first through ``run_reader`` in this process (as 4h, auto-tuned,
   384 events a batch; the single run), then split over three processes
   started together on ``cuda:0`` (this script in its child mode, with
   ``RANK`` 0-2, ``WORLD_SIZE`` 3, ``LOCAL_RANK`` 0): each resolves its
   ids and card as ``run_simulation_multihost`` does
   (``parallel.resolve_process``), takes its slice from
   ``parallel.process_plan`` (2,048 events, off the 384-event grid: its
   last batch holds 128), and runs it through ``run_reader`` at the same
   engine parameters and seed into a writer of assembled rows. The union
   of the three processes' rows must equal the single run's bit for bit
   (Spyral rows, labels, counts and event numbers, in event order); every
   process must have launched K1, the deposit-rows kernel and K3 (cluster
   route only) and not K2, must have loaded the library phase 2 built
   without compiling (``kernels.build_seconds()``), and must exit with 0.
   Printed: each process's events/s, phase seconds and device memory, and
   the three processes' events/s over the window from the first one's
   start to the last one's end beside the single run's. The HDF5 side of
   ``run_simulation_multihost`` (``SpyralWriterProc``'s files, the resume
   scan, the run-number blocks) needs h5py, which the card's Python lacks:
   tests/test_torch_parallel.py holds it on the CPU.
4c. The pad-id entry point ``deposit_cuda.pad_lookup`` at 393,216 points:
   K7 must have been launched.
4d. The key entry point ``deposit_cuda.packed_key_lookup`` at 393,216
   points: K2 must have been launched.
5. One JSON line of kernel results, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

Launch counts are set to 0 just before each of 4, 4b, 4g, 4e, 4f, 4h (run
A), 4k, 4i, 4m (the single run, and each process's run in that process),
4c and 4d and read just after it. Exits non-zero, with no result line, where there
is no CUDA device or no repository beside the script.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH = 384
SEED = 1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12  # f32 outside the tensor cores, the same source
# f32 operations of one RK4 step of one live track in csrc/transport.cu,
# counting each logf, sqrtf and division as one: four right-hand sides of
# ~48 and ~78 for the stage inputs, the update, the kinetic energy and the
# stop tests. They give the contract's throughput bound, which K1 is far
# from: its bound is latency (check_transport).
K1_FLOPS_PER_STEP = 270

# name: (wrapper module, launch counter, source, TPU kernel, path)
KERNELS = {
    "transport": ("transport_cuda", "launches",
                  "attpc_engine_tpu_torch/csrc/transport.cu",
                  "attpc_engine_tpu/detector/transport_pallas.py:45",
                  "default"),
    "deposit_rows": ("deposit_cuda", "launches_deposit_rows",
                     "attpc_engine_tpu_torch/csrc/deposit_rows.cu",
                     "attpc_engine_tpu/detector/deposit_pallas.py:210",
                     "default"),
    "deposit": ("deposit_cuda", "launches",
                "attpc_engine_tpu_torch/csrc/deposit.cu",
                "attpc_engine_tpu/detector/deposit_pallas.py:210",
                "fused_two_stage"),
    "sort_rows": ("sort_cuda", "launches",
                  "attpc_engine_tpu_torch/csrc/sort_cluster.cu",
                  "attpc_engine_tpu/detector/sort_pallas.py:366", "default"),
    # K3's wide route: chunk sorts by the cluster kernel, then merge passes
    "sort_rows_wide": ("sort_cuda", "launches_wide",
                       "attpc_engine_tpu_torch/csrc/merge_rows.cu",
                       "attpc_engine_tpu/detector/sort_pallas.py:366",
                       "retry_width"),
    # K5: one cluster kernel on rows of at most 213,760 lanes
    "merge_cluster": ("merge_cuda", "launches_cluster",
                      "attpc_engine_tpu_torch/csrc/merge_cluster.cu",
                      "attpc_engine_tpu/detector/sort_pallas.py:279", "fused"),
    # K5's two-launch route on wider rows: pack64, K3, then the tail kernel
    "merge_fused": ("merge_cuda", "launches_two_launch",
                    "attpc_engine_tpu_torch/csrc/merge_fused.cu",
                    "attpc_engine_tpu/detector/sort_pallas.py:279",
                    "fused_wide"),
    "packed_key_lookup_rows": (
        "deposit_cuda", "launches_rows",
        "attpc_engine_tpu_torch/csrc/deposit.cu",
        "attpc_engine_tpu/detector/deposit_pallas.py:124", "fused"),
    "pad_lookup": ("deposit_cuda", "launches_pad_lookup",
                   "attpc_engine_tpu_torch/csrc/deposit.cu",
                   "attpc_engine_tpu/detector/deposit_pallas.py:111",
                   "pad_lookup"),
}


# per-route launch counters beside a kernel's total
ROUTES = {"sort_rows": {"cluster": "launches_cluster",
                        "wide": "launches_wide"}}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(n_bytes: float, f32_ops: float = 0.0) -> dict:
    """The least time the card could take: the bytes the function must
    move over the memory rate, or its f32 operations over the f32 rate,
    whichever is larger. Integer compares, gathers and index arithmetic
    have no rate in the card's table and are not counted."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * f32_ops / F32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _wrapper(name: str):
    import importlib

    return importlib.import_module(
        f"attpc_engine_tpu_torch.detector.{KERNELS[name][0]}")


def reset_counts() -> None:
    for name, (_, counter, *_rest) in KERNELS.items():
        setattr(_wrapper(name), counter, 0)
        for route_counter in ROUTES.get(name, {}).values():
            setattr(_wrapper(name), route_counter, 0)


def read_counts() -> dict:
    return {name: getattr(_wrapper(name), counter)
            for name, (_, counter, *_rest) in KERNELS.items()}


def read_routes() -> dict:
    """Launches of each route of the kernels that have routes."""
    return {name: {r: getattr(_wrapper(name), c) for r, c in routes.items()}
            for name, routes in ROUTES.items()}


def flagship_config():
    """The flagship detector: D2 at 300 Torr, the default AT-TPC."""
    from attpc_engine_tpu_torch import nuclear_map
    from attpc_engine_tpu_torch.detector import (
        Config,
        DetectorParams,
        ElectronicsParams,
        PadParams,
    )
    from attpc_engine_tpu_torch.nuclear import GasTarget

    gas = GasTarget([(1, 2, 2)], 300.0, nuclear_map)
    return Config(
        DetectorParams(length=1.0, efield=45000.0, bfield=2.85,
                       mpgd_gain=175000, gas_target=gas, diffusion=0.277,
                       fano_factor=0.2, w_value=34.0),
        ElectronicsParams(clock_freq=6.25, amp_gain=900, shaping_time=1000,
                          micromegas_edge=10, windows_edge=560,
                          adc_threshold=40),
        PadParams(),
    )


def flagship_simulator(device, **engine):
    from attpc_engine_tpu_torch.detector import (
        DetectorSimulator,
        EngineParams,
    )

    data = np.load(REPO / "attpc_engine_tpu_torch" / "data"
                   / "smoke_kinematics.npz")
    sim = DetectorSimulator(flagship_config(), data["proton_numbers"],
                            data["mass_numbers"],
                            engine=EngineParams(events_per_batch=BATCH,
                                                **engine),
                            device=device)
    return sim, data["vertices"], data["momenta"]


def transport_inputs(sim, vertices, momenta) -> dict:
    """K1's inputs for one window of the flagship batch: 768 tracks, the
    initial state, the per-track constants and a ``run(fn)`` that fills
    fresh [T, B] outputs from a copy of the state with ``fn`` (the kernel's
    wrapper or the plain version)."""
    from attpc_engine_tpu_torch.detector import transport as T

    e, k = len(vertices), sim.k_tracks
    steps = sim.engine.chunk_steps
    dp = sim.config.det_params
    p3 = momenta[:, sim.sim_indices, :3]
    gv0 = torch.from_numpy(
        (p3 / sim.track_masses[None, :, None]).astype(np.float32)
        .reshape(-1, 3)).cuda()
    pos0 = torch.from_numpy(np.repeat(vertices.astype(np.float32), k,
                                      axis=0)).cuda()
    s_idx = torch.arange(k, dtype=torch.int32).repeat(e).cuda()
    mass, q_m = T.track_constants(sim.species, s_idx)
    kc = T.Rk4Constants.make(sim.species, float(dp.gas_target.density),
                             float(dp.bfield), float(dp.efield),
                             float(sim.engine.dt))
    alive0 = T.initial_alive(pos0, gv0, mass)
    b = e * k

    def run(fn, n_steps=steps):
        pos, gv, alive = pos0.clone(), gv0.clone(), alive0.clone()
        out = (torch.empty((n_steps, b, 3), device="cuda"),
               torch.empty((n_steps, b), device="cuda"),
               torch.empty((n_steps, b), dtype=torch.bool, device="cuda"))
        fn(pos, gv, alive, s_idx, mass, q_m, sim.species.dedx, *out, kc)
        return out

    return {"run": run, "steps": steps, "b": b, "alive0": alive0,
            "args": (s_idx, mass, q_m, sim.species.dedx, kc)}


def steps_run(alive0: torch.Tensor, out_alive: torch.Tensor) -> torch.Tensor:
    """Steps each track computed in the window: step t runs where the
    track was alive before it (alive0 for t = 0, out_alive[t - 1] after)."""
    return alive0.int() + out_alive[:-1].int().sum(dim=0)


def sm_clock_mhz() -> tuple[int, int]:
    """(current, maximum) SM clock in MHz, as nvidia-smi reports them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    now, top = (int(v) for v in line.split(","))
    return now, top


def check_transport(sim, vertices, momenta, card: str) -> dict:
    """K1 against rk4_window_plain: 768 tracks, one 500-step window. Its
    bound beside the contract's bytes-or-operations one is the latency
    bound: the critical path of one live step, taken here from the SASS of
    this checkout's transport.cu at latencies the probe measures on this
    card (tools/k1_critical_path.py), times the steps the longest-lived
    track runs, at the card's highest SM clock."""
    sys.path.insert(0, str(REPO / "tools"))
    import k1_critical_path

    from attpc_engine_tpu_torch.detector import transport as T
    from attpc_engine_tpu_torch.detector import transport_cuda

    ti = transport_inputs(sim, vertices, momenta)
    run, steps, b = ti["run"], ti["steps"], ti["b"]
    got = run(transport_cuda.rk4_window_cuda)
    ref = run(T.rk4_window_plain)
    torch.cuda.synchronize()
    live = ref[2]
    if not torch.equal(got[2], live):
        n = int((got[2] != live).sum())
        raise AssertionError(f"K1: {n} alive flags differ from the plain version")
    dpos = float((got[0] - ref[0]).abs()[live].max())
    ddke = float((got[1] - ref[1]).abs()[live].max())
    if not (dpos < 1e-6 and ddke < 1e-4):
        raise AssertionError(f"K1: |dpos| {dpos} m, |ddke| {ddke} MeV")

    def ieee(*args):
        transport_cuda.rk4_window_cuda(*args, force_ieee=True)

    if not all(torch.equal(a, c) for a, c in zip(got, run(ieee))):
        raise AssertionError("K1 differs from its run through the compiler's"
                             " IEEE operators")
    ms = cuda_ms(lambda: run(transport_cuda.rk4_window_cuda), 10)
    ieee_ms = cuda_ms(lambda: run(ieee), 10)
    plain_ms = cuda_ms(lambda: run(T.rk4_window_plain), 1)
    # outputs [T, B] positions, |dKE| and flags, the carried state read and
    # written, the per-track constants and the dE/dx table read
    n_bytes = (steps * b * (12 + 4 + 1) + 2 * b * (12 + 12 + 1)
               + b * (4 + 4 + 4) + sim.species.dedx.numel() * 4)
    live_steps = int(live.sum())
    bnd = bound(n_bytes, K1_FLOPS_PER_STEP * live_steps)
    longest = int(steps_run(ti["alive0"], live).max())
    clock_now, clock_max = sm_clock_mhz()
    path = k1_critical_path.fast_step()
    step_cycles = path["cycles"]
    latency_ms = step_cycles * longest / (clock_max * 1e3)
    print(f"K1 transport: B={b} T={steps}: alive exact, max |dpos| {dpos:.3g} m,"
          f" max |ddke| {ddke:.3g} MeV, bit-identical to force_ieee; kernel "
          f"{ms:.3f} ms, force_ieee {ieee_ms:.3f} ms, plain {plain_ms:.1f} ms;"
          f" latency bound {latency_ms:.4f} ms ({step_cycles:.1f} cycles a "
          f"step, a critical path of {len(path['chain'])} of the step's "
          f"{path['instructions']} instructions, x {longest} steps of the longest-lived track at "
          f"{clock_max} MHz; SM clock now {clock_now} MHz), share "
          f"{latency_ms / ms:.3f}; throughput bound {bnd['bound_ms']:.4f} ms "
          f"({bnd['bound_by']}; {live_steps} live track-steps) [{card}]")
    return {"max_abs_err": dpos, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": None, "max_abs_err_dke": ddke,
            "force_ieee_ms": ieee_ms,
            "latency_bound_ms": latency_ms, "step_cycles": step_cycles,
            "longest_track_steps": longest, "sm_clock_max_mhz": clock_max,
            "sm_clock_mhz": clock_now}


def lookup_inputs(sim):
    """Random mesh cells at P = 384 * 1024 points, 10 % of each axis
    aliased onto the table's sentinel padding as deposit_and_merge does, and
    some beyond the table (clipped)."""
    p = BATCH * sim.engine.point_budget
    g = torch.Generator(device="cuda").manual_seed(SEED)
    ix = torch.randint(-3, 563, (p, 10), generator=g, device="cuda",
                       dtype=torch.int32)
    iy = torch.randint(-3, 643, (p, 10), generator=g, device="cuda",
                       dtype=torch.int32)
    ix[torch.rand((p, 10), generator=g, device="cuda") < 0.1] = 559
    iy[torch.rand((p, 10), generator=g, device="cuda") < 0.1] = 639
    tbr = torch.randint(0, 512 << 1, (p,), generator=g, device="cuda",
                        dtype=torch.int32)
    return ix, iy, tbr


def lookup_bytes(p: int, with_tbr: bool) -> int:
    """ix and iy read, tbr read, the int32 table read, the [P, 10, 10]
    int32 output written."""
    return p * 10 * 4 * 2 + (p * 4 if with_tbr else 0) + 560 * 640 * 4 + (
        p * 100 * 4)


def rows_bytes(e: int, pb: int) -> int:
    """The deposit rows' inputs read once (px, py, ptbf, pne, tbr: 4 B,
    taken: 1 B a point), the int32 table, the [E, pb * 100] int64 rows
    written."""
    return e * pb * (5 * 4 + 1) + 560 * 640 * 4 + e * pb * 100 * 8


def flagship_rows_args(sim, vertices, momenta) -> tuple:
    """The arguments the first default batch hands the deposit-rows
    kernel: the flagship's own compacted points."""
    from attpc_engine_tpu_torch.detector import deposition

    seen = []
    real = deposition.deposit_rows

    def spy(*args):
        if not seen:
            seen.append(tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args))
        return real(*args)

    deposition.deposit_rows = spy
    try:
        sim.simulate_batch(vertices[:BATCH], momenta[:BATCH], seed=SEED,
                           assemble=False)
    finally:
        deposition.deposit_rows = real
    return seen[0]


def synthetic_rows_args(sim, like: tuple) -> tuple:
    """Points [384, 1024] with every edge case of the deposit rows mixed
    in: sigma == 0 (tb_f 0), empty slots with junk values (zero or negative
    electrons among them), points beyond the pad plane, tb_f in (-1, 0);
    the other arguments as in ``like``."""
    rng = np.random.default_rng(SEED)
    shape = (BATCH, sim.engine.point_budget)
    px = rng.normal(0.0, 0.12, shape)
    py = rng.normal(0.02, 0.12, shape)
    ptbf = rng.uniform(0.0, 511.9, shape)
    pne = rng.integers(1, 4000, shape).astype(np.float64)
    taken = rng.random(shape) < 0.85
    case = rng.integers(0, 4, shape)
    ptbf[case == 0] = 0.0
    pne[~taken] = rng.integers(-50, 2, int((~taken).sum()))
    px[case == 2] = rng.uniform(0.27, 0.4, int((case == 2).sum()))
    ptbf[case == 3] = rng.uniform(-0.999, -1e-6, int((case == 3).sum()))
    ptbf = ptbf.astype(np.float32)
    tbr = (ptbf.astype(np.int32) << 1) | rng.integers(0, 2, shape).astype(
        np.int32)
    pts = [px.astype(np.float32), py.astype(np.float32), ptbf,
           pne.astype(np.float32), tbr, taken]
    return (*(torch.from_numpy(a).cuda() for a in pts), *like[6:])


def aten_scalar_division(efield: float) -> dict:
    """How ATen's CUDA ``x / efield`` (a CPU scalar) rounds, on 2^20 f32
    values: against ``x * f32(1 / f32(efield))`` and against IEEE
    division (a double quotient of f32 operands rounded to f32)."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.rand(1 << 20, generator=g, device="cuda") * 512.0
    got = x / efield
    inv = float(np.float32(1.0) / np.float32(efield))
    ieee = (x.double() / float(np.float32(efield))).float()
    return {"n": x.numel(),
            "equal_to_reciprocal_product": int((got == x * inv).sum()),
            "equal_to_ieee_division": int((got == ieee).sum())}


def check_deposit_rows(args: tuple, label: str, card: str) -> dict:
    """The deposit-rows kernel against deposit_rows_plain on the card, bit
    for bit; timed beside the plain version and the rows as the default
    step built them before the kernel (the plain version with K2 as its
    lookup)."""
    from attpc_engine_tpu_torch.detector import deposit_cuda, deposition

    got = deposition.deposit_rows(*args)
    ref = deposition.deposit_rows_plain(*args)
    n_bad = int((got != ref).sum())
    if n_bad:
        raise AssertionError(f"deposit rows, {label}: {n_bad} of "
                             f"{ref.numel()} rows differ from the plain "
                             f"version")
    keys = got >> 32
    n_key = int((keys != 2**31 - 1).sum())
    del got, ref, keys
    ms = cuda_ms(lambda: deposition.deposit_rows(*args), 20)
    plain_ms = cuda_ms(lambda: deposition.deposit_rows_plain(*args), 3)
    before_ms = cuda_ms(lambda: deposition.deposit_rows_plain(
        *args, lookup=deposit_cuda.packed_key_lookup_cuda), 5)
    e, pb = args[0].shape
    bnd = bound(rows_bytes(e, pb))
    print(f"deposit rows, {label}: [{e}, {pb * 100}] int64, {n_key} real "
          f"keys: bit-exact against the plain version; kernel {ms:.3f} ms, "
          f"as before the kernel (PyTorch passes around K2) {before_ms:.3f} "
          f"ms, plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms "
          f"[{card}]")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": None, "before_ms": before_ms}


def check_lookup(name: str, counter: str, kernel, plain, points: tuple,
                 rest: tuple, label: str) -> None:
    """``kernel(*points, *rest)`` (K2's or K7's launch) against ``plain``,
    and the same with the per-point tensors ``points`` less their last
    point (393,215 points leave the last block ragged): bit for bit,
    one launch a call."""
    from attpc_engine_tpu_torch.detector import deposit_cuda

    for pts in (points, tuple(x[:-1] for x in points)):
        a = (*pts, *rest)
        before = getattr(deposit_cuda, counter)
        got = kernel(*a)
        if getattr(deposit_cuda, counter) != before + 1:
            raise AssertionError(f"{name}: {counter} did not count the launch")
        ref = plain(*a)
        n_bad = int((got != ref).sum())
        if n_bad:
            raise AssertionError(f"{name}, {label}, P = {a[0].shape[0]}: "
                                 f"{n_bad} of {ref.numel()} outputs differ")


def check_deposit(sim, inputs, label: str, card: str) -> dict:
    """K2 against packed_key_lookup_plain on ``inputs`` (ix, iy, tbr) and
    on one point fewer."""
    from attpc_engine_tpu_torch.detector import deposit_cuda

    ix, iy, tbr = inputs
    args = (ix, iy, tbr, sim.pad_table, 1, 2**31 - 1)
    check_lookup("K2", "launches", deposit_cuda.packed_key_lookup_cuda,
                 deposit_cuda.packed_key_lookup_plain, inputs, args[3:],
                 label)
    ms = cuda_ms(lambda: deposit_cuda.packed_key_lookup_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: deposit_cuda.packed_key_lookup_plain(*args), 5)
    bnd = bound(lookup_bytes(ix.shape[0], True))
    print(f"K2 pad lookup, {label}: P={ix.shape[0]} and {ix.shape[0] - 1} "
          f"({ix.shape[0] * 100} keys): bit-exact; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms, share "
          f"{bnd['bound_ms'] / ms:.3f} [{card}]")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": None}


def flagship_lookup_inputs(sim_fused, vertices, momenta):
    """The (ix, iy, tbr) that the first fused batch hands K6: the
    flagship's own mesh cells, whose neighbouring pixels share cells."""
    from attpc_engine_tpu_torch.detector import deposition

    seen = []
    real = deposition.packed_key_lookup_rows

    def spy(ix, iy, tbr, *rest):
        if not seen:
            seen.append((ix.clone(), iy.clone(), tbr.clone()))
        return real(ix, iy, tbr, *rest)

    deposition.packed_key_lookup_rows = spy
    try:
        sim_fused.simulate_batch(vertices[:BATCH], momenta[:BATCH], seed=SEED,
                                 assemble=False)
    finally:
        deposition.packed_key_lookup_rows = real
    return seen[0]


def check_rows_lookup(sim, inputs, label: str, card: str) -> dict:
    """K6 against its plain version and against K2, same inputs; also at
    one point fewer, so that P * 10 is not a multiple of 32 and the last
    warp's run of keys is shorter than 320."""
    from attpc_engine_tpu_torch.detector import deposit_cuda

    ix, iy, tbr = inputs
    args = (ix, iy, tbr, sim.pad_table, 1, 2**31 - 1)
    ragged = (ix[:-1], iy[:-1], tbr[:-1], *args[3:])
    if (ragged[0].shape[0] * 10) % 32 == 0:
        raise AssertionError("K6: the ragged point count is not ragged")
    for a in (args, ragged):
        got = deposit_cuda.packed_key_lookup_rows_cuda(*a)
        ref = deposit_cuda.packed_key_lookup_plain(*a)
        n_bad = int((got != ref).sum())
        n_bad_k2 = int((got != deposit_cuda.packed_key_lookup_cuda(*a)).sum())
        if n_bad or n_bad_k2:
            raise AssertionError(f"K6, {label}, P = {a[0].shape[0]}: {n_bad} "
                                 f"keys differ from the plain version, "
                                 f"{n_bad_k2} from K2")
    ms = cuda_ms(lambda: deposit_cuda.packed_key_lookup_rows_cuda(*args), 20)
    k2_ms = cuda_ms(lambda: deposit_cuda.packed_key_lookup_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: deposit_cuda.packed_key_lookup_plain(*args), 5)
    bnd = bound(lookup_bytes(ix.shape[0], True))
    print(f"K6 one-stage lookup, {label}: P={ix.shape[0]} and "
          f"{ix.shape[0] - 1}: "
          f"bit-exact against the plain version and K2; kernel {ms:.3f} ms "
          f"(K2 in the same run "
          f"{k2_ms:.3f} ms), plain {plain_ms:.3f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms [{card}]")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": None, "k2_ms_same_run": k2_ms}


def check_pad_lookup(sim, inputs, label: str, card: str) -> dict:
    """K7 against its plain version; the library call is the one indexing
    gather of the plain version on indices already clipped and widened."""
    from attpc_engine_tpu_torch.detector import deposit_cuda

    ix, iy, _ = inputs
    table = sim.pad_table
    check_lookup("K7", "launches_pad_lookup", deposit_cuda.pad_lookup_cuda,
                 deposit_cuda.pad_lookup_plain, (ix, iy), (table,), label)
    ms = cuda_ms(lambda: deposit_cuda.pad_lookup_cuda(ix, iy, table), 20)
    plain_ms = cuda_ms(lambda: deposit_cuda.pad_lookup_plain(ix, iy, table), 5)
    ixc = ix.clamp(0, 559).long()[:, :, None]
    iyc = iy.clamp(0, 639).long()[:, None, :]
    library_ms = cuda_ms(lambda: table[ixc, iyc], 20)
    bnd = bound(lookup_bytes(ix.shape[0], False))
    print(f"K7 pad ids, {label}: P={ix.shape[0]} and {ix.shape[0] - 1}: "
          f"bit-exact; kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, library (one indexing gather) "
          f"{library_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms, share "
          f"{bnd['bound_ms'] / ms:.3f} [{card}]")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": library_ms}


def sort_inputs(width: int, convert: bool) -> torch.Tensor:
    """[384, width] int64 rows like the convert sort's (signed keys,
    dropped rows INT64_MAX) or the merge sorts' (pack64 of keys with long
    equal runs and sentinel lanes)."""
    from attpc_engine_tpu_torch.detector import sort_cuda

    g = torch.Generator(device="cuda").manual_seed(SEED + width)
    shape = (BATCH, width)
    if convert:
        # keep bit, 511 - tb, pad, label, f32 charge bits; dropped rows max
        x = torch.randint(0, 2**62, shape, generator=g, device="cuda")
        keep = torch.rand(shape, generator=g, device="cuda") < 0.5
        return torch.where(keep, x | (-2**63), 2**63 - 1)
    key = torch.randint(0, 6000, shape, generator=g, device="cuda") << 1
    dead = torch.rand(shape, generator=g, device="cuda") < 0.4
    key = torch.where(dead, 2**31 - 1, key)
    q = torch.rand(shape, generator=g, device="cuda") * 100
    q = torch.where(dead, 0.0, q)
    return sort_cuda.pack64(key, q)


def flagship_sort_rows(sim, vertices, momenta) -> torch.Tensor:
    """The rows the first default batch hands its first merge sort: the
    flagship's own pack64(key, charge) elements."""
    from attpc_engine_tpu_torch.detector import deposition

    seen = []
    real = deposition.sort_rows

    def spy(x):
        if not seen:
            seen.append(x.clone())
        return real(x)

    deposition.sort_rows = spy
    try:
        sim.simulate_batch(vertices[:BATCH], momenta[:BATCH], seed=SEED,
                           assemble=False)
    finally:
        deposition.sort_rows = real
    return seen[0]


def check_sort(x: torch.Tensor, label: str, route: tuple, card: str) -> dict:
    """K3 against torch.sort (also the library call) on rows ``x``: bit-
    exact, on the expected (route, n_cta) (n_cta None: any), and with no
    allocation but the output (the wide route: the output, one scratch
    like ``x`` and its split table). The plan is ``sort_cuda.route``'s."""
    from attpc_engine_tpu_torch.detector import sort_cuda

    r = sort_cuda.route(x.shape[1])
    if r.name != route[0] or route[1] not in (None, r.n_cta):
        raise AssertionError(f"K3 {label}: route {r}, expected {route}")
    wide = r.name == "wide"
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = sort_cuda.sort_rows_cuda(x)
    extra = torch.cuda.max_memory_allocated() - before
    # the allocator may hand out up to 1 MiB more than it was asked for;
    # the wide route's split table is < 1 MiB at these shapes
    if extra > (2 if wide else 1) * x.numel() * 8 + (1 << 20):
        raise AssertionError(f"K3 {label}: allocated {extra} B, the output "
                             f"is {x.numel() * 8} B")
    ref = sort_cuda.sort_rows_plain(x)
    n_bad = int((got != ref).sum())
    if n_bad:
        raise AssertionError(f"K3 {label} {list(x.shape)}: {n_bad} elements "
                             f"differ")
    del got, ref
    reps = 10 if x.shape[1] <= 2**18 else 3
    ms = cuda_ms(lambda: sort_cuda.sort_rows_cuda(x), reps)
    plain_ms = cuda_ms(lambda: sort_cuda.sort_rows_plain(x), reps)
    bnd = bound(2 * x.numel() * 8)
    floor_ms = (1 + r.passes) * bnd["bound_ms"]
    plan = (f"{r.chunks} chunks of {r.chunk_w}, each {r.n_cta} CTAs of "
            f"{r.chunk}, then {r.passes} merge passes" if wide
            else f"{r.n_cta} CTAs of {r.chunk}")
    print(f"K3 row sort, {label} {list(x.shape)}: bit-exact; route {r.name}"
          f" ({plan}), {extra} B allocated; kernel {ms:.3f} ms, plain "
          f"(torch.sort, the library call) {plain_ms:.3f} ms, ratio "
          f"{ms / plain_ms:.3f}, bound {bnd['bound_ms']:.4f} ms"
          f"{f', design floor {floor_ms:.4f} ms' if wide else ''} [{card}]")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": plain_ms, "k3_route": r.name, "n_cta": r.n_cta,
            "chunks": r.chunks, "chunk_w": r.chunk_w, "passes": r.passes,
            "floor_ms": floor_ms, "allocated_bytes": extra,
            "width": x.shape[1]}


def flagship_merge_inputs(sim_fused, vertices, momenta):
    """The (packed, qv, cap, rank_bits) that the first fused batch hands K5:
    the flagship's own merge keys."""
    from attpc_engine_tpu_torch.detector import deposition

    seen = {}
    real = deposition.merge_runs_fused

    def spy(packed, qv, cap, rank_bits):
        seen["args"] = (packed.clone(), qv.clone(), cap, rank_bits)
        return real(packed, qv, cap, rank_bits)

    deposition.merge_runs_fused = spy
    try:
        sim_fused.simulate_batch(vertices[:BATCH], momenta[:BATCH], seed=SEED,
                                 assemble=False)
    finally:
        deposition.merge_runs_fused = real
    return seen["args"]


def synthetic_merge_inputs(width: int, cap: int, rank_bits: int):
    """Keys with runs of every length, four deposition ranks, 30 % dead
    lanes, charges like the flagship's pixels."""
    g = torch.Generator(device="cuda").manual_seed(SEED + rank_bits)
    shape = (BATCH, width)
    space = torch.randint(0, 2 * cap, shape, generator=g, device="cuda",
                          dtype=torch.int32)
    rank = torch.randint(0, 1 << rank_bits, shape, generator=g,
                         device="cuda", dtype=torch.int32)
    packed = (space << rank_bits) | rank
    qv = torch.rand(shape, generator=g, device="cuda") * 300
    dead = torch.rand(shape, generator=g, device="cuda") < 0.3
    packed = torch.where(dead, 2**31 - 1, packed)
    qv = torch.where(dead, 0.0, qv)
    return packed, qv, cap, rank_bits


def edge_merge_inputs(width: int, cap: int, rank_bits: int = 1):
    """Synthetic merge rows (``synthetic_merge_inputs``) with a row of
    sentinels only (row 0), a row with no sentinel (row 1) and a row with
    one live lane (row 2)."""
    packed, qv, cap, rank_bits = synthetic_merge_inputs(width, cap, rank_bits)
    packed[0], qv[0] = 2**31 - 1, 0.0
    packed[1] = torch.where(packed[1] == 2**31 - 1, 5 << rank_bits, packed[1])
    qv[1] = torch.where(qv[1] == 0.0, 1.5, qv[1])
    packed[2], qv[2] = 2**31 - 1, 0.0
    packed[2, width // 3], qv[2, width // 3] = 7 << rank_bits, 2.5
    return packed, qv, cap, rank_bits


def merge_bound(e: int, w: int, cap: int) -> dict:
    """K5's bound: packed and qv read, key2, c2 and n_uniq written; the
    prefix's f32 additions: 7 lane steps and the segment offset per lane, a
    Hillis-Steele step per segment and distance."""
    n_seg = -(-w // 128)
    n_bytes = e * w * 8 + e * cap * 8 + e * 4
    f32_ops = e * (w * 8 + n_seg * max(1, (n_seg - 1).bit_length()))
    return bound(n_bytes, f32_ops)


def check_merge(args, label: str, expect: tuple, card: str) -> dict:
    """K5 against its plain version (torch.sort then the plain tail) on the
    route ``merge_cuda.route`` gives the width, which must be ``expect``
    (name, n_cta): key2 and n_uniq exact, c2 bit-exact; the route's own
    counter counts the launch; the cluster route allocates nothing but its
    outputs (no [E, W] int64 rows). Timed beside the two-launch route
    (pack64, K3, the tail kernel) on the same rows and the plain version."""
    from attpc_engine_tpu_torch.detector import merge_cuda

    packed, qv, cap, rank_bits = args
    e, w = packed.shape
    r = merge_cuda.route(w)
    if (r.name, r.n_cta) != expect:
        raise AssertionError(f"K5 {label}: route {r}, expected {expect}")
    counter = ("launches_cluster" if r.name == "cluster"
               else "launches_two_launch")
    before = getattr(merge_cuda, counter)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = merge_cuda.merge_runs_fused_cuda(*args)
    extra = torch.cuda.max_memory_allocated() - allocated
    if getattr(merge_cuda, counter) != before + 1:
        raise AssertionError(f"K5 {label}: {counter} did not count the "
                             f"launch")
    c = min(cap, w)
    outputs = e * c * 8 + e * 4
    if r.name == "cluster" and extra > outputs + (1 << 20):
        raise AssertionError(f"K5 {label}: allocated {extra} B, the outputs "
                             f"are {outputs} B")
    ref = merge_cuda.merge_runs_fused_plain(*args)
    bad = [int((a.view(torch.int32) != b.view(torch.int32)).sum())
           for a, b in zip(got, ref)]
    if any(bad):
        raise AssertionError(f"K5 {label}: key2, c2, n_uniq differ in "
                             f"{bad} places")
    if int(ref[2].max()) <= 0:
        raise AssertionError(f"K5 {label}: no runs at all")
    del got
    live = float((packed != 2**31 - 1).float().mean())
    ms = cuda_ms(lambda: merge_cuda.merge_runs_fused_cuda(*args), 10)
    two_ms = cuda_ms(lambda: merge_cuda.merge_runs_two_launch(*args), 10)
    plain_ms = cuda_ms(lambda: merge_cuda.merge_runs_fused_plain(*args), 3)
    bnd = merge_bound(e, w, c)
    print(f"K5 fused merge, {label} [{e}, {w}] cap {cap} rank_bits "
          f"{rank_bits}: route {r.name} ({r.n_cta} CTAs of {r.chunk}), "
          f"{extra} B allocated; key2 and n_uniq exact, c2 bit-exact (n_uniq "
          f"{int(ref[2].min())}-{int(ref[2].max())}, live share {live:.4f}); "
          f"kernel {ms:.3f} ms, two-launch route {two_ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms [{card}]")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, **bnd,
            "library_ms": None, "two_launch_ms": two_ms, "live_share": live,
            "k5_route": r.name, "n_cta": r.n_cta, "chunk": r.chunk,
            "width": w, "cap": c, "allocated_bytes": extra}


def check_rows(sim, out, n_events: int) -> int:
    """Well-formed packed rows; returns their count."""
    from attpc_engine_tpu_torch.detector.simulator import split_packed

    counts = out["spyral_counts"].cpu().numpy()
    total = int(counts.sum())
    packed = out["packed"][:total].cpu().numpy()
    q, tb, pad, lab = split_packed(packed)
    ok = (
        counts.shape == (n_events,)
        and total > 0
        and np.isfinite(q).all() and (q > 0).all()
        and ((tb >= 0) & (tb < 512)).all()
        and ((pad >= 0) & (pad < 10240)).all()
        and np.isin(lab, sim.sim_indices).all()
    )
    if not ok:
        raise AssertionError("malformed packed rows")
    return total


CLOUD_INTEGERS = ("pads", "tbs_i", "labels", "events", "cloud_valid",
                  "counts", "n_points", "uniq_overflow", "pool_overflow",
                  "uniq_max")
RETRY_POINT_BUDGET = 4096  # run_simulation's second doubling of 1,024
# a point budget whose fused merge rows (250,000 lanes) are wider than K5's
# cluster route takes and within fits_fused's 2^18
FUSED_WIDE_POINT_BUDGET = 2500


def main_path(sim, vertices, momenta, label: str, must_launch, must_not,
              card: str, wide_per_batch: int = 0,
              per_batch: dict | None = None, keep_rows: bool = False) -> dict:
    """The batches of ``vertices`` through simulate_batch + host assembly,
    launch counts set to 0 just before and read just after; the device
    step of every batch but the first is timed (dispatch until the
    metadata reached the host). K3 must take its wide route
    ``wide_per_batch`` times a batch (0 at the flagship's widths) and its
    cluster route at least once; each kernel named in ``per_batch`` must
    have been launched exactly that many times a batch. Returns the counts,
    the timing and the first batch's merged cloud, meta_i32 and packed
    rows; with ``keep_rows``, also every batch's (packed rows, counts)."""
    from attpc_engine_tpu_torch.detector.simulator import overflow_kinds

    step_s, asm_s, rows, first, kept = [], [], 0, None, []
    reset_counts()
    for start in range(0, len(vertices), BATCH):
        v, m = vertices[start:start + BATCH], momenta[start:start + BATCH]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sim.simulate_batch(v, m, seed=SEED, event_start=start,
                                 assemble=False)
        meta = out["meta_i32"].cpu().numpy()
        t1 = time.perf_counter()
        kinds = overflow_kinds(meta)
        if kinds:
            raise AssertionError(f"{label}: overflow at its budgets: "
                                 f"{kinds}")
        counts = meta[:len(v)]
        total = check_rows(sim, out, len(v))
        spyral, labels = sim.assemble_spyral_ordered(
            out["packed"][:total].cpu().numpy(), counts,
            np.arange(start, start + len(v)), SEED)
        t2 = time.perf_counter()
        if spyral.shape != (total, 8) or not np.isfinite(spyral).all():
            raise AssertionError("malformed Spyral rows")
        if first is None:
            first = {k: out[k] for k in CLOUD_INTEGERS + ("charges",)}
            first.update(meta_i32=meta, packed=out["packed"][:total].cpu())
        if keep_rows:
            kept.append((out["packed"][:total].cpu().numpy(), counts))
        step_s.append(t1 - t0)
        asm_s.append(t2 - t1)
        rows += total
    launches = read_counts()
    routes = read_routes()
    missing = [k for k in must_launch if launches[k] == 0]
    extra = [k for k in must_not if launches[k] != 0]
    if missing or extra:
        raise AssertionError(f"{label}: kernels of the path never launched "
                             f"{missing}, kernels off the path launched "
                             f"{extra}: {launches}")
    k3 = routes["sort_rows"]
    if k3["cluster"] == 0 or k3["wide"] != wide_per_batch * len(step_s):
        raise AssertionError(f"{label}: K3 by route {k3}, expected the "
                             f"wide route {wide_per_batch} times a batch")
    off = {k: launches[k] for k, n in (per_batch or {}).items()
           if launches[k] != n * len(step_s)}
    if off:
        raise AssertionError(f"{label}: launches {off} over {len(step_s)} "
                             f"batches, expected {per_batch} a batch")
    timed = step_s[1:]  # the first batch is warm-up
    ms = 1e3 * float(np.mean(timed))
    print(f"{label} path: {len(step_s)} batches of {BATCH} events, {rows} rows;"
          f" device step {[round(1e3 * s, 3) for s in step_s]} ms "
          f"(first excluded: mean {ms:.3f} ms/batch, "
          f"{BATCH / np.mean(timed):.1f} events/s); host assembly "
          f"{1e3 * float(np.mean(asm_s[1:])):.3f} ms/batch; launches {launches}"
          f", K3 by route {k3} [{card}]")
    return {"launches": launches, "routes": routes, "ms_per_batch": ms,
            "events_per_s": BATCH / float(np.mean(timed)), "first": first,
            "batches": kept}


def compare_first(label: str, against: str, ref_first: dict,
                  first: dict) -> None:
    """A path's first batch against another path's (``against``):
    meta_i32 and the packed rows bit for bit. A wider point budget's padding
    lanes sort last and add nothing (in the fused merge, a step of the
    segment scan that the wider row adds adds 0.0 to every live segment);
    K2 and K6 give the same keys."""
    if not (np.array_equal(first["meta_i32"], ref_first["meta_i32"])
            and torch.equal(first["packed"], ref_first["packed"])):
        raise AssertionError(f"{label}: meta_i32 or packed rows differ from "
                             f"the {against} batch")
    print(f"{label} vs {against}, first batch: meta_i32 and "
          f"{len(first['packed'])} packed rows bit-identical")


def compare_clouds(default: dict, fused: dict, gain: float) -> None:
    """The fused configuration's first batch against the default one's:
    every integer exact, charges within rtol 1e-5 with a one-electron floor
    (tests/test_sort_pallas.py:221-230)."""
    for k in CLOUD_INTEGERS:
        if not torch.equal(default[k], fused[k]):
            raise AssertionError(f"fused vs default: {k} differs")
    qd, qf = default["charges"] / gain, fused["charges"] / gain
    excess = float(((qf - qd).abs() - (1.0 + 1e-5 * qd.abs())).max())
    same = float((default["charges"] == fused["charges"]).float().mean())
    print(f"fused vs default, first batch: integers exact; charges within "
          f"rtol 1e-5 + 1 electron (max excess {excess:.3g} electrons; "
          f"{100 * same:.2f} % of rows bit-identical)")
    if excess > 0:
        raise AssertionError("fused vs default: charges out of bound")


def entry_point_path(name: str, call, card: str) -> dict:
    """A lookup entry point as a user calls it (``call()`` returns its
    [P, 10, 10] output), counts set to 0 just before and read just after;
    kernel ``name`` must have been launched."""
    reset_counts()
    out = call()
    torch.cuda.synchronize()
    launches = read_counts()
    if launches[name] == 0 or tuple(out.shape[1:]) != (10, 10):
        raise AssertionError(f"{name} entry point: {launches}")
    print(f"{name} entry point: {tuple(out.shape)} {out.dtype}; launches "
          f"{launches} [{card}]")
    return {"launches": launches, "routes": read_routes()}


def check_against_cpu(sim_gpu, vertices, momenta, n: int = 8) -> None:
    """``n`` events on the card against the same events through the plain
    versions on the CPU. The devices round logf differently, so transport
    positions differ in the last bits and a few pixels change mm cell: per
    event the merged and kept row counts must agree within 2 % and the
    total kept charge within 1 %."""
    sim_cpu, _, _ = flagship_simulator("cpu")
    outs = [s.simulate_batch(vertices[:n], momenta[:n], seed=SEED,
                             assemble=False) for s in (sim_gpu, sim_cpu)]
    metas = [o["meta_i32"].cpu().numpy() for o in outs]
    charges = []
    for o, meta in zip(outs, metas):
        total = int(meta[:n].sum())
        q = o["packed"][:total, 0].cpu().numpy().view(np.float32)
        charges.append(float(q.astype(np.float64).sum()))
    g, c = metas
    rel = lambda a, b: np.abs(a - b) / np.maximum(np.abs(b), 1)  # noqa: E731
    kept, merged = rel(g[:n], c[:n]), rel(g[2 * n:3 * n], c[2 * n:3 * n])
    dq = abs(charges[0] - charges[1]) / charges[1]
    print(f"card vs CPU plain, {n} events: kept rows {g[:n].tolist()} vs "
          f"{c[:n].tolist()}; merged {g[2*n:3*n].tolist()} vs "
          f"{c[2*n:3*n].tolist()}; total charge rel diff {dq:.3g}")
    if kept.max() > 0.02 or merged.max() > 0.02 or dq > 0.01:
        raise AssertionError("the card disagrees with the CPU reference")


class ArrayReader:
    """Events held in arrays as a reader for ``run_reader``: the card's
    Python has no h5py, so no HDF5 kinematics file can be read there."""

    def __init__(self, vertices, momenta, proton_numbers, mass_numbers):
        self.vertices, self.momenta = vertices, momenta
        self.proton_numbers, self.mass_numbers = proton_numbers, mass_numbers
        self.n_events = len(vertices)

    def read_range(self, start: int, stop: int):
        return self.vertices[start:stop], self.momenta[start:stop]

    def close(self) -> None:
        pass


class NpzReader(ArrayReader):
    """The committed kinematics as a reader for ``run_reader``."""

    def __init__(self):
        data = np.load(REPO / "attpc_engine_tpu_torch" / "data"
                       / "smoke_kinematics.npz")
        super().__init__(data["vertices"], data["momenta"],
                         data["proton_numbers"], data["mass_numbers"])


class MemoryWriter:
    """A ``write_spyral_pool`` writer that keeps each batch's assembled
    rows: (spyral, labels, counts, event numbers)."""

    def __init__(self):
        self.batches = []
        self.closed = False

    def write_spyral_pool(self, spyral, labels, counts, event_numbers,
                          raw_counts=None):
        self.batches.append((spyral, labels, np.asarray(counts),
                             np.asarray(event_numbers)))

    def close(self) -> None:
        self.closed = True


def drive(config, engine, stop_event=None, reader=None):
    """``run_reader`` over ``reader`` (the committed kinematics by default)
    into a MemoryWriter on the card, seed SEED, recording each dispatch's
    budgets (DetectorSimulator.simulate_batch's event_start, n_steps and
    point_budget). Returns (stats, writer, dispatches, wall seconds)."""
    from attpc_engine_tpu_torch.detector import simulator

    calls = []
    real = simulator.DetectorSimulator.simulate_batch

    def spy(self, vertices, momenta, **kw):
        calls.append({k: kw.get(k) for k in ("event_start", "n_steps",
                                             "point_budget", "uniq_budget",
                                             "out_budget")})
        return real(self, vertices, momenta, **kw)

    writer = MemoryWriter()
    simulator.DetectorSimulator.simulate_batch = spy
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = simulator.run_reader(config, reader or NpzReader(), writer,
                                     engine=engine, seed=SEED,
                                     show_progress=False, auto_tune=True,
                                     stop_event=stop_event, device="cuda")
        wall = time.perf_counter() - t0
    finally:
        simulator.DetectorSimulator.simulate_batch = real
    if not writer.closed:
        raise AssertionError("the driver did not close its writer")
    return stats, writer, calls, wall


def same_rows(label: str, got, ref) -> None:
    """Batches of assembled rows (spyral, labels, counts, events), bit for
    bit."""
    if len(got) != len(ref):
        raise AssertionError(f"{label}: {len(got)} batches against "
                             f"{len(ref)}")
    for i, (a, b) in enumerate(zip(got, ref)):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{label}: batch {i} differs")


def check_driver_run(label: str, calls: list, budgets: dict, launches: dict,
                     routes: dict) -> None:
    """An auto-tuned driver run of the default configuration: the first
    dispatch is the probe, the tuned budgets are no wider than the
    defaults, K1, the deposit-rows kernel and K3 (cluster route only) were
    launched and no kernel off that path."""
    from attpc_engine_tpu_torch.detector import EngineParams

    defaults = EngineParams()
    if calls[0]["n_steps"] != defaults.chunk_steps or calls[0][
            "event_start"] != 0:
        raise AssertionError(f"{label}: the first dispatch was {calls[0]}, "
                             f"not the {defaults.chunk_steps}-step probe")
    wider = {k: v for k, v in budgets.items()
             if v > {"steps": defaults.n_time_steps, "point":
                     defaults.point_budget, "uniq": defaults.uniq_budget,
                     "cloud": defaults.cloud_cap,
                     "out": defaults.out_budget}[k]}
    if wider:
        raise AssertionError(f"{label}: budgets wider than the defaults "
                             f"{wider}")
    check_default_launches(label, launches, routes)


def check_default_launches(label: str, launches: dict, routes: dict) -> None:
    """K1, the deposit-rows kernel and K3 (cluster route only) were
    launched, and no kernel off the default step's path (K2 among them)."""
    missing = [k for k in ("transport", "deposit_rows", "sort_rows")
               if launches[k] == 0]
    extra = [k for k in ("deposit", "merge_cluster", "merge_fused",
                         "packed_key_lookup_rows", "pad_lookup",
                         "sort_rows_wide") if launches[k] != 0]
    if missing or extra or routes["sort_rows"]["wide"]:
        raise AssertionError(f"{label}: never launched {missing}, launched "
                             f"off the path {extra}: {launches}")


def driver_path(sim, phase4: dict, card: str) -> dict:
    """Phase 4h (see the module docstring). ``phase4`` is phase 4's result
    with every batch's packed rows."""
    from attpc_engine_tpu_torch.detector import EngineParams

    ref = []
    for i, (packed, counts) in enumerate(phase4["batches"]):
        events = np.arange(i * BATCH, i * BATCH + len(counts))
        spyral, labels = sim.assemble_spyral_ordered(packed, counts, events,
                                                     SEED)
        ref.append((spyral, labels, counts, events))
    reset_counts()
    stats, writer, calls, wall = drive(
        sim.config, EngineParams(events_per_batch=BATCH))
    launches, routes = read_counts(), read_routes()
    budgets = stats["budgets"]
    print(f"driver run A: {stats['events']} events, {stats['rows']} rows in "
          f"{wall:.3f} s, {stats['events'] / wall:.1f} events/s end to end; "
          f"dispatches {calls}; tuned budgets {budgets}; launches {launches}"
          f", K3 by route {routes['sort_rows']} [{card}]")
    times = sorted(stats["phase_seconds"].items(), key=lambda kv: -kv[1])
    print("driver run A phase seconds: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times))
    check_driver_run("driver", calls, budgets, launches, routes)
    same_rows("driver run A vs phase 4's rows assembled on the host",
              writer.batches, ref)
    print(f"driver run A vs phase 4: the assembled rows of all "
          f"{len(ref)} batches bit-identical")

    stats_b, writer_b, calls_b, wall_b = drive(
        sim.config, EngineParams(events_per_batch=BATCH, point_budget=256),
        stop_event=2 * BATCH)
    first = [c for c in calls_b if c["event_start"] == 0]
    if [c["point_budget"] for c in first] != [256, 512]:
        raise AssertionError(f"driver run B: first batch dispatches {first},"
                             f" expected one retry on 'point'")
    same_rows("driver run B vs run A", writer_b.batches, writer.batches[:2])
    print(f"driver run B (point_budget 256): first batch retried once on "
          f"'point' ({first}); budgets {stats_b['budgets']}; rows "
          f"bit-identical to run A's [{card}]")
    return {"launches": launches, "routes": routes, "budgets": budgets,
            "wall_s": wall, "events_per_s": stats["events"] / wall,
            "phase_seconds": stats["phase_seconds"], "dispatches": calls,
            "run_b_dispatches": calls_b, "run_b_budgets": stats_b["budgets"]}


# run_kinematics_pipeline's default batch_size: one batch a case
KINEMATICS_EVENTS = 65536
KINEMATICS_CPU_EVENTS = 4096  # the leading events also run on the CPU
KINEMATICS_TIMED = 5  # warm runs of case A timed


def kinematics_pipeline(case: str, device):
    """Phase 4k's cases: (A) the flagship (bench.py:160-170), (B) the
    flagship through the gas of tests/test_kinematics.py:253-275, (C) the
    three-step chain of tests/test_kinematics.py:47-75, (D) 12C(d,p) at 16
    MeV with Ex uniform in [0, 30] MeV (about 0.55 of lanes accepted a
    draw)."""
    from attpc_engine_tpu_torch import nuclear_map
    from attpc_engine_tpu_torch.kinematics import (
        Decay,
        ExcitationGaussian,
        ExcitationUniform,
        KinematicsPipeline,
        KinematicsTargetMaterial,
        PolarUniform,
        Reaction,
    )
    from attpc_engine_tpu_torch.nuclear import GasTarget

    d = nuclear_map.get_data
    target = None
    if case in "AB":
        steps = [Reaction(d(1, 2), d(6, 12), d(1, 1))]
        exc = [ExcitationGaussian(0.0, 0.0)]
        beam = 120.0
        if case == "B":
            target = KinematicsTargetMaterial(
                GasTarget([(1, 2, 2)], 300.0, nuclear_map), (0.2, 0.8), 0.007)
    elif case == "C":
        steps = [Reaction(d(5, 10), d(2, 3), d(2, 4)),
                 Decay(d(5, 9), d(2, 4)), Decay(d(3, 5), d(2, 4))]
        exc = [ExcitationGaussian(16.8, 0.2), ExcitationGaussian(0.0, 1.25),
               ExcitationGaussian(0.0, 0.0)]
        beam = 24.0
    else:
        steps = [Reaction(d(6, 12), d(1, 2), d(1, 1))]
        exc = [ExcitationUniform(0.0, 30.0)]
        beam = 16.0
    return KinematicsPipeline(steps, exc,
                              [PolarUniform(0.0, np.pi) for _ in steps], beam,
                              target_material=target, device=device)


class KinematicsMemoryWriter:
    """A ``run_kinematics`` writer that keeps each batch (the card has no
    h5py for ``KinematicsWriter``)."""

    def __init__(self):
        self.batches = []
        self.closed = False

    def write_batch(self, vertices, momenta) -> None:
        self.batches.append((vertices, momenta))

    def close(self) -> None:
        self.closed = True


def sample_kinematics(pipe, seed: int = SEED):
    """One ``run_kinematics`` batch of KINEMATICS_EVENTS events on the card
    into a KinematicsMemoryWriter. Returns (vertices, momenta, stats,
    seconds: sampling plus the copy to the host)."""
    from attpc_engine_tpu_torch.kinematics import run_kinematics

    writer = KinematicsMemoryWriter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = run_kinematics(pipe, KINEMATICS_EVENTS, writer,
                           batch_size=KINEMATICS_EVENTS, seed=seed,
                           show_progress=False, device="cuda")
    wall = time.perf_counter() - t0
    if not writer.closed or len(writer.batches) != 1:
        raise AssertionError(f"run_kinematics: {len(writer.batches)} batches, "
                             f"closed {writer.closed}")
    vertices, momenta = writer.batches[0]
    return vertices, momenta, stats, wall


def kinematics_path(card: str) -> dict:
    """Phase 4k (see the module docstring). Returns the launch counts (the
    stage launches none of the port's kernels), each case's draws and
    checks, case A's rate and its events for phase 4i."""
    reset_counts()
    cases = {}
    events_a = None
    for case in "ABCD":
        pipe = kinematics_pipeline(case, "cuda")
        vertices, momenta, stats, wall = sample_kinematics(pipe)
        n_nuclei = pipe.n_nuclei
        if (vertices.shape != (KINEMATICS_EVENTS, 3)
                or momenta.shape != (KINEMATICS_EVENTS, n_nuclei, 4)
                or not (np.isfinite(vertices).all()
                        and np.isfinite(momenta).all())):
            raise AssertionError(f"4k ({case}): malformed events")
        # initial = target + projectile; final = the ejectile, each decay's
        # residual_1 and the last residual
        initial = momenta[:, 0] + momenta[:, 1]
        final = (momenta[:, 2] + momenta[:, 4:n_nuclei - 1:2].sum(axis=1)
                 + momenta[:, n_nuclei - 1])
        conservation = float(np.abs(initial - final).max())
        if conservation > 1e-8:
            raise AssertionError(f"4k ({case}): momentum not conserved, "
                                 f"{conservation} MeV")
        gpu = pipe.sample_events(KINEMATICS_EVENTS, SEED, device="cuda")
        if not (np.array_equal(gpu.momenta.cpu().numpy(), momenta)
                and np.array_equal(gpu.vertices.cpu().numpy(), vertices)
                and bool(gpu.accepted.all())):
            raise AssertionError(f"4k ({case}): sample_events differs from "
                                 f"run_kinematics")
        m = KINEMATICS_CPU_EVENTS
        cpu = pipe.sample_events(m, SEED, device="cpu")
        dp = float((gpu.momenta[:m].cpu() - cpu.momenta).abs().max())
        dv = float((gpu.vertices[:m].cpu() - cpu.vertices).abs().max())
        same_at = torch.equal(gpu.accepted_at[:m].cpu(), cpu.accepted_at)
        if not (torch.equal(gpu.accepted[:m].cpu(), cpu.accepted) and same_at
                and dp <= 1e-9 and dv <= 1e-12):
            raise AssertionError(f"4k ({case}): the card disagrees with the "
                                 f"CPU: draws equal {same_at}, |dp| {dp}, "
                                 f"|dv| {dv}")
        at = gpu.accepted_at.cpu().numpy()
        draws = int(stats["draws"][0])
        if case in "CD" and draws < 2:
            raise AssertionError(f"4k ({case}): {draws} draw, expected more")
        cases[case] = {
            "reaction": str(pipe), "draws": draws,
            "resampled_share": float((at > 0).mean()),
            "card_vs_cpu_max_abs_mev": dp, "card_vs_cpu_max_abs_m": dv,
            "momentum_conservation_max_abs_mev": conservation,
            "first_run_s": wall,
        }
        print(f"4k ({case}) {pipe}: {KINEMATICS_EVENTS} events in {draws} "
              f"draws ({100 * cases[case]['resampled_share']:.3f} % of lanes "
              f"drew again), first run {wall:.4f} s; first {m} equal to the "
              f"CPU run (draws exact, |dp| {dp:.3g} MeV, |dv| {dv:.3g} m); "
              f"momentum conserved within {conservation:.3g} MeV [{card}]")
        if case == "A":
            events_a = (vertices, momenta, pipe.get_proton_numbers(),
                        pipe.get_mass_numbers())
            times = [sample_kinematics(pipe)[3]
                     for _ in range(KINEMATICS_TIMED)]
            cases[case]["warm_s"] = times
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"4k: the kinematics stage launched kernels "
                             f"{launches}")
    rate = KINEMATICS_EVENTS / float(np.mean(cases["A"]["warm_s"]))
    print(f"4k (A) kinematics, sampling plus the copy to the host, warm: "
          f"{rate:.1f} events/s (mean of {KINEMATICS_TIMED} runs of "
          f"{KINEMATICS_EVENTS} events: "
          f"{[round(1e3 * t, 3) for t in cases['A']['warm_s']]} ms) [{card}]")
    return {"launches": launches, "routes": read_routes(), "cases": cases,
            "events_per_s": rate, "events_a": events_a}


def check_spyral_rows(sim, batches, n_events: int) -> int:
    """``check_rows``'s checks on the assembled Spyral rows of a
    MemoryWriter's batches (spyral [n, 8]: x, y, z, amplitude, integral,
    pad, tb, pad size): finite, amplitude in (0, 4095], tb in [0, 512),
    pads in [0, 10240), labels of the simulated nuclei, one count an event.
    Returns the rows' count."""
    rows = events = 0
    for spyral, labels, counts, event_numbers in batches:
        total = int(counts.sum())
        ok = (
            spyral.shape == (total, 8) and len(labels) == total
            and counts.shape == event_numbers.shape
            and np.isfinite(spyral).all()
            and ((spyral[:, 3] > 0) & (spyral[:, 3] <= 4095)).all()
            and ((spyral[:, 6] >= 0) & (spyral[:, 6] < 512)).all()
            and ((spyral[:, 5] >= 0) & (spyral[:, 5] < 10240)).all()
            and np.isin(labels, sim.sim_indices).all()
        )
        if not ok:
            raise AssertionError("malformed Spyral rows")
        rows += total
        events += len(counts)
    if events != n_events or rows == 0:
        raise AssertionError(f"{events} events, {rows} rows written")
    return rows


def kinematics_driver_path(sim, events_a, card: str) -> dict:
    """Phase 4i (see the module docstring): the first 1,536 events of 4k's
    case A through the driver loop, as phase 4h runs the committed ones."""
    from attpc_engine_tpu_torch.detector import EngineParams

    vertices, momenta, z, a = events_a
    flagship = NpzReader()
    if not (np.array_equal(z, flagship.proton_numbers)
            and np.array_equal(a, flagship.mass_numbers)):
        raise AssertionError("4i: case A's nuclei are not the flagship's")
    n = 4 * BATCH
    reader = ArrayReader(vertices[:n], momenta[:n], z, a)
    reset_counts()
    stats, writer, calls, wall = drive(
        sim.config, EngineParams(events_per_batch=BATCH), reader=reader)
    launches, routes = read_counts(), read_routes()
    budgets = stats["budgets"]
    check_driver_run("4i", calls, budgets, launches, routes)
    rows = check_spyral_rows(sim, writer.batches, n)
    print(f"4i, the two-stage chain: {stats['events']} card-sampled events, "
          f"{rows} rows in {wall:.3f} s, {stats['events'] / wall:.1f} "
          f"events/s end to end; tuned budgets {budgets}; launches "
          f"{launches}, K3 by route {routes['sort_rows']} [{card}]")
    check_against_cpu(sim, vertices[:BATCH], momenta[:BATCH])
    return {"launches": launches, "routes": routes, "budgets": budgets,
            "wall_s": wall, "events_per_s": stats["events"] / wall,
            "rows": rows, "phase_seconds": stats["phase_seconds"]}


# phase 4m: the first MULTIHOST_EVENTS of 4k's case A over
# MULTIHOST_PROCESSES processes on one card, 2,048 events each: off the
# 384-event batch grid, so each process's last batch holds 128 events
MULTIHOST_EVENTS = 6144
MULTIHOST_PROCESSES = 3
MULTIHOST_CHILD = "--multihost-child"
MULTIHOST_TIMEOUT_S = 600


def rows_of(writer) -> tuple:
    """A MemoryWriter's batches as one (spyral, labels, counts, event
    numbers), whatever the batches' sizes."""
    return tuple(np.concatenate([b[i] for b in writer.batches])
                 for i in range(4))


def multihost_child(events_path: str, out_path: str) -> int:
    """Phase 4m's child, one process of ``run_simulation_multihost``'s
    decomposition: its ids and card from ``RANK``, ``WORLD_SIZE`` and
    ``LOCAL_RANK`` (``parallel.resolve_process``), its slice from
    ``parallel.process_plan``, the slice through ``run_reader`` (the card
    has no h5py for the HDF5 reader and writers) into a MemoryWriter. Saves
    its rows, launch counts, ``kernels.build_seconds()``, and the run's
    wall start and end (``time.time()``) to ``out_path``."""
    sys.path.insert(0, str(REPO))
    from attpc_engine_tpu_torch import kernels
    from attpc_engine_tpu_torch.detector import EngineParams
    from attpc_engine_tpu_torch.detector.simulator import run_reader
    from attpc_engine_tpu_torch.parallel import process_plan, resolve_process

    pid, nproc, device = resolve_process()
    data = np.load(events_path)
    reader = ArrayReader(data["vertices"], data["momenta"],
                         data["proton_numbers"], data["mass_numbers"])
    plan = process_plan(reader.n_events, pid, nproc)
    free, total = torch.cuda.mem_get_info(device)
    writer = MemoryWriter()
    reset_counts()
    t0 = time.time()
    stats = run_reader(flagship_config(), reader, writer,
                       engine=EngineParams(events_per_batch=BATCH), seed=SEED,
                       show_progress=False, start_event=plan.start,
                       stop_event=plan.stop, auto_tune=True, device=device)
    t1 = time.time()
    info = {"rank": pid, "world_size": nproc, "device": str(device),
            "start": plan.start, "stop": plan.stop, "t0": t0, "t1": t1,
            "events": stats["events"], "rows": stats["rows"],
            "budgets": stats["budgets"],
            "phase_seconds": stats["phase_seconds"],
            "launches": read_counts(), "routes": read_routes(),
            "build": kernels.build_seconds(),
            "mem_free_total_bytes": [free, total],
            "max_memory_allocated": torch.cuda.max_memory_allocated(device)}
    spyral, labels, counts, events = rows_of(writer)
    np.savez(out_path, spyral=spyral, labels=labels, counts=counts,
             events=events, info=json.dumps(info))
    return 0


def multihost_path(sim, events_a, card: str) -> dict:
    """Phase 4m (see the module docstring). ``events_a`` is 4k's case A."""
    from attpc_engine_tpu_torch import kernels
    from attpc_engine_tpu_torch.detector import EngineParams

    vertices, momenta, z, a = events_a
    n = MULTIHOST_EVENTS
    reset_counts()
    stats, writer, calls, wall = drive(
        sim.config, EngineParams(events_per_batch=BATCH),
        reader=ArrayReader(vertices[:n], momenta[:n], z, a))
    launches, routes = read_counts(), read_routes()
    check_driver_run("4m single process", calls, stats["budgets"], launches,
                     routes)
    single = rows_of(writer)
    del writer
    single_rate = n / wall
    print(f"4m single process: {n} events, {stats['rows']} rows in "
          f"{wall:.3f} s, {single_rate:.1f} events/s end to end; tuned "
          f"budgets {stats['budgets']} [{card}]")
    library = kernels.build_seconds()["library"]
    torch.cuda.empty_cache()  # the children share the card
    with tempfile.TemporaryDirectory() as tmp:
        events_path = str(Path(tmp) / "events.npz")
        np.savez(events_path, vertices=vertices[:n], momenta=momenta[:n],
                 proton_numbers=z, mass_numbers=a)
        procs = []
        try:
            for rank in range(MULTIHOST_PROCESSES):
                env = dict(os.environ, RANK=str(rank), LOCAL_RANK="0",
                           WORLD_SIZE=str(MULTIHOST_PROCESSES))
                log = open(Path(tmp) / f"child{rank}.log", "w")
                procs.append((subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     MULTIHOST_CHILD, events_path,
                     str(Path(tmp) / f"child{rank}.npz")],
                    stdout=log, stderr=subprocess.STDOUT, env=env,
                    cwd=REPO), log))
            for proc, _ in procs:
                proc.wait(timeout=MULTIHOST_TIMEOUT_S)
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        failed = {rank: (proc.returncode,
                         (Path(tmp) / f"child{rank}.log").read_text()[-3000:])
                  for rank, (proc, _) in enumerate(procs)
                  if proc.returncode != 0}
        if failed:
            raise AssertionError(f"4m: children failed: {failed}")
        children = []
        for rank in range(MULTIHOST_PROCESSES):
            with np.load(Path(tmp) / f"child{rank}.npz") as f:
                children.append(({k: f[k] for k in (
                    "spyral", "labels", "counts", "events")},
                    json.loads(str(f["info"]))))
    union = tuple(np.concatenate([c[0][k] for c in children]) for k in (
        "spyral", "labels", "counts", "events"))
    for name, got, ref in zip(("spyral", "labels", "counts", "events"),
                              union, single):
        if not np.array_equal(got, ref):
            raise AssertionError(f"4m: the union of the {len(children)} "
                                 f"processes' {name} differs from the single "
                                 f"process's")
    print(f"4m: the union of {len(children)} processes' rows equals the "
          f"single process's bit for bit ({len(single[0])} rows, {n} events)")
    summed = {k: 0 for k in KERNELS}
    summed_routes = {"sort_rows": {"cluster": 0, "wide": 0}}
    for _, info in children:
        label = f"4m process {info['rank']}"
        check_default_launches(label, info["launches"], info["routes"])
        if info["build"]["built"] or info["build"]["library"] != library:
            raise AssertionError(f"{label}: built {info['build']}, expected "
                                 f"to load {library} as built by phase 2")
        for k, v in info["launches"].items():
            summed[k] += v
        for r, v in info["routes"]["sort_rows"].items():
            summed_routes["sort_rows"][r] += v
        rate = info["events"] / (info["t1"] - info["t0"])
        info["events_per_s"] = rate
        times = sorted(info["phase_seconds"].items(), key=lambda kv: -kv[1])
        print(f"{label} ({info['device']}): events [{info['start']}, "
              f"{info['stop']}), {info['rows']} rows in "
              f"{info['t1'] - info['t0']:.3f} s, {rate:.1f} events/s; tuned "
              f"budgets {info['budgets']}; library {info['build']} reused; "
              f"mem_get_info (free, total) at its start "
              f"{info['mem_free_total_bytes']}, peak allocated "
              f"{info['max_memory_allocated']} B; phase seconds "
              + ", ".join(f"{k} {v:.4f}" for k, v in times) + f" [{card}]")
    window = (max(c[1]["t1"] for c in children)
              - min(c[1]["t0"] for c in children))
    union_rate = n / window
    print(f"4m: {len(children)} processes on one card, {n} events in "
          f"{window:.3f} s from the first process's start to the last's end:"
          f" {union_rate:.1f} events/s, against {single_rate:.1f} for one "
          f"process on the same events [{card}]")
    return {"launches": summed, "routes": summed_routes,
            "single_events_per_s": single_rate, "single_wall_s": wall,
            "union_events_per_s": union_rate, "union_window_s": window,
            "processes": [c[1] for c in children]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from attpc_engine_tpu_torch import kernels
    from attpc_engine_tpu_torch.detector import deposit_cuda

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels.library()
    build = kernels.build_seconds()
    print(f"kernels {'built' if build['built'] else 'loaded, already built'}"
          f" in {build['seconds']:.1f} s: {build['library']}")

    sim, vertices, momenta = flagship_simulator("cuda")
    fused_cfg = dict(merge="fused", lookup="one_stage")
    sim_fused, _, _ = flagship_simulator("cuda", **fused_cfg)
    inputs = lookup_inputs(sim)
    flagship_inputs = flagship_lookup_inputs(sim_fused, vertices, momenta)
    w, cap = sim.engine.point_budget * 100, sim.engine.uniq_budget
    division = aten_scalar_division(float(sim.config.det_params.efield))
    print(f"ATen CUDA x / efield on {division['n']} f32 values: equal to x *"
          f" f32(1 / efield) in {division['equal_to_reciprocal_product']}, "
          f"to IEEE division in {division['equal_to_ieee_division']}")
    rows_args = flagship_rows_args(sim, vertices, momenta)
    deposit_rows = {
        "flagship": check_deposit_rows(rows_args, "flagship points", card),
        "synthetic": check_deposit_rows(synthetic_rows_args(sim, rows_args),
                                        "synthetic edge-case points", card),
    }
    del rows_args
    sorts = {
        "merge": check_sort(sort_inputs(w, False), "synthetic merge rows",
                            ("cluster", 8), card),
        "flagship": check_sort(flagship_sort_rows(sim, vertices, momenta),
                               "flagship merge rows", ("cluster", 8), card),
        "convert": check_sort(sort_inputs(cap, True), "convert rows",
                              ("cluster", 1), card),
        "retry": check_sort(sort_inputs(2 * w, False),
                            "first overflow-retry width", ("cluster", 16),
                            card),
        "wide": check_sort(sort_inputs(4 * w, False),
                           "merge rows at point budget 4,096", ("wide", None),
                           card),
        "wide_convert": check_sort(sort_inputs(32 * cap, True),
                                   "signed convert rows, five uniq "
                                   "doublings", ("wide", None), card),
        "wide_819200": check_sort(sort_inputs(8 * w, False),
                                  "merge rows at point budget 8,192",
                                  ("wide", None), card),
        "wide_odd": check_sort(sort_inputs(262145, False), "odd width",
                               ("wide", None), card),
        "wide_equal": check_sort(
            torch.full((BATCH, 4 * w), (2**31 - 1) << 32, device="cuda"),
            "rows of one value", ("wide", None), card),
    }
    res = {
        "transport": check_transport(sim, vertices[:BATCH], momenta[:BATCH],
                                     card),
        "deposit_rows": deposit_rows["flagship"],
        "deposit": check_deposit(sim, inputs, "random cells", card),
        "sort_rows": sorts["merge"],
        "sort_rows_wide": sorts["wide"],
        "packed_key_lookup_rows": check_rows_lookup(
            sim, inputs, "random cells", card),
        "pad_lookup": check_pad_lookup(sim, inputs, "random cells", card),
    }
    lookups_flagship = {
        "deposit": check_deposit(sim, flagship_inputs, "flagship points",
                                 card),
        "pad_lookup": check_pad_lookup(sim, flagship_inputs,
                                       "flagship points", card),
    }
    from attpc_engine_tpu_torch.detector.sort_cuda import CTA_CAPACITY

    def synthetic_merge(width, label, expect, rank_bits=1):
        return check_merge(synthetic_merge_inputs(width, cap, rank_bits),
                           label, expect, card)

    merges = {
        "flagship": check_merge(
            flagship_merge_inputs(sim_fused, vertices, momenta),
            "flagship keys", ("cluster", 8), card),
        "synthetic": synthetic_merge(w, "synthetic keys", ("cluster", 8), 2),
        "ctas_1": synthetic_merge(cap, "one CTA", ("cluster", 1)),
        "ctas_2": synthetic_merge(w // 4, "two CTAs", ("cluster", 2)),
        "ctas_4": synthetic_merge(w // 2, "four CTAs", ("cluster", 4)),
        "ctas_16": synthetic_merge(2 * w, "first overflow-retry width",
                                   ("cluster", 16)),
        "edge": check_merge(
            edge_merge_inputs(16 * CTA_CAPACITY, 1000),
            "the route's widest rows, with rows of sentinels only, of no "
            "sentinel and of one live lane, cap below n_uniq",
            ("cluster", 16), card),
        "odd_width": synthetic_merge(100_003, "width not a multiple of 128",
                                     ("cluster", 8)),
        "two_launch": synthetic_merge(FUSED_WIDE_POINT_BUDGET * 100,
                                      "rows past the cluster route",
                                      ("two_launch", 0)),
    }
    k6_flagship = check_rows_lookup(sim, flagship_inputs, "flagship points",
                                    card)
    del flagship_inputs
    res["merge_cluster"] = merges["flagship"]
    res["merge_fused"] = merges["two_launch"]

    ix, iy, tbr = inputs
    table = sim.pad_table
    sim_two_stage, _, _ = flagship_simulator("cuda", merge="fused",
                                             lookup="two_stage")
    paths = {
        "default": main_path(sim, vertices, momenta, "default",
                             ("transport", "deposit_rows", "sort_rows"),
                             ("deposit", "merge_cluster", "merge_fused",
                              "packed_key_lookup_rows", "pad_lookup",
                              "sort_rows_wide"), card, keep_rows=True),
        "fused": main_path(sim_fused, vertices, momenta, "fused",
                           ("transport", "sort_rows", "merge_cluster",
                            "packed_key_lookup_rows"),
                           ("deposit", "deposit_rows", "pad_lookup",
                            "sort_rows_wide", "merge_fused"), card,
                           per_batch={"merge_cluster": 1, "sort_rows": 1}),
        "fused_two_stage": main_path(
            sim_two_stage, vertices, momenta, "fused two-stage",
            ("transport", "sort_rows", "merge_cluster", "deposit"),
            ("packed_key_lookup_rows", "pad_lookup", "deposit_rows",
             "sort_rows_wide", "merge_fused"), card,
            per_batch={"deposit": 1, "merge_cluster": 1, "sort_rows": 1}),
        "pad_lookup": entry_point_path(
            "pad_lookup",
            lambda: deposit_cuda.pad_lookup(ix, iy, table), card),
        "packed_key_lookup": entry_point_path(
            "deposit",
            lambda: deposit_cuda.packed_key_lookup(ix, iy, tbr, table, 1,
                                                   2**31 - 1), card),
    }
    del sim_fused, sim_two_stage
    sim_retry, _, _ = flagship_simulator(
        "cuda", point_budget=RETRY_POINT_BUDGET)
    paths["retry_width"] = main_path(
        sim_retry, vertices[:2 * BATCH], momenta[:2 * BATCH], "retry-width",
        ("transport", "deposit_rows", "sort_rows", "sort_rows_wide"),
        ("deposit", "merge_cluster", "merge_fused", "packed_key_lookup_rows",
         "pad_lookup"), card, wide_per_batch=2)
    del sim_retry
    sim_fused_wide, _, _ = flagship_simulator(
        "cuda", point_budget=FUSED_WIDE_POINT_BUDGET, **fused_cfg)
    paths["fused_wide"] = main_path(
        sim_fused_wide, vertices[:2 * BATCH], momenta[:2 * BATCH],
        "fused wide", ("transport", "sort_rows", "sort_rows_wide",
                       "merge_fused", "packed_key_lookup_rows"),
        ("deposit", "deposit_rows", "pad_lookup", "merge_cluster"), card,
        wide_per_batch=1, per_batch={"merge_fused": 1, "sort_rows": 2})
    del sim_fused_wide
    paths["driver"] = driver_path(sim, paths["default"], card)
    del paths["default"]["batches"]
    tuned = paths["driver"]["budgets"]
    sim_tuned, _, _ = flagship_simulator(
        "cuda", n_time_steps=tuned["steps"], point_budget=tuned["point"],
        uniq_budget=tuned["uniq"], out_budget=tuned["out"])
    paths["tuned_step"] = main_path(
        sim_tuned, vertices, momenta, "default at the tuned budgets",
        ("transport", "deposit_rows", "sort_rows"),
        ("deposit", "merge_cluster", "merge_fused", "packed_key_lookup_rows",
         "pad_lookup", "sort_rows_wide"), card)
    print(f"default step at the tuned budgets {tuned}: "
          f"{paths['tuned_step']['ms_per_batch']:.3f} ms/batch, against "
          f"{paths['default']['ms_per_batch']:.3f} at the 10,000-step window"
          f" (phase 4) [{card}]")
    sorts["tuned"] = check_sort(
        flagship_sort_rows(sim_tuned, vertices, momenta),
        "flagship merge rows at the tuned point budget", ("cluster", None),
        card)
    del sim_tuned
    compare_first("tuned budgets", "phase 4 (10,000 steps, default "
                  "budgets)", paths["default"]["first"],
                  paths["tuned_step"]["first"])
    compare_first("fused two-stage", "fused one-stage (4b)",
                  paths["fused"]["first"], paths["fused_two_stage"]["first"])
    compare_first("retry width", "point budget 1,024",
                  paths["default"]["first"], paths["retry_width"]["first"])
    compare_first("fused wide", "point budget 1,024",
                  paths["fused"]["first"], paths["fused_wide"]["first"])
    compare_clouds(paths["default"]["first"], paths["fused"]["first"],
                   float(sim.config.det_params.mpgd_gain))
    check_against_cpu(sim, vertices, momenta)
    paths["kinematics"] = kinematics_path(card)
    events_a = paths["kinematics"].pop("events_a")
    paths["kinematics_driver"] = kinematics_driver_path(sim, events_a, card)
    paths["multihost"] = multihost_path(sim, events_a, card)
    del events_a

    rows = []
    for name, (_, _, src, replaces, path) in KERNELS.items():
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "path": path,
               "launches": paths[path]["launches"][name],
               "launches_by_path": {p: paths[p]["launches"][name]
                                    for p in paths},
               **res[name]}
        if name in ("sort_rows", "sort_rows_wide"):
            row["wide_source"] = "attpc_engine_tpu_torch/csrc/merge_rows.cu"
            for key in sorts:
                row.update({f"{key}_{k}": sorts[key][k] for k in (
                    "ms", "plain_ms", "bound_ms", "library_ms")})
            row["shapes"] = {key: {k: v[k] for k in (
                "width", "k3_route", "n_cta", "chunks", "chunk_w", "passes",
                "ms", "library_ms", "bound_ms", "floor_ms",
                "allocated_bytes")} for key, v in sorts.items()}
            row["launches_by_route"] = {p: paths[p]["routes"]["sort_rows"]
                                        for p in paths}
        if name == "deposit_rows":
            row.update(synthetic_ms=deposit_rows["synthetic"]["ms"],
                       synthetic_plain_ms=deposit_rows["synthetic"]["plain_ms"],
                       synthetic_before_ms=deposit_rows["synthetic"][
                           "before_ms"],
                       aten_division=division)
        if name in lookups_flagship:
            row.update({f"flagship_{k}": lookups_flagship[name][k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms")})
        if name == "packed_key_lookup_rows":
            row.update(flagship_ms=k6_flagship["ms"],
                       flagship_k2_ms_same_run=k6_flagship["k2_ms_same_run"],
                       flagship_plain_ms=k6_flagship["plain_ms"],
                       flagship_bound_ms=k6_flagship["bound_ms"])
        if name in ("merge_cluster", "merge_fused"):
            row["cases"] = {key: {k: v[k] for k in (
                "width", "cap", "k5_route", "n_cta", "chunk", "live_share",
                "ms", "two_launch_ms", "plain_ms", "bound_ms",
                "allocated_bytes")} for key, v in merges.items()}
        rows.append(row)
    print(json.dumps({
        "kernels": rows,
        "main_path_ms_per_batch": paths["default"]["ms_per_batch"],
        "events_per_s": paths["default"]["events_per_s"],
        "fused_path_ms_per_batch": paths["fused"]["ms_per_batch"],
        "fused_events_per_s": paths["fused"]["events_per_s"],
        "fused_two_stage_path_ms_per_batch": paths["fused_two_stage"][
            "ms_per_batch"],
        "retry_width_path_ms_per_batch": paths["retry_width"]["ms_per_batch"],
        "fused_wide_path_ms_per_batch": paths["fused_wide"]["ms_per_batch"],
        "tuned_step_ms_per_batch": paths["tuned_step"]["ms_per_batch"],
        "driver": {k: paths["driver"][k] for k in (
            "budgets", "wall_s", "events_per_s", "phase_seconds",
            "dispatches", "run_b_dispatches", "run_b_budgets")},
        "kinematics": {k: paths["kinematics"][k] for k in (
            "cases", "events_per_s")},
        "kinematics_driver": {k: paths["kinematics_driver"][k] for k in (
            "budgets", "wall_s", "events_per_s", "rows", "phase_seconds")},
        "multihost": {k: v for k, v in paths["multihost"].items()
                      if k not in ("launches", "routes")},
        "card": card}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [MULTIHOST_CHILD]:
        sys.exit(multihost_child(*sys.argv[2:4]))
    sys.exit(main())
