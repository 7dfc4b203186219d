"""Where the PyTorch port's detector step spends its device time.

Runs the flagship batch (384 events of the committed smoke kinematics, the
default engine parameters, or with ``--fused`` the fused-merge
configuration ``merge="fused"`` with ``lookup="one_stage"``, or with
``--fused --lookup two_stage`` its two-stage lookup, K2) on the card: two
warm-up batches, then one batch under ``torch.profiler`` with CPU and CUDA
activities. Prints the card's name and power limit, the step's wall time,
the summed device time of its kernels and the device's idle share over the
step, the device time by stage (record_function ranges), and the kernels
with the most device time.

Run from the repository root on a machine with a CUDA card:
``python3 tools/profile_torch_step.py [--fused [--lookup two_stage] |
--rows-before] [trace.json]``; with a path, the chrome trace of the
profiled batch is written there. ``--rows-before`` profiles the default
step with its deposit rows built as they were before the rows kernel
(``deposition.deposit_rows_plain`` with K2 as its lookup: the mesh and
charges in PyTorch passes, K2, the mask and pack64), so the
``deposit_rows`` span of the two runs compares the two ways on one card.
With ``--fused`` the K5 span (``merge_fused``) names the route K5 took
(``merge_cuda.route``), and the step's kernel device time, idle share and
launch count are printed beside ``FUSED_BEFORE``, the same profile of the
fused step when K5 was ``pack64``, K3 and the tail kernel on every width.

``--tuned`` profiles the default step at the window and budgets that
``run_simulation``'s auto-tuning gives the flagship (its batch loop,
``simulator.run_reader``, run over the first batch), then the whole loop
over the 1,536 committed events under the profiler, into a writer that
copies the rows it keeps and into one that keeps nothing: its wall time,
its kernels' device time and the device's idle share end to end, and its
phase times.

``--transport-steps`` instead builds K1 (``csrc/transport.cu``) with
``-DATTPC_K1_STEPS``, runs one 500-step window of the flagship batch's 768
tracks, with the fast paths and with ``force_ieee`` (each checked against
the default build's output bit for bit), and prints, from the clock64()
that lane 0 of each warp records at the start of every step:
SM cycles per step while any lane of the warp is alive (mean, median,
90th percentile), the cycles of the dead tail of the window (after the
warp's last live lane died), the window's cycles, the steps of the
longest-lived track, and the share of the latency bound (the critical
path of one live step, ``tools/k1_critical_path.py``, taken in the same
run) in the measured live cycles.

``--sort-phases`` instead builds K3's cluster route
(``csrc/sort_cluster.cu``) with ``-DATTPC_SORT_PHASES``, sorts the
flagship's own merge rows, synthetic merge rows and convert rows with it
(each checked against ``torch.sort``), and prints per CTA the SM cycles
of each phase summed over the eight passes: load, rank, totals (the
digit totals and the first cluster barrier, with the wait for the
slowest CTA), offsets, scatter, barrier (the end-of-pass cluster barrier
and the next pass's reset) and store; mean and 90th percentile over the
CTAs; and how many clusters of each size the card holds at once.

``--wide-phases`` instead splits K3's wide route into its launches: for
merge rows [384, 409600] and [384, 819200] and each number of chunks c in
2, 4, ..., 64 whose chunks the cluster kernel holds, it runs the route on
``sort_cuda.wide_plan(width, c)`` (checked against ``torch.sort``) with
CUDA events around the chunk sort and each merge pass, and prints each
launch's mean time over three runs, their sum, the same run's
``torch.sort``, the byte bound and the design's floor (1 + log2 c times
the bound). Its table is behind the chunk rule ``sort_cuda.WIDE_CHUNK``.

``--kinematics`` instead profiles the kinematics stage: chip_smoke's
phase 4k cases A (the flagship, one draw) and D (12C(d,p) at 16 MeV with
Ex uniform in [0, 30] MeV, ~15 draws), 65,536 events each through
``run_kinematics`` after one warm-up run: the wall (sampling plus the copy
to the host), the kernels' device time and the device's idle share, the
launches, the host and device time of the draws (``draw_noise``, the
Philox words and the noise), the parameters (``sample``) and the chain
(``compute_chain``), and the kernels with the most device time.

``--lookups [OTHER/deposit.cu]`` instead times K2 and K7
(``attpc_packed_key_lookup``, ``attpc_pad_lookup``) on chip_smoke's random
cells and on the flagship's own points (the (ix, iy, tbr) of a fused
batch), each checked bit for bit against its plain version, with their
bounds. Given another checkout's ``deposit.cu`` with the same C interface
(the parent commit's, unpacked by ``git archive``), it builds that file
into a library of its own and times its K2 and K7 on the same inputs in
the same process, in turns: other, this, this, other.
"""

import ctypes
import functools
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import k1_critical_path  # noqa: E402
from attpc_engine_tpu_torch.detector import (  # noqa: E402
    deposit_cuda,
    deposition,
    simulator,
)

STAGES = {
    (simulator, "integrate_tracks"): "transport",
    (simulator, "fano_noise"): "fano_noise",
    (deposition, "_prefix_sum"): "prefix_sum",
    (deposition, "sort_rows"): "merge_sort",
    (deposition, "sort_rows_live"): "merge_sort",
    (deposition, "compact_runs"): "compact_runs",
    (deposition, "merge_runs_fused"): "merge_fused",
    (deposition, "deposit_rows"): "deposit_rows",
    (simulator, "deposit_and_merge"): "deposit_and_merge",
    (simulator, "sort_rows"): "convert_sort",
}


# this profile of the fused step with K5 as pack64, K3 and the tail kernel
# (PERF.md section 5), NVIDIA H100 80GB HBM3, 700.00 W
FUSED_BEFORE = ("kernel device time 12.179 ms, idle share 0.494, 594 "
                "launches, merge_fused span 4.127 ms")


def _ranged(name, fn):
    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return wrapped


KINEMATICS_RANGES = ("draw_noise", "sample", "compute_chain")


def kinematics() -> None:
    """``--kinematics`` (see the module docstring)."""
    from attpc_engine_tpu_torch.kinematics.pipeline import KinematicsPipeline

    for name in KINEMATICS_RANGES:
        attr = f"_{name}"
        setattr(KinematicsPipeline, attr,
                _ranged(name, getattr(KinematicsPipeline, attr)))
    cuda = torch.autograd.DeviceType.CUDA
    for case in "AD":
        pipe = chip_smoke.kinematics_pipeline(case, "cuda")
        chip_smoke.sample_kinematics(pipe)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, stats, wall = chip_smoke.sample_kinematics(pipe)
        events = prof.key_averages()
        kern = sorted((e for e in events if e.device_type == cuda
                       and e.key not in KINEMATICS_RANGES),
                      key=lambda e: -e.self_device_time_total)
        dev_us = sum(e.self_device_time_total for e in kern)
        print(f"kinematics ({case}) {pipe}: {chip_smoke.KINEMATICS_EVENTS} "
              f"events, {stats['draws'][0]} draws; wall {1e3 * wall:.3f} ms "
              f"under the profiler; kernel device time {dev_us / 1e3:.3f} ms;"
              f" device idle share {max(0.0, 1 - dev_us / 1e6 / wall):.3f};"
              f" launches {sum(e.count for e in kern)}")
        for e in events:
            if e.key in KINEMATICS_RANGES and e.device_type != cuda:
                dev = sum(d.self_device_time_total for d in events
                          if d.key == e.key and d.device_type == cuda)
                print(f"  {e.key:14s} host {e.cpu_time_total / 1e3:9.3f} ms,"
                      f" device span {dev / 1e3:9.3f} ms (calls {e.count})")
        print("  top kernels by device time (ms, launches):")
        for e in kern[:8]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} {e.count:6d}  "
                  f"{e.key[:90]}")


def sort_phases() -> None:
    """Per-phase SM cycles of K3's cluster route (see the module doc)."""
    from attpc_engine_tpu_torch import kernels
    from attpc_engine_tpu_torch.detector import sort_cuda

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = kernels.BUILD_DIR / "libattpc_sort_phases.so"
    subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS,
                    "-DATTPC_SORT_PHASES", "-shared", "-o", str(so),
                    str(kernels.CSRC / "sort_cluster.cu")],
                   check=True, timeout=kernels.BUILD_TIMEOUT_S)
    lib = ctypes.CDLL(str(so))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    i64 = ctypes.c_int64
    lib.attpc_sort_rows_cluster.argtypes = [vp, vp, i32, i64, i32, i32, i64,
                                            i32, i64, vp]
    lib.attpc_sort_phases.argtypes = [vp, ctypes.c_size_t]
    sim, vert, mom = chip_smoke.flagship_simulator("cuda")
    w, cap = sim.engine.point_budget * 100, sim.engine.uniq_budget
    rows = {"flagship merge rows": chip_smoke.flagship_sort_rows(sim, vert,
                                                                 mom),
            "synthetic merge rows": chip_smoke.sort_inputs(w, False),
            "convert rows": chip_smoke.sort_inputs(cap, True)}
    for label, x in rows.items():
        e, width = x.shape
        r = sort_cuda.route(width)
        out = torch.empty_like(x)

        def run():
            err = lib.attpc_sort_rows_cluster(
                x.data_ptr(), out.data_ptr(), e, width, r.n_cta, r.chunk,
                width, 1, width, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"sort_rows_cluster failed ({err})")

        ms = chip_smoke.cuda_ms(run, 5)
        if not torch.equal(out, torch.sort(x, dim=1).values):
            raise AssertionError(f"{label}: differs from torch.sort")
        clock = np.zeros((384 * 16, 48), dtype=np.int64)
        kernels.check(lib.attpc_sort_phases(clock.ctypes.data, clock.nbytes),
                      "sort_phases")
        c = clock[:e * r.n_cta].astype(np.float64)

        def over_passes(a, b):
            return sum(c[:, b + 5 * p] - c[:, a + 5 * p] for p in range(8))

        phases = {
            "load": c[:, 1] - c[:, 0],
            "rank": over_passes(1, 2),
            "totals": over_passes(2, 3),
            "offsets": over_passes(3, 4),
            "scatter": over_passes(4, 5),
            "barrier": (sum(c[:, 6 + 5 * p] - c[:, 5 + 5 * p]
                            for p in range(7)) + c[:, 41] - c[:, 40]),
            "store": c[:, 42] - c[:, 41],
        }
        total = c[:, 42] - c[:, 0]
        print(f"{label} {list(x.shape)}, {r.n_cta} CTAs of {r.chunk}: "
              f"{ms:.3f} ms (instrumented build); SM cycles per CTA, mean / "
              f"p90 / share of the mean total {total.mean():.0f}:")
        for name, v in phases.items():
            print(f"  {name:8s} {v.mean():9.0f} {np.percentile(v, 90):9.0f}"
                  f"  {v.mean() / total.mean():.3f}")
    for n in sort_cuda.CLUSTER_SIZES:
        resident = ctypes.c_int(0)
        kernels.check(kernels.library().attpc_sort_rows_cluster_occupancy(
            n, sort_cuda.CTA_CAPACITY, ctypes.byref(resident)), "occupancy")
        print(f"resident clusters of {n} CTAs at full capacity: "
              f"{resident.value}")
    print("SM clock now: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())


def wide_phases(reps: int = 3) -> None:
    """K3's wide route by launch, for each number of chunks (see the
    module doc)."""
    from attpc_engine_tpu_torch.detector import sort_cuda

    for w in (409600, 819200):
        x = chip_smoke.sort_inputs(w, False)
        ref = torch.sort(x, dim=1).values
        library_ms = chip_smoke.cuda_ms(lambda: torch.sort(x, dim=1), reps)
        bound_ms = chip_smoke.bound(2 * x.numel() * 8)["bound_ms"]
        print(f"merge rows {list(x.shape)}: torch.sort {library_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms; the rule gives "
              f"{sort_cuda.route(w).chunks} chunks")
        for c in (2, 4, 8, 16, 32, 64):
            if -(-w // c) > 16 * sort_cuda.CTA_CAPACITY:
                continue
            plan = sort_cuda.wide_plan(w, c)
            times: dict[str, float] = {}
            for rep in range(reps + 1):  # the first run is warm-up
                events = [torch.cuda.Event(enable_timing=True)]
                labels = []

                def mark(label):
                    events.append(torch.cuda.Event(enable_timing=True))
                    events[-1].record()
                    labels.append(label)

                events[0].record()
                out = sort_cuda.sort_wide(x, plan, mark)
                torch.cuda.synchronize()
                if rep == 0:
                    if not torch.equal(out, ref):
                        raise AssertionError(f"wide route, {c} chunks: "
                                             f"differs from torch.sort")
                    continue
                for i, label in enumerate(labels):
                    times[label] = times.get(label, 0.0) + (
                        events[i].elapsed_time(events[i + 1]) / reps)
            del out
            total = sum(times.values())
            print(f"  c={c:2d} chunks of {plan.chunk_w} ({plan.n_cta} CTAs "
                  f"of {plan.chunk}): total {total:.3f} ms = "
                  + " + ".join(f"{k} {v:.3f}" for k, v in times.items())
                  + f"; ratio to torch.sort {total / library_ms:.3f}; floor "
                  f"{(1 + plan.passes) * bound_ms:.4f} ms")
        del x, ref


def lookups(other: str | None, reps: int = 20) -> None:
    """K2 and K7 of this checkout, and of ``other`` if given, on the same
    inputs in turns (see the module doc)."""
    from attpc_engine_tpu_torch import kernels

    libs = {"this": kernels.library()}
    order = ["this", "this"]
    if other:
        so = kernels.BUILD_DIR / "libattpc_lookups_other.so"
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                        str(so), other], check=True,
                       timeout=kernels.BUILD_TIMEOUT_S)
        lib = ctypes.CDLL(str(so))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.attpc_packed_key_lookup.argtypes = [vp] * 5 + [i64, i32, i32, vp]
        lib.attpc_pad_lookup.argtypes = [vp] * 4 + [i64, vp]
        libs["other"] = lib
        order = ["other", "this", "this", "other"]
        print(f"other: {other}")
    sim, vert, mom = chip_smoke.flagship_simulator("cuda")
    sim_fused, _, _ = chip_smoke.flagship_simulator(
        "cuda", merge="fused", lookup="one_stage")
    inputs = {"random cells": chip_smoke.lookup_inputs(sim),
              "flagship points": chip_smoke.flagship_lookup_inputs(
                  sim_fused, vert, mom)}
    table, sent = sim.pad_table, 2**31 - 1
    ptr = kernels.ptr
    for label, (ix, iy, tbr) in inputs.items():
        p = ix.shape[0]
        out = torch.empty((p, 10, 10), dtype=torch.int32, device="cuda")
        calls = {
            "K2": (lambda lib: lib.attpc_packed_key_lookup(
                ptr(ix), ptr(iy), ptr(tbr), ptr(table), ptr(out), p, 1, sent,
                kernels.stream(ix)),
                deposit_cuda.packed_key_lookup_plain(ix, iy, tbr, table, 1,
                                                     sent),
                chip_smoke.lookup_bytes(p, True)),
            "K7": (lambda lib: lib.attpc_pad_lookup(
                ptr(ix), ptr(iy), ptr(table), ptr(out), p, kernels.stream(ix)),
                deposit_cuda.pad_lookup_plain(ix, iy, table),
                chip_smoke.lookup_bytes(p, False)),
        }
        for name, (call, ref, n_bytes) in calls.items():
            for who, lib in libs.items():
                kernels.check(call(lib), f"{name} ({who})")
                if not torch.equal(out, ref):
                    raise AssertionError(f"{name} ({who}), {label}: differs "
                                         f"from its plain version")
            times = {who: [] for who in libs}
            for who in order:
                times[who].append(chip_smoke.cuda_ms(
                    lambda: call(libs[who]), reps))
            bound_ms = chip_smoke.bound(n_bytes)["bound_ms"]
            print(f"{name}, {label}, P={p}: bit-exact; "
                  + "; ".join(f"{who} " + " / ".join(f"{t:.4f}" for t in ts)
                              + " ms" for who, ts in times.items())
                  + f"; bound {bound_ms:.4f} ms")


def transport_steps() -> None:
    """Per-step SM cycles of K1 (see the module doc), both with the
    branch-free fast paths and with every step through the compiler's IEEE
    operators (``force_ieee``)."""
    from attpc_engine_tpu_torch import kernels
    from attpc_engine_tpu_torch.detector import transport_cuda

    so = kernels.BUILD_DIR / "libattpc_k1_steps.so"
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-DATTPC_K1_STEPS",
                    "-shared", "-o", str(so),
                    str(kernels.CSRC / "transport.cu")],
                   check=True, timeout=kernels.BUILD_TIMEOUT_S)
    lib = ctypes.CDLL(str(so))
    kernels.declare_rk4(lib)
    lib.attpc_k1_step_clock.argtypes = [ctypes.c_void_p]
    sim, vert, mom = chip_smoke.flagship_simulator("cuda")
    b_ev = chip_smoke.BATCH
    ti = chip_smoke.transport_inputs(sim, vert[:b_ev], mom[:b_ev])
    steps, b = ti["steps"], ti["b"]
    n_warps = -(-b // 32)
    clock = torch.zeros((n_warps, steps + 1), dtype=torch.int64,
                        device="cuda")
    kernels.check(lib.attpc_k1_step_clock(clock.data_ptr()), "k1_step_clock")
    ref = ti["run"](transport_cuda.rk4_window_cuda)
    now, top = chip_smoke.sm_clock_mhz()
    path = k1_critical_path.fast_step()["cycles"]
    print(f"SM clock {now} MHz (max {top} MHz); critical path of a live "
          f"step {path:.1f} SM cycles")
    for force_ieee in (False, True):
        def instrumented(*args):
            transport_cuda.launch_rk4(lib, *args, force_ieee=force_ieee)

        ms = chip_smoke.cuda_ms(lambda: ti["run"](instrumented), 5)
        got = ti["run"](instrumented)
        if not all(torch.equal(a, c) for a, c in zip(got, ref)):
            raise AssertionError("the instrumented K1 differs from the "
                                 "default build")
        per_track = chip_smoke.steps_run(ti["alive0"], got[2]).cpu().numpy()
        live_in = torch.cat([ti["alive0"][None], got[2][:-1]]).cpu().numpy()
        c = clock.cpu().numpy().astype(np.float64)
        dt = np.diff(c, axis=1)  # [warps, steps]
        pad = n_warps * 32 - b
        warp_live = np.pad(live_in, ((0, 0), (0, pad))).reshape(
            steps, n_warps, 32).any(axis=2).T  # [warps, steps]
        live_dt, tail_dt = dt[warp_live], dt[~warp_live]
        window = c[:, -1] - c[:, 0]
        share = path / np.mean(live_dt)
        print(f"K1{' (force_ieee)' if force_ieee else ''}, {b} tracks in "
              f"{n_warps} warps, {steps}-step window (instrumented build "
              f"{ms:.3f} ms): SM cycles per live step mean "
              f"{live_dt.mean():.1f}, median {np.median(live_dt):.1f}, p90 "
              f"{np.percentile(live_dt, 90):.1f} over {live_dt.size} "
              f"warp-steps; dead tail {tail_dt.sum() / n_warps:.0f} cycles a "
              f"warp ({tail_dt.size / n_warps:.1f} steps, "
              f"{tail_dt.mean():.1f} a step); window {window.mean():.0f} "
              f"cycles a warp (max {window.max():.0f}); longest-lived track "
              f"{int(per_track.max())} steps; latency bound "
              f"{path:.1f} cycles a step, share of the measured live step "
              f"{share:.3f}")


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if "--sort-phases" in args:
        print(f"card: {chip_smoke.card_line()}; K3 cluster route phases")
        sort_phases()
        return 0
    if "--wide-phases" in args:
        print(f"card: {chip_smoke.card_line()}; K3 wide route by launch")
        wide_phases()
        return 0
    if "--lookups" in args:
        rest = args[args.index("--lookups") + 1:]
        print(f"card: {chip_smoke.card_line()}; K2 and K7")
        lookups(rest[0] if rest else None)
        return 0
    if "--kinematics" in args:
        print(f"card: {chip_smoke.card_line()}; the kinematics stage")
        kinematics()
        return 0
    if "--transport-steps" in args:
        print(f"card: {chip_smoke.card_line()}; K1 cycles per step")
        transport_steps()
        return 0
    fused = "--fused" in args
    rows_before = "--rows-before" in args
    tuned = "--tuned" in args
    lookup = "one_stage"
    if "--lookup" in args:
        i = args.index("--lookup")
        lookup = args[i + 1]
        del args[i:i + 2]
    args = [a for a in args if a not in ("--fused", "--rows-before",
                                         "--tuned")]
    print(f"card: {chip_smoke.card_line()}; configuration "
          f"{f'fused, lookup {lookup}' if fused else 'default'}"
          f"{', rows built as before the rows kernel' if rows_before else ''}"
          f"{', at the tuned budgets' if tuned else ''}")
    if rows_before:
        deposition.deposit_rows = functools.partial(
            deposition.deposit_rows_plain,
            lookup=deposit_cuda.packed_key_lookup_cuda)
    for (mod, attr), name in STAGES.items():
        setattr(mod, attr, _ranged(name, getattr(mod, attr)))
    engine = dict(merge="fused", lookup=lookup) if fused else {}
    if tuned:
        engine.update(tuned_budgets())
    sim, vert, mom = chip_smoke.flagship_simulator("cuda", **engine)
    # every step eager: the stages are timed by the ranges of their Python
    # calls, which a replay of the step's CUDA graph does not make
    sim._graphs = None
    b = chip_smoke.BATCH

    def step(i):
        out = sim.simulate_batch(vert[i * b:(i + 1) * b],
                                 mom[i * b:(i + 1) * b], seed=1,
                                 event_start=i * b, assemble=False)
        return out["meta_i32"].cpu()

    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        meta = step(2)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # the ranges appear on the device timeline too; kernels are the rest
    kern = sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.key not in STAGES.values()),
                  key=lambda e: -e.self_device_time_total)
    dev_us = sum(e.self_device_time_total for e in kern)
    print(f"step wall {1e3 * wall:.3f} ms; kernel device time "
          f"{dev_us / 1e3:.3f} ms; device idle share "
          f"{max(0.0, 1 - dev_us / 1e6 / wall):.3f}; steps_alive "
          f"{simulator.StepMeta.decode(meta).steps_alive}")
    print("device span by stage (ms; deposit_and_merge holds deposit_rows, "
          "merge_sort, compact_runs, prefix_sum and merge_fused):")
    for e in events:
        if (e.key in STAGES.values()
                and e.device_type == torch.autograd.DeviceType.CUDA):
            print(f"  {e.key:18s} {e.self_device_time_total / 1e3:9.3f}  "
                  f"(calls {e.count})")
    print("top kernels by device time (ms, launches):")
    for e in kern[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} {e.count:6d}  "
              f"{e.key[:90]}")
    print("the port's own kernels (csrc/*.cu; ms, launches):")
    # csrc's kernels, "void " before a template's name; PyTorch's are in at::
    own = "(anonymous namespace)::"
    for e in kern:
        name = e.key.removeprefix("void ")
        if name.startswith(own):
            print(f"  {e.self_device_time_total / 1e3:9.3f} {e.count:6d}  "
                  f"{name[len(own):][:60]}")
    n_launches = sum(e.count for e in kern)
    print(f"kernel launches in the step: {n_launches}")
    if fused:
        from attpc_engine_tpu_torch.detector import merge_cuda

        w = sim.engine.point_budget * 100
        print(f"fused step: K5 route {merge_cuda.route(w)} at width {w}; "
              f"kernel device time {dev_us / 1e3:.3f} ms, idle share "
              f"{max(0.0, 1 - dev_us / 1e6 / wall):.3f}, {n_launches} "
              f"launches; before the cluster route: {FUSED_BEFORE}")
    if tuned:
        profile_driver(sim)
    if args:
        prof.export_chrome_trace(args[0])
    return 0


def tuned_budgets() -> dict:
    """The EngineParams fields that the driver's auto-tuning gives the
    flagship: its batch loop run over the first batch."""
    from attpc_engine_tpu_torch.detector import EngineParams, simulator

    sim, _, _ = chip_smoke.flagship_simulator("cuda")
    stats = simulator.run_reader(
        sim.config, chip_smoke.NpzReader(), chip_smoke.MemoryWriter(),
        engine=EngineParams(events_per_batch=chip_smoke.BATCH), seed=1,
        show_progress=False, stop_event=chip_smoke.BATCH, device="cuda")
    b = stats["budgets"]
    print(f"tuned budgets {b}")
    return {"n_time_steps": b["steps"], "point_budget": b["point"],
            "uniq_budget": b["uniq"], "out_budget": b["out"]}


def profile_driver(sim) -> None:
    """The driver's batch loop over the 1,536 committed events under the
    profiler, into a writer that copies the rows it keeps
    (``chip_smoke.MemoryWriter``) and into one that keeps nothing
    (``chip_smoke.CountingWriter``, the driver's own pace): wall, kernels'
    device time, device idle share, phases."""
    from attpc_engine_tpu_torch.detector import EngineParams, simulator

    for writer in (chip_smoke.MemoryWriter(), chip_smoke.CountingWriter()):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            stats = simulator.run_reader(
                sim.config, chip_smoke.NpzReader(), writer,
                engine=EngineParams(events_per_batch=chip_smoke.BATCH),
                seed=1, show_progress=False, device="cuda")
            wall = time.perf_counter() - t0
        dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.key not in STAGES.values())
        phases = ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            stats["phase_seconds"].items(), key=lambda kv: -kv[1]))
        print(f"driver over {stats['events']} events into a "
              f"{type(writer).__name__} under the profiler: wall "
              f"{wall:.3f} s ({stats['events'] / wall:.1f} events/s), kernel "
              f"device time {dev_us / 1e6:.4f} s, device idle share "
              f"{max(0.0, 1 - dev_us / 1e6 / wall):.3f}; budgets "
              f"{stats['budgets']}; phase seconds: {phases}")


if __name__ == "__main__":
    sys.exit(main())
