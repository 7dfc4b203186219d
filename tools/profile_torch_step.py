"""Where the PyTorch port's detector step spends its device time.

Runs the flagship batch (384 events of the committed smoke kinematics, the
default engine parameters, or with ``--fused`` the fused-merge, one-stage
configuration ``merge="fused", lookup="one_stage"``) on the card: two
warm-up batches, then one batch under ``torch.profiler`` with CPU and CUDA
activities. Prints the card's name and power limit, the step's wall time,
the summed device time of its kernels and the device's idle share over the
step, the device time by stage (record_function ranges), and the kernels
with the most device time.

Run from the repository root on a machine with a CUDA card:
``python3 tools/profile_torch_step.py [--fused] [trace.json]``; with a
path, the chrome trace of the profiled batch is written there.

``--sort-phases`` instead builds K3's cluster route
(``csrc/sort_cluster.cu``) with ``-DATTPC_SORT_PHASES``, sorts the
flagship's own merge rows, synthetic merge rows and convert rows with it
(each checked against ``torch.sort``), and prints per CTA the SM cycles
of each phase summed over the eight passes: load, rank, totals (the
digit totals and the first cluster barrier, with the wait for the
slowest CTA), offsets, scatter, barrier (the end-of-pass cluster barrier
and the next pass's reset) and store; mean and 90th percentile over the
CTAs; and how many clusters of each size the card holds at once.
"""

import ctypes
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
from attpc_engine_tpu_torch.detector import deposition, simulator  # noqa: E402

STAGES = {
    (simulator, "integrate_tracks"): "transport",
    (simulator, "fano_noise"): "fano_noise",
    (deposition, "_prefix_sum"): "prefix_sum",
    (deposition, "sort_rows"): "merge_sorts",
    (deposition, "merge_runs_fused"): "merge_fused",
    (simulator, "deposit_and_merge"): "deposit_and_merge",
    (simulator, "sort_rows"): "convert_sort",
}


def _ranged(name, fn):
    def wrapped(*a, **k):
        with record_function(name):
            return fn(*a, **k)
    return wrapped


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
    lib.attpc_sort_rows_cluster.argtypes = [vp, vp, i32, ctypes.c_int64,
                                            i32, i32, vp]
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
                torch.cuda.current_stream().cuda_stream)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if "--sort-phases" in args:
        print(f"card: {chip_smoke.card_line()}; K3 cluster route phases")
        sort_phases()
        return 0
    fused = "--fused" in args
    args = [a for a in args if a != "--fused"]
    print(f"card: {chip_smoke.card_line()}; configuration "
          f"{'fused' if fused else 'default'}")
    for (mod, attr), name in STAGES.items():
        setattr(mod, attr, _ranged(name, getattr(mod, attr)))
    engine = dict(merge="fused", lookup="one_stage") if fused else {}
    sim, vert, mom = chip_smoke.flagship_simulator("cuda", **engine)
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
          f"{int(meta[-2])}")
    print("device span by stage (ms; deposit_and_merge holds merge_sorts, "
          "prefix_sum and merge_fused):")
    for e in events:
        if (e.key in STAGES.values()
                and e.device_type == torch.autograd.DeviceType.CUDA):
            print(f"  {e.key:18s} {e.self_device_time_total / 1e3:9.3f}  "
                  f"(calls {e.count})")
    print("top kernels by device time (ms, launches):")
    for e in kern[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} {e.count:6d}  "
              f"{e.key[:90]}")
    print(f"kernel launches in the step: {sum(e.count for e in kern)}")
    if args:
        prof.export_chrome_trace(args[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
