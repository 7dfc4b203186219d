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
"""

import sys
import time
from pathlib import Path

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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
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
