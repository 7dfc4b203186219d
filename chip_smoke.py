"""Smoke run of the PyTorch port (attpc_engine_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each raises on failure, and nothing is caught):

1. The card's name and power limit (nvidia-smi); a CUDA device is required.
2. Build the three CUDA kernels from ``attpc_engine_tpu_torch/csrc`` with
   nvcc for sm_90a into the git-ignored build directory.
3. Each kernel against its plain PyTorch version on the card, at the shapes
   of the flagship batch (384 events): K1 transport (768 tracks, one
   500-step window; alive flags exact, positions within 1e-6 m, |dKE|
   within 1e-4 MeV), K2 pad lookup (393,216 points; bit-exact), K3 row
   sort ([384, 102400] and [384, 12288] int64; bit-exact). Times by CUDA
   events.
4. The main path: the flagship configuration (12C(d,p) at 120 MeV through
   D2 at 300 Torr, the default AT-TPC detector) at the default engine
   parameters with 384 events per batch, four batches of the committed
   kinematics (``attpc_engine_tpu_torch/data/smoke_kinematics.npz``)
   through ``DetectorSimulator.simulate_batch`` and the host Spyral
   assembly. h5py is not required on the card, so the HDF5 writers are not
   driven here. Every kernel must have been launched by this phase; the
   rows must be well formed; eight events run on the card must agree with
   the same eight run on the CPU through the plain versions.
5. One JSON line of kernel results, the card line, and the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, where there is no CUDA device or no
repository beside the script.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH = 384
SEED = 1


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


def flagship_simulator(device):
    from attpc_engine_tpu_torch import nuclear_map
    from attpc_engine_tpu_torch.detector import (
        Config,
        DetectorParams,
        DetectorSimulator,
        ElectronicsParams,
        EngineParams,
        PadParams,
    )
    from attpc_engine_tpu_torch.nuclear import GasTarget

    gas = GasTarget([(1, 2, 2)], 300.0, nuclear_map)
    config = Config(
        DetectorParams(length=1.0, efield=45000.0, bfield=2.85,
                       mpgd_gain=175000, gas_target=gas, diffusion=0.277,
                       fano_factor=0.2, w_value=34.0),
        ElectronicsParams(clock_freq=6.25, amp_gain=900, shaping_time=1000,
                          micromegas_edge=10, windows_edge=560,
                          adc_threshold=40),
        PadParams(),
    )
    data = np.load(REPO / "attpc_engine_tpu_torch" / "data"
                   / "smoke_kinematics.npz")
    sim = DetectorSimulator(config, data["proton_numbers"],
                            data["mass_numbers"],
                            engine=EngineParams(events_per_batch=BATCH),
                            device=device)
    return sim, data["vertices"], data["momenta"]


def check_transport(sim, vertices, momenta, card: str) -> dict:
    """K1 against rk4_window_plain: 768 tracks, one 500-step window."""
    from attpc_engine_tpu_torch.detector import transport as T
    from attpc_engine_tpu_torch.detector import transport_cuda

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
    ms = cuda_ms(lambda: run(transport_cuda.rk4_window_cuda), 10)
    plain_ms = cuda_ms(lambda: run(T.rk4_window_plain), 1)
    print(f"K1 transport: B={b} T={steps}: alive exact, max |dpos| {dpos:.3g} m,"
          f" max |ddke| {ddke:.3g} MeV; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms"
          f" [{card}]")
    return {"max_abs_err": dpos, "ms": ms, "plain_ms": plain_ms}


def check_deposit(sim, card: str) -> dict:
    """K2 against packed_key_lookup_plain at P = 384 * 1024 points."""
    from attpc_engine_tpu_torch.detector import deposit_cuda

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
    args = (ix, iy, tbr, sim.pad_table, 1, 2**31 - 1)
    got = deposit_cuda.packed_key_lookup_cuda(*args)
    ref = deposit_cuda.packed_key_lookup_plain(*args)
    n_bad = int((got != ref).sum())
    if n_bad:
        raise AssertionError(f"K2: {n_bad} of {ref.numel()} keys differ")
    ms = cuda_ms(lambda: deposit_cuda.packed_key_lookup_cuda(*args), 20)
    plain_ms = cuda_ms(lambda: deposit_cuda.packed_key_lookup_plain(*args), 5)
    print(f"K2 pad lookup: P={p} ({ref.numel()} keys): bit-exact; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms [{card}]")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms}


def check_sort(width: int, convert: bool, card: str) -> dict:
    """K3 against torch.sort on rows like the merge's or the convert's."""
    from attpc_engine_tpu_torch.detector import sort_cuda

    g = torch.Generator(device="cuda").manual_seed(SEED + width)
    shape = (BATCH, width)
    if convert:
        # keep bit, 511 - tb, pad, label, f32 charge bits; dropped rows max
        x = torch.randint(0, 2**62, shape, generator=g, device="cuda")
        keep = torch.rand(shape, generator=g, device="cuda") < 0.5
        x = torch.where(keep, x | (-2**63), 2**63 - 1)
    else:
        # pack64(key, charge): keys with long equal runs, sentinel lanes
        key = torch.randint(0, 6000, shape, generator=g, device="cuda") << 1
        dead = torch.rand(shape, generator=g, device="cuda") < 0.4
        key = torch.where(dead, 2**31 - 1, key)
        q = torch.rand(shape, generator=g, device="cuda") * 100
        q = torch.where(dead, 0.0, q)
        x = (key << 32) | (q.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
    got = sort_cuda.sort_rows_cuda(x)
    ref = sort_cuda.sort_rows_plain(x)
    n_bad = int((got != ref).sum())
    if n_bad:
        raise AssertionError(f"K3 at {shape}: {n_bad} elements differ")
    ms = cuda_ms(lambda: sort_cuda.sort_rows_cuda(x), 10)
    plain_ms = cuda_ms(lambda: sort_cuda.sort_rows_plain(x), 10)
    print(f"K3 row sort {list(shape)}: bit-exact; kernel {ms:.3f} ms, "
          f"plain (torch.sort) {plain_ms:.3f} ms [{card}]")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms}


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


def main_path(sim, vertices, momenta, card: str) -> dict:
    """Four batches through simulate_batch + host assembly; the device step
    of batches 2-4 is timed (dispatch until the metadata reached the
    host)."""
    from attpc_engine_tpu_torch.detector import (
        deposit_cuda,
        sort_cuda,
        transport_cuda,
    )
    from attpc_engine_tpu_torch.detector.simulator import overflow_kinds

    wrappers = (transport_cuda, deposit_cuda, sort_cuda)
    for w in wrappers:
        w.launches = 0
    step_s, asm_s, rows = [], [], 0
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
            raise AssertionError(f"overflow at default budgets: {kinds}")
        counts = meta[:len(v)]
        total = check_rows(sim, out, len(v))
        spyral, labels = sim.assemble_spyral_ordered(
            out["packed"][:total].cpu().numpy(), counts,
            np.arange(start, start + len(v)), SEED)
        t2 = time.perf_counter()
        if spyral.shape != (total, 8) or not np.isfinite(spyral).all():
            raise AssertionError("malformed Spyral rows")
        step_s.append(t1 - t0)
        asm_s.append(t2 - t1)
        rows += total
    launches = {w.__name__.rsplit(".", 1)[1]: w.launches for w in wrappers}
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    timed = step_s[1:]  # the first batch is warm-up
    ms = 1e3 * float(np.mean(timed))
    print(f"main path: {len(step_s)} batches of {BATCH} events, {rows} rows; "
          f"device step {[round(1e3 * s, 3) for s in step_s]} ms "
          f"(first excluded: mean {ms:.3f} ms/batch, "
          f"{BATCH / np.mean(timed):.1f} events/s); host assembly "
          f"{1e3 * float(np.mean(asm_s[1:])):.3f} ms/batch; launches {launches}"
          f" [{card}]")
    return {"launches": launches, "ms_per_batch": ms,
            "events_per_s": BATCH / float(np.mean(timed))}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from attpc_engine_tpu_torch import kernels

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels.build()
    kernels.library()
    print(f"kernels built in {kernels.build_seconds():.1f} s")

    sim, vertices, momenta = flagship_simulator("cuda")
    res = {
        "transport": check_transport(sim, vertices[:BATCH], momenta[:BATCH],
                                     card),
        "deposit": check_deposit(sim, card),
        "sort_rows": check_sort(sim.engine.point_budget * 100, False, card),
    }
    convert = check_sort(sim.engine.uniq_budget, True, card)
    path = main_path(sim, vertices, momenta, card)
    check_against_cpu(sim, vertices, momenta)

    sources = {
        "transport": ("attpc_engine_tpu_torch/csrc/transport.cu",
                      "attpc_engine_tpu/detector/transport_pallas.py:45",
                      "transport_cuda"),
        "deposit": ("attpc_engine_tpu_torch/csrc/deposit.cu",
                    "attpc_engine_tpu/detector/deposit_pallas.py:210",
                    "deposit_cuda"),
        "sort_rows": ("attpc_engine_tpu_torch/csrc/sort_rows.cu",
                      "attpc_engine_tpu/detector/sort_pallas.py:366",
                      "sort_cuda"),
    }
    rows = []
    for name, (src, replaces, wrapper) in sources.items():
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": path["launches"][wrapper],
               **res[name]}
        if name == "sort_rows":
            row["convert_ms"] = convert["ms"]
            row["convert_plain_ms"] = convert["plain_ms"]
        rows.append(row)
    print(json.dumps({"kernels": rows,
                      "main_path_ms_per_batch": path["ms_per_batch"],
                      "events_per_s": path["events_per_s"]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
