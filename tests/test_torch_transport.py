"""The port's RK4 transport (plain version of K1) against the JAX Pallas
transport kernel, run in interpret mode on the CPU.

Bounds are those the JAX package holds its own kernel to
(tests/test_transport_pallas.py): alive flags exact, positions within
1e-6 m and |dKE| within 1e-4 MeV. The CUDA kernel itself is compared with
this plain version on the card by chip_smoke.py and tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_setup
from attpc_engine_tpu.detector.transport_pallas import (
    integrate_tracks_pallas,
    integrate_tracks_pallas_chunked,
)
from attpc_engine_tpu_torch.detector import transport as T
from attpc_engine_tpu_torch.detector import transport_cuda


def _inputs(e, n_steps, seed):
    pipeline, sim = _tiny_setup(events_per_batch=e, n_time_steps=n_steps)
    vertices, momenta = pipeline.run_batch(e, key=jax.random.PRNGKey(seed))
    p3 = np.asarray(momenta)[:, sim.sim_indices, :3]
    gvs = (p3 / sim.track_masses[None, :, None]).astype(np.float32)
    pos0 = np.repeat(np.asarray(vertices, np.float32), sim.k_tracks, axis=0)
    s_idx = np.tile(np.arange(sim.k_tracks, dtype=np.int32), e)
    return sim, pos0, gvs.reshape(-1, 3), s_idx


def _species(sim):
    return T.TrackSpecies(
        mass=torch.from_numpy(np.asarray(sim.species.mass)),
        charge=torch.from_numpy(np.asarray(sim.species.charge)),
        log_ke_lo=sim.species.log_ke_lo,
        dlog_ke=sim.species.dlog_ke,
        dedx=torch.from_numpy(np.asarray(sim.species.dedx)),
    )


def _fields(sim):
    dp = sim.config.det_params
    return dict(density=float(dp.gas_target.density), bfield=float(dp.bfield),
                efield=float(dp.efield))


def _check(ref, got):
    pr, dr, ar = (np.asarray(x) for x in ref)
    pg, dg, ag = (x.numpy() for x in got)
    np.testing.assert_array_equal(ar, ag)
    live = ar
    assert live.any()
    assert np.abs(pr - pg)[live].max() < 1e-6  # meters
    assert np.abs(dr - dg)[live].max() < 1e-4  # MeV


def test_single_window_matches_pallas():
    sim, pos0, gv0, s_idx = _inputs(8, 200, 0)
    ref = integrate_tracks_pallas(
        jnp.asarray(pos0), jnp.asarray(gv0), jnp.asarray(s_idx), sim.species,
        n_steps=200, interpret=True, **_fields(sim))
    got = T.integrate_tracks(
        torch.from_numpy(pos0), torch.from_numpy(gv0),
        torch.from_numpy(s_idx), _species(sim), n_steps=200, chunk_steps=200,
        **_fields(sim))
    _check(ref, got)


def test_chunked_matches_pallas_chunked():
    sim, pos0, gv0, s_idx = _inputs(8, 200, 3)
    ref = integrate_tracks_pallas_chunked(
        jnp.asarray(pos0), jnp.asarray(gv0), jnp.asarray(s_idx), sim.species,
        n_steps=200, chunk_steps=100, interpret=True, **_fields(sim))
    got = T.integrate_tracks(
        torch.from_numpy(pos0), torch.from_numpy(gv0),
        torch.from_numpy(s_idx), _species(sim), n_steps=200, chunk_steps=100,
        **_fields(sim))
    _check(ref, got)
    # rows past the last window are zero-filled, as the TPU while loop's
    pg, dg, ag = got
    dead_after = ~ag.any(dim=1)
    assert (dg[dead_after] == 0).all()


def test_early_exit_zero_fills():
    """Every lane dead at t0 (vertex outside the chamber): no window runs."""
    sim, pos0, gv0, s_idx = _inputs(2, 100, 1)
    pos0[:, 2] = -1.0
    before = transport_cuda.launches
    p, d, a = T.integrate_tracks(
        torch.from_numpy(pos0), torch.from_numpy(gv0),
        torch.from_numpy(s_idx), _species(sim), n_steps=100, chunk_steps=50,
        **_fields(sim))
    assert not a.any() and (d == 0).all() and (p == 0).all()
    assert transport_cuda.launches == before  # CPU tensors: no kernel


def test_initial_alive_bounds_inclusive():
    mass = torch.tensor([938.0, 938.0, 938.0, 938.0])
    pos = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.3, 0.0, 0.5],
                        [0.0, 0.0, -1e-6]])
    gv = torch.full((4, 3), 0.05)
    assert T.initial_alive(pos, gv, mass).tolist() == [True, True, False,
                                                      False]


def test_constants_round_once_to_f32():
    sim, *_ = _inputs(1, 10, 0)
    k = T.Rk4Constants.make(_species(sim), dt=1e-10, **_fields(sim))
    for name in ("dt", "dt6", "dens", "clip_hi", "rho2_bound"):
        v = getattr(k, name)
        assert v == float(np.float32(v)), name
    assert k.clip_hi == float(np.float32(1024 - 1.001))


# ----------------------------------------------------------------------- #
# the windows' gate (the host's per-window live-track check, on the device)


def _bench_events(name: str, n: int):
    """``n`` events of a benchmark configuration (its own kinematics
    seed) and the port's simulator of it, on the CPU."""
    import importlib
    import json
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "port_bench"
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    inputs = importlib.import_module("pbench.inputs")
    runner = importlib.import_module("pbench.runner")
    from attpc_engine_tpu_torch.detector import DetectorSimulator

    cfg = json.loads((root / "configs" / f"{name}.json").read_text())
    events = inputs.Events(cfg, n, cfg["kinematics"]["seed"], "cpu")
    sim = DetectorSimulator(runner.port_config(cfg), events.proton_numbers,
                            events.mass_numbers, device="cpu")
    return cfg, events, sim


def _host_loop(pos0, gv0, s_idx, sim, n_steps, chunk):
    """``integrate_tracks`` as it was: one host check of the live tracks
    before each window, no window after the first that ends all dead."""
    dp = sim.config.det_params
    k = T.Rk4Constants.make(sim.species, float(dp.gas_target.density),
                            float(dp.bfield), float(dp.efield), T.DT)
    mass, q_m = T.track_constants(sim.species, s_idx)
    pos, gv = pos0.clone(), gv0.clone()
    alive = T.initial_alive(pos, gv, mass)
    b = pos.shape[0]
    out = (torch.zeros((n_steps, b, 3)), torch.zeros((n_steps, b)),
           torch.zeros((n_steps, b), dtype=torch.bool))
    for start in range(0, n_steps, chunk):
        if not bool(alive.any()):
            break
        T.rk4_window_plain(pos, gv, alive, s_idx, mass, q_m, sim.species.dedx,
                           *(o[start:start + chunk] for o in out), k,
                           torch.tensor([1, 0], dtype=torch.int32))
    return out


@pytest.mark.parametrize("name", ["c16dd_d2_184MeV", "b10_3he_chain_24MeV"])
def test_gated_windows_equal_the_host_loop(name):
    """The benchmark configurations' committed events over their physics
    window: every window is launched and each reads its gate, and the rows
    are the old host loop's bit for bit; the windows after the batch died
    stay zero."""
    cfg, events, sim = _bench_events(name, 4)
    e, k = 4, sim.k_tracks
    n_steps, chunk = (int(cfg["engine"][key])
                      for key in ("n_time_steps", "chunk_steps"))
    p3 = events.momenta[:, sim.sim_indices, :3]
    gv0 = torch.from_numpy((p3 / sim.track_masses[None, :, None])
                           .astype(np.float32).reshape(-1, 3))
    pos0 = torch.from_numpy(np.repeat(events.vertices.astype(np.float32), k,
                                      axis=0))
    s_idx = torch.arange(k, dtype=torch.int32).repeat(e)
    dp = sim.config.det_params
    got = T.integrate_tracks(pos0, gv0, s_idx, sim.species,
                             density=float(dp.gas_target.density),
                             bfield=float(dp.bfield), efield=float(dp.efield),
                             n_steps=n_steps, chunk_steps=chunk)
    ref = _host_loop(pos0, gv0, s_idx, sim, n_steps, chunk)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    alive = got[2]
    live_windows = alive.reshape(-1, chunk, e * k).any(dim=(1, 2))
    last = int(np.flatnonzero(live_windows.numpy()).max())
    # the batch died inside the window, and later windows wrote nothing
    assert last + 1 < n_steps // chunk
    dead = slice((last + 1) * chunk, None)
    assert not alive[dead].any() and (got[1][dead] == 0).all()
    assert (got[0][dead] == 0).all()


def test_a_closed_gate_writes_nothing_and_an_open_one_passes_it_on():
    """``rk4_window_plain``'s gate: gate[0] == 0 leaves the outputs and the
    carry as they were; an open gate runs the window and ORs 1 into
    gate[1] where a lane is alive at its end, else leaves it 0."""
    sim, pos0, gv0, s_idx = _inputs(2, 40, 5)
    species = _species(sim)
    kc = T.Rk4Constants.make(species, dt=T.DT, **_fields(sim))
    mass, q_m = T.track_constants(species, torch.from_numpy(s_idx))
    b = len(s_idx)

    def window(gate, dead=False):
        pos, gv = torch.from_numpy(pos0.copy()), torch.from_numpy(gv0.copy())
        alive = T.initial_alive(pos, gv, mass)
        if dead:
            alive[:] = False
        out = (torch.full((40, b, 3), 7.0), torch.full((40, b), 7.0),
               torch.ones((40, b), dtype=torch.bool))
        before = [t.clone() for t in (pos, gv, alive, *out)]
        T.rk4_window_plain(pos, gv, alive, torch.from_numpy(s_idx), mass,
                           q_m, species.dedx, *out, kc, gate)
        return before, [pos, gv, alive, *out]

    gate = torch.tensor([0, 0], dtype=torch.int32)
    before, after = window(gate)
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert gate.tolist() == [0, 0]
    gate = torch.tensor([1, 0], dtype=torch.int32)
    before, after = window(gate)
    assert after[2].any() and gate.tolist() == [1, 1]
    gate = torch.tensor([1, 0], dtype=torch.int32)
    _, after = window(gate, dead=True)
    assert not after[5].any() and gate.tolist() == [1, 0]
