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
