"""Charged-particle transport through the gas volume (port of
attpc_engine_tpu/detector/transport.py and transport_pallas.py).

A batch of tracks is integrated by a fixed-step f32 RK4 of the relativistic
equation of motion, fields negated as in the reference (solver.py:298-299),
with the stopping power interpolated on a uniform log-KE table. The
reference's terminal events (KE < 1e-6 MeV, z outside (0, 1) m,
rho > 0.292 m) are per-lane alive flags: dead lanes freeze and deposit
nothing.

``integrate_tracks`` runs windows of ``chunk_steps`` and stops once every
lane is dead, as ``integrate_tracks_pallas_chunked`` does, but decides it
on the device: it launches every window with no host sync, and each window
reads a gate word that the window before it wrote, "some lane was alive at
this window's start", and returns at once where it is 0 (so that the step
can be captured as one CUDA graph). Each window is one call of
``transport_cuda.rk4_window``: the K1 kernel for CUDA tensors,
``rk4_window_plain`` (below) for CPU tensors, which keeps the same gate.
Both follow the arithmetic of the Pallas kernel
(transport_pallas.py:45-170) operation by operation,
including its index clipping for the table lookup (n_tab - 1.001, then
floor), which differs from transport.py:79 (n_tab - 1.000001, truncation).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import C, E_CHARGE, MEV_2_JOULE, MEV_2_KG

__all__ = [
    "TrackSpecies",
    "Rk4Constants",
    "initial_alive",
    "rk4_window_plain",
    "integrate_tracks",
    "KE_LIMIT",
    "DT",
]

KE_LIMIT = 1e-6  # MeV, reference solver.py:14
DT = 1e-10  # s, reference solver.py:16
_Z_FORWARD_BOUND = 1.0  # m, reference quirk solver.py:160
_RHO_BOUND = 0.292  # m, reference quirk solver.py:240


@dataclass(frozen=True)
class TrackSpecies:
    """Per-species constants: mass [S] (MeV) and charge [S] (proton
    numbers) f32, the uniform log-KE grid (log_ke_lo, dlog_ke) and the
    [S, n_tab] f32 mass stopping-power tables (MeV cm^2/g)."""

    mass: torch.Tensor
    charge: torch.Tensor
    log_ke_lo: float
    dlog_ke: float
    dedx: torch.Tensor


@dataclass(frozen=True)
class Rk4Constants:
    """The f32 scalars of the RK4 window, each rounded to f32 once from its
    f64 expression, as the Pallas kernel pins them (transport_pallas.py:70-81,
    105-107)."""

    dt: float
    half_dt: float
    dt6: float
    dens: float
    c: float
    log_lo: float
    dlog: float
    clip_hi: float
    ke_lim: float
    z_bound: float
    rho2_bound: float
    tiny: float
    b_neg: float
    e_neg: float
    mev2kg: float

    @classmethod
    def make(cls, species: TrackSpecies, density: float, bfield: float,
             efield: float, dt: float) -> "Rk4Constants":
        f = lambda x: float(np.float32(x))  # noqa: E731
        return cls(
            dt=f(dt), half_dt=f(0.5 * dt), dt6=f(dt / 6.0),
            dens=f(MEV_2_JOULE * density * 100.0), c=f(C),
            log_lo=f(species.log_ke_lo), dlog=f(species.dlog_ke),
            clip_hi=f(species.dedx.shape[1] - 1.001), ke_lim=f(KE_LIMIT),
            z_bound=f(_Z_FORWARD_BOUND), rho2_bound=f(_RHO_BOUND * _RHO_BOUND),
            tiny=f(1e-30), b_neg=f(-bfield), e_neg=f(-efield),
            mev2kg=f(MEV_2_KG),
        )


def _kinetic(mass: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """KE = m gv^2 / (1 + gamma) for g [B, 3]."""
    gv2 = g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2]
    return mass * gv2 / (1.0 + torch.sqrt(1.0 + gv2))


def initial_alive(pos0: torch.Tensor, gv0: torch.Tensor,
                  mass: torch.Tensor) -> torch.Tensor:
    """Alive flags [B] at t0 for pos0, gv0 [B, 3] f32: the bounds are
    inclusive at the start (scipy's terminal events fire only on sign
    changes after it), as transport_pallas.py:247-259."""
    ke0 = _kinetic(mass, gv0)
    rho0 = torch.sqrt(pos0[:, 0] * pos0[:, 0] + pos0[:, 1] * pos0[:, 1])
    return (
        (ke0 > np.float32(KE_LIMIT))
        & (pos0[:, 2] >= 0.0)
        & (pos0[:, 2] <= np.float32(_Z_FORWARD_BOUND))
        & (rho0 < np.float32(_RHO_BOUND))
    )


def rk4_window_plain(
    pos: torch.Tensor,
    gv: torch.Tensor,
    alive: torch.Tensor,
    s_idx: torch.Tensor,
    mass: torch.Tensor,
    q_m: torch.Tensor,
    dedx: torch.Tensor,
    out_pos: torch.Tensor,
    out_dke: torch.Tensor,
    out_alive: torch.Tensor,
    k: Rk4Constants,
    gate: torch.Tensor,
) -> None:
    """Plain PyTorch version of the K1 kernel: one window of
    ``out_dke.shape[0]`` steps.

    pos, gv [B, 3] f32 and alive [B] bool are the carry, updated in place to
    the state at the window's end; out_pos [T, B, 3], out_dke [T, B] f32 and
    out_alive [T, B] bool receive the per-step position, |dKE| and alive
    flag. s_idx [B] int, mass and q_m [B] f32, dedx [S, N] f32. gate [2]
    int32, the kernel's: the window runs only where gate[0] is not 0 (read
    on the host here), writing nothing otherwise, and then ORs 1 into
    gate[1] where a lane is alive at its end.
    """
    if not bool(gate[0]):
        return
    n_tab = dedx.shape[1]
    table = dedx.reshape(-1)
    base = s_idx.long() * n_tab
    mass_kg = mass * k.mev2kg

    def interp_dedx(ke):
        posf = (torch.log(torch.clamp(ke, min=k.tiny)) - k.log_lo) / k.dlog
        posf = torch.clamp(posf, 0.0, k.clip_hi)
        i0 = torch.floor(posf)
        frac = posf - i0
        idx = base + i0.long()
        return table[idx] * (1.0 - frac) + table[idx + 1] * frac

    def rhs(g):
        gx, gy, gz = g[:, 0], g[:, 1], g[:, 2]
        gv2 = gx * gx + gy * gy + gz * gz
        gv_mag = torch.sqrt(torch.clamp(gv2, min=k.tiny))
        gamma = torch.sqrt(1.0 + gv2)
        beta = gv_mag / gamma
        ke = mass * gv2 / (1.0 + gamma)
        u = g / gv_mag[:, None]
        velo = u * (beta * k.c)[:, None]
        decel = interp_dedx(ke) * k.dens / mass_kg
        dgv = torch.stack(
            [
                (q_m * velo[:, 1] * k.b_neg - decel * u[:, 0]) / k.c,
                (-q_m * velo[:, 0] * k.b_neg - decel * u[:, 1]) / k.c,
                (q_m * k.e_neg - decel * u[:, 2]) / k.c,
            ],
            dim=1,
        )
        return velo, dgv

    p, g, live = pos.clone(), gv.clone(), alive.clone()
    ke_prev = _kinetic(mass, g)
    for t in range(out_dke.shape[0]):
        k1p, k1g = rhs(g)
        k2p, k2g = rhs(g + k.half_dt * k1g)
        k3p, k3g = rhs(g + k.half_dt * k2g)
        k4p, k4g = rhs(g + k.dt * k3g)
        p_n = p + k.dt6 * (k1p + 2.0 * k2p + 2.0 * k3p + k4p)
        g_n = g + k.dt6 * (k1g + 2.0 * k2g + 2.0 * k3g + k4g)
        p = torch.where(live[:, None], p_n, p)
        g = torch.where(live[:, None], g_n, g)
        ke_n = _kinetic(mass, g)
        rho2 = p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]
        live = (
            live
            & (ke_n > k.ke_lim)
            & (p[:, 2] > 0.0)
            & (p[:, 2] < k.z_bound)
            & (rho2 < k.rho2_bound)
        )
        out_pos[t] = p
        out_dke[t] = torch.where(live, torch.abs(ke_prev - ke_n), 0.0)
        out_alive[t] = live
        ke_prev = ke_n
    pos.copy_(p)
    gv.copy_(g)
    alive.copy_(live)
    gate[1] |= live.any().to(gate.dtype)


def track_constants(
    species: TrackSpecies, s_idx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-track mass [B] and charge over mass q_m [B] (f32, as
    transport_pallas.py:303-304)."""
    mass = species.mass[s_idx]
    q_m = species.charge[s_idx] * E_CHARGE / (mass * MEV_2_KG)
    return mass, q_m


def integrate_tracks(
    init_pos: torch.Tensor,
    init_gv: torch.Tensor,
    s_idx: torch.Tensor,
    species: TrackSpecies,
    density: float,
    bfield: float,
    efield: float,
    dt: float = DT,
    n_steps: int = 10000,
    chunk_steps: int = 500,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integrate a batch of tracks, emitting per-step energy deposits.

    init_pos, init_gv [B, 3] f32 (m, gamma*beta); s_idx [B] int species
    index; density (g/cm^3), bfield (T), efield (V/m).

    Returns (positions [n_steps, B, 3] f32, dke [n_steps, B] f32 |dKE| in
    MeV, alive [n_steps, B] bool). Windows of ``chunk_steps`` run until
    every lane is dead; the rows after that stay zero. Every window is
    launched, with no host sync: the gate words [n_steps / chunk_steps +
    1] int32 on the device (word 0 whether a lane is alive at t0, word w + 1
    written by window w) skip the windows after the last live one.
    """
    from .transport_cuda import rk4_window

    if n_steps % chunk_steps != 0:
        raise ValueError("n_steps must be divisible by chunk_steps")
    dev = init_pos.device
    b = init_pos.shape[0]
    k = Rk4Constants.make(species, density, bfield, efield, dt)
    s_idx = s_idx.to(device=dev, dtype=torch.int32)
    mass, q_m = track_constants(species, s_idx)
    pos = init_pos.to(torch.float32).contiguous().clone()
    gv = init_gv.to(torch.float32).contiguous().clone()
    alive = initial_alive(pos, gv, mass)
    positions = torch.zeros((n_steps, b, 3), dtype=torch.float32, device=dev)
    dkes = torch.zeros((n_steps, b), dtype=torch.float32, device=dev)
    alives = torch.zeros((n_steps, b), dtype=torch.bool, device=dev)
    # the TPU while-loop's condition, on the device
    gates = torch.zeros(n_steps // chunk_steps + 1, dtype=torch.int32,
                        device=dev)
    gates[0] = alive.any()
    for w, start in enumerate(range(0, n_steps, chunk_steps)):
        stop = start + chunk_steps
        rk4_window(pos, gv, alive, s_idx, mass, q_m, species.dedx,
                   positions[start:stop], dkes[start:stop],
                   alives[start:stop], k, gates[w:w + 2])
    return positions, dkes, alives
