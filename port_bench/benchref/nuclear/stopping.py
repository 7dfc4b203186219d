# Frozen copy of attpc_engine_tpu_torch/nuclear/stopping.py; the benchmark's reference imports nothing of the port. The native generator is left out:
# the numpy version below is the one it is held to bit for bit.
"""Charged-particle stopping power in matter.

Replaces the role of the pycatima (CATIMA C++) dependency of the reference
engine: the reference calls ``GasTarget.get_dedx`` inside its ODE right-hand
side on every integrator step
(upstream attpc_engine/detector/solver.py:65) and
``get_energy_loss`` per sampled event
(upstream attpc_engine/kinematics/pipeline.py:256-263).

TPU-first architecture: stopping power is *never* evaluated pointwise in the
hot path. This module generates dense log-spaced dE/dx and range tables per
(projectile, material) once on the host; the device integrator does a
single ``jnp.interp`` gather per step.

Physics model (self-contained, no external data libraries):

- Bethe-Bloch mass electronic stopping power with effective projectile
  charge: protons use z_eff = 1 - exp(-300 beta) (the Northcliffe form
  over-suppresses the proton peak region; calibrated against the PSTAR
  water anchors below), helium uses the Ziegler-Chu effective-charge
  fraction fit (the ICRU-49 parameterization in ln(E/A [keV/u])), heavier
  ions use Northcliffe-Barkas z_eff = z (1 - exp(-130 beta z^(-2/3))),
- Barkas-Berger analytic shell correction C(eta, I) subtracted per
  constituent (each element's OWN mean excitation energy, even under a
  compound I override — shell structure is per element), clamped at its
  eta^2 = 0.02 validity edge with a smooth eta^2/(eta^2 + 3e-4) fade
  toward low velocity where the term would diverge,
- mean excitation energies I from an embedded ICRU-37-style element table,
- below the Bethe curve's own Bragg peak the electronic stopping follows
  the experimentally-shaped Andersen-Ziegler power law S ~ E^0.45 anchored
  at the peak, with the parameter-free Lindhard-Scharff velocity-
  proportional stopping as a floor at very low E,
- ZBL universal nuclear stopping added (matters below ~100 keV/u — the
  reference's pycatima dedx includes nuclear stopping too),
- Bragg additivity over compound constituents.

Measured accuracy against published anchors (see tests/test_nuclear.py):
protons in water within +-3.5% of PSTAR at 0.1/0.3/1/10/100 MeV (0.1% at
10/100 MeV), CSDA ranges at 10/100 MeV within 0.5%; alpha CSDA range in
air at 5.49 MeV (Am-241) +3.8% of ASTAR; 12C in D2 within 1% of the
fully-stripped Bethe limit at 10 MeV/u (the flagship bench regime) and 4%
at 5 MeV/u. Custom tables can still be loaded for exact CATIMA parity
(``GasTarget.set_custom_dedx``; ``tools/make_catima_tables.py`` generates
them on any machine with pycatima installed — not available in this
image, so the in-house model above is the shipped default).
"""

from __future__ import annotations

import numpy as np

__all__ = ["mass_stopping_power", "build_dedx_table", "build_range_table"]

# Constants
_K = 0.307075  # MeV cm^2 / mol  (4 pi N_A r_e^2 m_e c^2)
_ME_C2 = 0.51099895  # MeV
_MP_U = 931.49410242  # MeV per u

# Mean excitation energies I (eV), ICRU-37-style, Z = 1..54 embedded;
# beyond the table the Bloch estimate I = 10 Z eV is used.
_I_EV = {
    1: 19.2, 2: 41.8, 3: 40.0, 4: 63.7, 5: 76.0, 6: 78.0, 7: 82.0, 8: 95.0,
    9: 115.0, 10: 137.0, 11: 149.0, 12: 156.0, 13: 166.0, 14: 173.0,
    15: 173.0, 16: 180.0, 17: 174.0, 18: 188.0, 19: 190.0, 20: 191.0,
    21: 216.0, 22: 233.0, 23: 245.0, 24: 257.0, 25: 272.0, 26: 286.0,
    27: 297.0, 28: 311.0, 29: 322.0, 30: 330.0, 31: 334.0, 32: 350.0,
    33: 347.0, 34: 348.0, 35: 343.0, 36: 352.0, 37: 363.0, 38: 366.0,
    39: 379.0, 40: 393.0, 41: 417.0, 42: 424.0, 43: 428.0, 44: 441.0,
    45: 449.0, 46: 470.0, 47: 470.0, 48: 469.0, 49: 488.0, 50: 488.0,
    51: 487.0, 52: 485.0, 53: 491.0, 54: 482.0,
}


def _mean_excitation_ev(z: int) -> float:
    return _I_EV.get(z, 10.0 * z)


def _he_gamma2(e_kev_u: np.ndarray) -> np.ndarray:
    """Ziegler-Chu helium effective-charge fraction squared,
    (z_eff/2)^2 = 1 - exp(-sum c_i ln(E)^i), E in keV/u (the ICRU-49
    helium parameterization). Clamped to E >= 1 keV/u (fit domain edge)."""
    x = np.log(np.clip(e_kev_u, 1.0, None))
    # Horner form, mirrored exactly in native/stopping.cpp for bit parity
    s = 0.2865 + x * (
        0.1266 + x * (-0.001429 + x * (0.02402 + x * (-0.01135 + x * 0.001475)))
    )
    return 1.0 - np.exp(-np.clip(s, 0.0, 50.0))


def _shell_correction(eta2: np.ndarray, i_ev: float) -> np.ndarray:
    """Barkas-Berger analytic shell correction C(eta, I), I in eV,
    eta = beta * gamma.

    The closed form is valid down to eta^2 ~ 0.02 (it diverges negative
    below); we evaluate it clamped at that edge and fade it out toward low
    velocity with eta^2 / (eta^2 + 3e-4), which tracks the known rise and
    fall of C around the sub-MeV/u region without the divergence. The
    correction enters the Bethe L as -C/Z per constituent."""
    e2 = np.maximum(eta2, 0.02)
    c_i2 = (
        0.422377 / e2 + 0.0304043 / (e2 * e2) - 0.00038106 / (e2 * e2 * e2)
    ) * 1e-6 * (i_ev * i_ev)
    c_i3 = (
        3.850190 / e2 - 0.1667989 / (e2 * e2) + 0.00157955 / (e2 * e2 * e2)
    ) * 1e-9 * (i_ev * i_ev * i_ev)
    fade = np.where(eta2 < 0.02, eta2 / (eta2 + 3e-4), 1.0)
    return (c_i2 + c_i3) * fade


def _bethe_mass_stopping(
    z_proj: int,
    mass_mev: float,
    ke_mev: np.ndarray,
    z_t: np.ndarray,
    a_t: np.ndarray,
    w_t: np.ndarray,
    i_override_ev: float | None = None,
) -> np.ndarray:
    """Bethe-Bloch electronic mass stopping power, MeV cm^2/g.

    Parameters
    ----------
    z_proj, mass_mev: projectile charge and rest mass.
    ke_mev: [n] kinetic energies.
    z_t, a_t, w_t: target constituent Z, A, and mass fractions.

    Negative/invalid log arguments are clipped to zero (handled by the
    low-energy continuation in :func:`build_dedx_table`).
    """
    ke = np.asarray(ke_mev, dtype=np.float64)
    gamma = 1.0 + ke / mass_mev
    beta2 = 1.0 - 1.0 / gamma**2
    beta2 = np.clip(beta2, 1e-30, None)
    beta = np.sqrt(beta2)
    eta2 = beta2 * gamma**2

    # Effective projectile charge: Ziegler-Chu fraction for helium,
    # Northcliffe-Barkas for z >= 3; the weaker proton form keeps the
    # PSTAR peak region (see module docstring)
    if z_proj == 1:
        z_eff2 = (1.0 - np.exp(-300.0 * beta)) ** 2
    elif z_proj == 2:
        a_u = mass_mev / _MP_U
        z_eff2 = 4.0 * _he_gamma2(ke * 1e3 / a_u)
    else:
        z_eff2 = (
            z_proj * (1.0 - np.exp(-130.0 * beta * z_proj ** (-2.0 / 3.0)))
        ) ** 2

    s = np.zeros_like(ke)
    for z, a, w in zip(z_t, a_t, w_t):
        i_ev = i_override_ev if i_override_ev else _mean_excitation_ev(int(z))
        i_mev = i_ev * 1e-6
        arg = 2.0 * _ME_C2 * beta2 * gamma**2 / i_mev
        # shell correction uses the ELEMENT's own I even under a compound
        # override: the override captures phase/binding effects in the
        # logarithm; shell structure is per element
        c_shell = _shell_correction(eta2, _mean_excitation_ev(int(z)))
        log_term = np.log(np.clip(arg, 1.0, None)) - beta2 - c_shell / z
        s += w * _K * (z / a) * (z_eff2 / beta2) * np.clip(log_term, 0.0, None)
    return s


def _lindhard_scharff(
    z_proj: int,
    a_proj: float,
    ke_mev: np.ndarray,
    z_t: np.ndarray,
    a_t: np.ndarray,
    w_t: np.ndarray,
) -> np.ndarray:
    """Lindhard-Scharff velocity-proportional electronic stopping
    (parameter-free low-energy limit), MeV cm^2/g."""
    e_kev = np.clip(np.asarray(ke_mev, dtype=np.float64), 0.0, None) * 1e3
    s = np.zeros_like(e_kev)
    for z, a, w in zip(z_t, a_t, w_t):
        s_units = (
            1.212
            * z_proj ** (7.0 / 6.0)
            * z
            / (z_proj ** (2.0 / 3.0) + z ** (2.0 / 3.0)) ** 1.5
            * np.sqrt(e_kev / a_proj)
        )  # eV / (1e15 atoms/cm^2)
        s += w * s_units * (1e-21 * 6.02214076e23 / a)
    return s


def _zbl_nuclear(
    z_proj: int,
    a_proj: float,
    ke_mev: np.ndarray,
    z_t: np.ndarray,
    a_t: np.ndarray,
    w_t: np.ndarray,
) -> np.ndarray:
    """ZBL universal nuclear mass stopping power, MeV cm^2/g."""
    e_kev = np.clip(np.asarray(ke_mev, dtype=np.float64), 0.0, None) * 1e3
    s = np.zeros_like(e_kev)
    for z, a, w in zip(z_t, a_t, w_t):
        dz = z_proj**0.23 + z**0.23
        eps = np.clip(
            32.53 * a * e_kev / (z_proj * z * (a_proj + a) * dz), 1e-12, None
        )
        sn_red = np.where(
            eps <= 30.0,
            np.log1p(1.1383 * eps)
            / (2.0 * (eps + 0.01321 * eps**0.21226 + 0.19593 * np.sqrt(eps))),
            np.log(eps) / (2.0 * eps),
        )
        s_units = 8.462 * z_proj * z * a_proj / ((a_proj + a) * dz) * sn_red
        s += w * s_units * (1e-21 * 6.02214076e23 / a)
    return s


def mass_stopping_power(
    z_proj: int,
    mass_mev: float,
    ke_mev: np.ndarray,
    constituents: list[tuple[int, int, float]],
    i_override_ev: float | None = None,
) -> np.ndarray:
    """Mass stopping power (MeV cm^2/g) with low-energy continuation.

    Uses the native C++ generator (attpc_engine_tpu.native) when available —
    the slot pycatima fills in the reference's stack — falling back to the
    pure-numpy implementation below (identical physics model).

    Parameters
    ----------
    z_proj: int
        Projectile charge number.
    mass_mev: float
        Projectile rest mass in MeV.
    ke_mev: np.ndarray
        Kinetic energies in MeV (any shape).
    constituents: list[(Z, A, mass_fraction)]
        Target composition by mass fraction.
    i_override_ev: float | None
        Compound mean excitation energy (eV) replacing the constituent
        Bragg-additivity I-values (e.g. liquid water I = 75 eV).
    """
    ke = np.atleast_1d(np.asarray(ke_mev, dtype=np.float64))
    z_t = np.array([c[0] for c in constituents], dtype=np.float64)
    a_t = np.array([c[1] for c in constituents], dtype=np.float64)
    w_t = np.array([c[2] for c in constituents], dtype=np.float64)

    # Locate the Bethe-curve Bragg peak on a dense scan (per projectile),
    # then continue with the Andersen-Ziegler-shaped E^0.45 power law below
    # it, floored by Lindhard-Scharff at very low E.
    a_proj = max(mass_mev / _MP_U, 0.5)
    e_scan = np.geomspace(1e-4 * a_proj, 1e4 * a_proj, 1024)
    s_scan = _bethe_mass_stopping(
        z_proj, mass_mev, e_scan, z_t, a_t, w_t, i_override_ev
    )
    i_peak = int(np.argmax(s_scan))
    e_peak = e_scan[i_peak]
    s_peak = s_scan[i_peak]

    s = _bethe_mass_stopping(z_proj, mass_mev, ke, z_t, a_t, w_t, i_override_ev)
    low = ke < e_peak
    with np.errstate(invalid="ignore"):
        s_tail = s_peak * np.clip(ke, 0.0, None) ** 0.45 / e_peak**0.45
    s = np.where(low, s_tail, s)
    s_ls = _lindhard_scharff(z_proj, a_proj, ke, z_t, a_t, w_t)
    s = np.where(low & (s_ls > s), s_ls, s)
    s = s + _zbl_nuclear(z_proj, a_proj, ke, z_t, a_t, w_t)
    return s.reshape(np.shape(ke_mev))


def build_dedx_table(
    z_proj: int,
    mass_mev: float,
    constituents: list[tuple[int, int, float]],
    ke_min: float = 1e-6,
    ke_max: float = 20000.0,
    n_points: int = 1024,
) -> tuple[np.ndarray, np.ndarray]:
    """Log-spaced dE/dx table for device-side interpolation.

    Returns
    -------
    (log_ke, dedx)
        ``log_ke``: [n] natural log of KE (MeV), uniformly spaced.
        ``dedx``: [n] mass stopping power (MeV cm^2/g).
    """
    ke = np.geomspace(ke_min, ke_max, n_points)
    dedx = mass_stopping_power(z_proj, mass_mev, ke, constituents)
    return np.log(ke), dedx


def build_range_table(
    log_ke: np.ndarray, dedx: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """CSDA range table R(E) = int dE/S(E) from a dE/dx table.

    Returns (log_ke, range_gcm2) on the same grid; range in g/cm^2.
    Integration by trapezoid in linear E with the table's resolution.
    """
    ke = np.exp(log_ke)
    inv_s = 1.0 / np.clip(dedx, 1e-12, None)
    r = np.zeros_like(ke)
    r[1:] = np.cumsum(0.5 * (inv_s[1:] + inv_s[:-1]) * np.diff(ke))
    return log_ke, r
