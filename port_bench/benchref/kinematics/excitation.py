# Frozen copy of attpc_engine_tpu_torch/kinematics/excitation.py; the benchmark's reference imports nothing of the port.
"""Excitation-energy distributions (port of
attpc_engine_tpu/kinematics/excitation.py).

A Protocol plus Gaussian, Uniform and relativistic Breit-Wigner
distributions. Each keeps the reference-compatible scalar ``sample(rng)``
(numpy) and splits the batched sampler in two: ``NOISE`` names the noise a
batch needs, ``(kind, count)`` with kind ``"uniform"`` (f64 in [0, 1)) or
``"normal"`` (standard normal), and ``transform(*noise)`` maps ``count``
tensors ``[n]`` of that noise to the batch. The pipeline draws the noise
from its Philox streams; a test can feed the JAX package's draws instead.

The relativistic Breit-Wigner is sampled by inverse-CDF lookup against a
table built once at construction from the analytic pdf
    f(x; rho) = k / ((x^2 - rho^2)^2 + rho^2),   x >= 0
(scipy.stats.rel_breitwigner's distribution, which the reference uses).
"""

from __future__ import annotations

from typing import Protocol

import numpy as np
import torch
from numpy.random import Generator

from ..ops.interp import interp

__all__ = [
    "ExcitationDistribution",
    "ExcitationGaussian",
    "ExcitationUniform",
    "ExcitationBreitWigner",
    "uniform_transform",
]


def uniform_transform(u: torch.Tensor, minval: float,
                      maxval: float) -> torch.Tensor:
    """U[0, 1) noise to [minval, maxval), in ``jax.random.uniform``'s order:
    ``max(minval, u * (maxval - minval) + minval)``."""
    return torch.clamp(u * (maxval - minval) + minval, min=minval)


class ExcitationDistribution(Protocol):
    """Protocol for excited-state energy distributions."""

    NOISE: tuple[str, int]

    def sample(self, rng: Generator) -> float:  # type: ignore[empty-body]
        """Sample one value with a numpy Generator (scalar API)."""
        ...

    def transform(self, *noise: torch.Tensor) -> torch.Tensor:  # type: ignore[empty-body]
        """A batch from ``NOISE`` (used by the batched pipeline)."""
        ...


class ExcitationGaussian:
    """Gaussian excitation: ``centroid`` (MeV) and FWHM ``width`` (MeV),
    sigma = FWHM / 2.355 as in the reference."""

    NOISE = ("normal", 1)

    def __init__(self, centroid: float = 0.0, width: float = 0.0):
        self.centroid = centroid
        self.width = width  # FWHM
        self.sigma = self.width / 2.355

    def sample(self, rng: Generator) -> float:
        return rng.normal(self.centroid, self.sigma)

    def transform(self, z: torch.Tensor) -> torch.Tensor:
        return self.centroid + self.sigma * z


class ExcitationUniform:
    """Uniform excitation over [min_value, max_value] (MeV)."""

    NOISE = ("uniform", 1)

    def __init__(self, min_value: float = 0.0, max_value: float = 0.0):
        self.min_value = min_value
        self.max_value = max_value

    def sample(self, rng: Generator) -> float:
        return rng.uniform(self.min_value, self.max_value)

    def transform(self, u: torch.Tensor) -> torch.Tensor:
        return uniform_transform(u, self.min_value, self.max_value)


class ExcitationBreitWigner:
    """Relativistic Breit-Wigner excitation.

    Parameters
    ----------
    rest_mass: float
        Rest mass of the excited nucleus in MeV.
    centroid: float
        State centroid in MeV.
    width: float
        State width (Gamma) in MeV.

    As the reference's use of scipy's ``rel_breitwigner``: the *total
    energy* (rest_mass + excitation) is drawn from rel-BW with shape
    ``rho = (rest_mass + centroid) / width`` and scale ``width``; the
    excitation is that minus the rest mass. Sampled by inverse-CDF
    interpolation over a dense table built once at construction.
    """

    NOISE = ("uniform", 1)
    _TABLE_SIZE = 16384

    def __init__(self, rest_mass: float, centroid: float, width: float):
        self.rest_mass = rest_mass
        self.centroid = centroid
        self.width = width
        self.rho = (rest_mass + centroid) / width
        self._build_table()
        self._tables: dict = {}  # device -> (cdf, x) tensors

    # Copied from attpc_engine_tpu/kinematics/excitation.py:117-137.
    def _build_table(self) -> None:
        rho = self.rho
        # Support: x >= 0 in units of the scale (width). Near the peak the
        # pdf is approximately Lorentzian in (x - rho) with half-width 1/2,
        # so a tan-warped grid x = rho + 0.5 tan(theta) places points with
        # roughly CDF-proportional density and captures the far tails
        # (a finite linear window would clip ~0.5% of the mass and bias the
        # sampled quantiles).
        eps = 2e-4
        theta = np.linspace(-np.pi / 2 + eps, np.pi / 2 - eps, self._TABLE_SIZE)
        x = rho + 0.5 * np.tan(theta)
        x = np.unique(np.clip(x, 0.0, None))
        pdf = 1.0 / ((x**2 - rho**2) ** 2 + rho**2)
        cdf = np.concatenate(
            [[0.0], np.cumsum((pdf[1:] + pdf[:-1]) * 0.5 * np.diff(x))]
        )
        cdf /= cdf[-1]
        # Deduplicate flat regions so interpolation is well-posed
        keep = np.concatenate([[True], np.diff(cdf) > 0])
        self._cdf = cdf[keep]
        self._x = x[keep]

    def sample(self, rng: Generator) -> float:
        u = rng.uniform(0.0, 1.0)
        x = float(np.interp(u, self._cdf, self._x))
        total_energy = x * self.width
        return total_energy - self.rest_mass

    def transform(self, u: torch.Tensor) -> torch.Tensor:
        tables = self._tables.get(u.device)
        if tables is None:
            tables = tuple(torch.as_tensor(a, device=u.device)
                           for a in (self._cdf, self._x))
            self._tables[u.device] = tables
        return interp(u, *tables) * self.width - self.rest_mass
