# Frozen copy of attpc_engine_tpu_torch/kinematics/angle.py; the benchmark's reference imports nothing of the port.
"""CM polar-angle distributions (port of attpc_engine_tpu/kinematics/angle.py).

Uniform in cos(theta), or an arbitrary binned pdf with in-bin smearing.
Each keeps the reference-compatible scalar ``sample(rng)`` and, for the
batched pipeline, ``NOISE`` and ``transform(*noise)`` as the excitation
distributions do (``excitation.py``).
"""

from __future__ import annotations

from typing import Protocol

import numpy as np
import torch
from numpy.random import Generator

from .excitation import uniform_transform

__all__ = ["PolarDistribution", "PolarUniform", "PolarArbitrary"]


class PolarDistribution(Protocol):
    """Protocol for CM polar-angle distributions (domain [0, pi])."""

    NOISE: tuple[str, int]

    def sample(self, rng: Generator) -> float:  # type: ignore[empty-body]
        ...

    def transform(self, *noise: torch.Tensor) -> torch.Tensor:  # type: ignore[empty-body]
        ...


class PolarUniform:
    """Uniform in cos(theta) over [angle_min, angle_max] radians: the
    arccos of a uniform in [cos(angle_max), cos(angle_min))."""

    NOISE = ("uniform", 1)

    def __init__(self, angle_min: float, angle_max: float):
        self.cos_angle_min = np.cos(angle_max)
        self.cos_angle_max = np.cos(angle_min)

    def sample(self, rng: Generator) -> float:
        return float(np.arccos(rng.uniform(self.cos_angle_min, self.cos_angle_max)))

    def transform(self, u: torch.Tensor) -> torch.Tensor:
        return torch.arccos(uniform_transform(
            u, float(self.cos_angle_min), float(self.cos_angle_max)))


class PolarArbitrary:
    """Arbitrary binned polar-angle pdf with in-bin smearing: a bin's
    *lower* angle picked with the given probabilities, plus U[0, 1) times
    the bin width. The batched sampler takes two uniforms: the first picks
    the bin (``searchsorted(cdf, u1, side="left")``, clipped to the last
    bin), the second smears within it."""

    NOISE = ("uniform", 2)

    def __init__(
        self,
        angles: np.ndarray,
        probabilities: np.ndarray,
        angle_bin_width: float,
    ):
        # the reference's rng.choice(p=...) requires the probabilities to
        # sum to exactly 1 (within numpy's internal atol); silently
        # renormalizing a sum < 1 would be a hidden distribution divergence
        if abs(float(np.sum(probabilities)) - 1.0) > 1.0e-6:
            raise ValueError(
                "The sum of the probabilities passed to PolarArbitrary should be 1.0."
                f" Yours sum to {np.sum(probabilities)}"
            )
        self.angle_width = angle_bin_width
        self.probs = np.asarray(probabilities, dtype=np.float64)
        self.angles = np.asarray(angles, dtype=np.float64)
        cdf = np.cumsum(self.probs)
        self._cdf = cdf / cdf[-1]
        self._tables: dict = {}  # device -> (cdf, angles) tensors

    def sample(self, rng: Generator) -> float:
        angle = rng.choice(self.angles, p=self.probs)
        return float(angle + rng.uniform(0.0, 1.0) * self.angle_width)

    def transform(self, u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
        tables = self._tables.get(u1.device)
        if tables is None:
            tables = tuple(torch.as_tensor(a, device=u1.device)
                           for a in (self._cdf, self.angles))
            self._tables[u1.device] = tables
        cdf, angles = tables
        idx = torch.clamp(torch.searchsorted(cdf, u1), 0, len(self.angles) - 1)
        return angles[idx] + u2 * self.angle_width
