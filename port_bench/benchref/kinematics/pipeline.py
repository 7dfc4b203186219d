# Frozen copy of attpc_engine_tpu_torch/kinematics/pipeline.py less its batch loop and file
# writer; the benchmark's reference imports nothing of the port.
"""The batched kinematics sampling pipeline (port of
attpc_engine_tpu/kinematics/pipeline.py).

A batch of events is sampled at once on a device, the card unless the
caller asks for the CPU:

- every lane draws a full set of phase-space parameters,
- the whole reaction + decay chain is evaluated with batched f64
  four-vector math (``reaction.py``),
- lanes whose excitations are energetically disallowed draw again: each
  draw updates only the lanes not yet accepted, which keeps the
  reference's conditional distributions and its "exactly N valid events"
  guarantee; the loop stops when every lane is accepted or after
  ``event_sample_limit`` draws (the first included), and lanes still
  invalid then raise ``PipelineError`` on the host (one host sync a draw).

The draws. The JAX package draws from threefry keys; the port draws from
the counter-based Philox4x32-10 of ``detector.deposition``, so its values
are its own and match the JAX package's by distribution. Draw ``d``
(0 for the first) of phase-space parameter ``j`` for the event with global
id ``g`` under ``seed`` is one Philox block with key (seed low word, g mod
2^32) and counter (d, 0, KINEMATICS_STREAM + j, seed high word), four
32-bit words. ``j`` is the parameter's index in the JAX package's key
order: 0-2 the vertex rho, theta and z, then for step ``s`` (0 the
reaction, then the decays) 3 + 3s its excitation, 4 + 3s its polar angle
and 5 + 3s its azimuth. A uniform in [0, 1) is 53 bits of two words,
``((w0 >> 5) * 2^26 + (w1 >> 6)) * 2^-53`` (words 0-1, and 2-3 for a
second uniform); a normal is Box-Muller on the two uniforms, the first
moved to (0, 1] so that its log is finite: ``sqrt(-2 log(u1)) * cos(2 pi
u2)``. So a lane's draws depend only on (seed, event id, draw,
parameter): not on the batch grid or the batch size, and the CPU and the
card produce the same integer words and the same uniforms (the
transcendental functions that follow may round differently by an ulp).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Protocol

import numpy as np
import torch

from ..philox import philox4x32
from ..ops.interp import interp
from .angle import PolarDistribution
from .excitation import ExcitationDistribution, uniform_transform
from .reaction import Decay, Reaction, decay_batch, reaction_batch

__all__ = [
    "KinematicsPipeline",
    "KinematicsTargetMaterial",
    "PipelineError",
    "Sample",
    "EventBatch",
    "CHUNK_SIZE",
    "KINEMATICS_STREAM",
]

# Reference kinematics-file chunking
CHUNK_SIZE: int = 1_000_000

# Number of z grid points for the beam energy-loss table
_ELOSS_TABLE_SIZE = 2048

# Philox counter word 2 of phase-space parameter j is KINEMATICS_STREAM + j,
# beside deposition.FANO_STREAM (0) and WIGGLE_STREAM (1)
KINEMATICS_STREAM = 2

_MASK32 = 0xFFFFFFFF
_TWO_M53 = 2.0**-53
_PI2 = 2.0 * math.pi


class _EnergyLossMaterial(Protocol):
    """What the pipeline needs from a target material: GasTarget's
    ``get_energy_loss`` signature."""

    def get_energy_loss(
        self, nucleus: Any, energy: float, distances: np.ndarray
    ) -> np.ndarray: ...


@dataclass
class KinematicsTargetMaterial:
    """Target material + vertex sampling parameters.

    Attributes
    ----------
    material: GasTarget
        The target material (anything with ``get_energy_loss``).
    z_range: tuple[float, float]
        Range of reaction vertices in meters; also the beam energy-loss span.
    rho_sigma: float
        Std-dev of the |N(0, sigma)| cylindrical-rho vertex distribution (m).
    """

    material: _EnergyLossMaterial
    z_range: tuple[float, float]
    rho_sigma: float


@dataclass
class Sample:
    """A batch of sampled pipeline parameters, f64 tensors ``[n]``."""

    beam_energy: torch.Tensor
    reaction_excitation: torch.Tensor
    reaction_theta: torch.Tensor
    reaction_phi: torch.Tensor
    vertex: torch.Tensor  # [n, 3]
    decay_excitations: list[torch.Tensor]
    decay_thetas: list[torch.Tensor]
    decay_phis: list[torch.Tensor]


class EventBatch(NamedTuple):
    """A sampled batch, on its device: ``vertices`` [n, 3] f64 m,
    ``momenta`` [n, N, 4] f64 MeV, ``accepted`` [n] bool, ``accepted_at``
    [n] int32 (the draw, 0 for the first, at which the lane was accepted;
    -1 if never) and ``draws``, the number of draws made."""

    vertices: torch.Tensor
    momenta: torch.Tensor
    accepted: torch.Tensor
    accepted_at: torch.Tensor
    draws: int


class PipelineError(Exception):
    """Pipeline error class."""


def _sample_limit_error(limit: int, n_bad: int) -> PipelineError:
    return PipelineError(
        f"Reached Sampling Limit ({limit} samples) for"
        f" {n_bad} events! You may have defined an illegal reaction!"
    )


def _uniform53(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """53 random bits of two Philox words as an int64 in [0, 2^53)."""
    return ((a >> 5) << 26) | (b >> 6)


def _new_seed() -> int:
    return int(np.random.SeedSequence().entropy) & 0xFFFFFFFFFFFFFFFF


class KinematicsPipeline:
    """The pipeline for generating kinematics data.

    Chain validation as the reference's: at least one step, the first step
    a Reaction, all later steps Decays, matching list lengths, and each
    step's parent equal to the previous step's residual.

    Parameters
    ----------
    steps: list[Reaction | Decay]
        The reaction chain.
    excitations: list[ExcitationDistribution]
        Excitation distribution per step.
    polar_dists: list[PolarDistribution]
        CM polar-angle distribution per step.
    beam_energy: float
        Accelerator beam energy in MeV.
    target_material: KinematicsTargetMaterial | None
        Optional target; if present, vertices are sampled in the gas volume
        and the beam loses energy to the vertex.
    event_sample_limit: int
        Max draws per event before raising PipelineError.
    device: torch.device | str
        Where ``run_batch`` and ``run`` sample: the card unless the caller
        asks for the CPU; a CUDA device where torch finds none raises.
    """

    def __init__(
        self,
        steps: list[Reaction | Decay],
        excitations: list[ExcitationDistribution],
        polar_dists: list[PolarDistribution],
        beam_energy: float,
        target_material: KinematicsTargetMaterial | None = None,
        event_sample_limit: int = 1000,
        device: torch.device | str = "cuda",
    ):
        self.device = torch.device(device)
        if len(steps) == 0:
            raise PipelineError("Pipeline must have at least one step (a Reaction)!")
        elif len(steps) != len(excitations):
            raise PipelineError(
                f"Pipeline must have the same number of steps (given {len(steps)})"
                f" and excitations (given {len(excitations)}!"
            )
        elif len(steps) != len(polar_dists):
            raise PipelineError(
                f"Pipeline must have the same number of steps (given {len(steps)})"
                f" and polar angle distributions (given {len(polar_dists)})!"
            )
        elif not isinstance(steps[0], Reaction):
            raise PipelineError("The first element in the pipeline must be a Reaction!")

        self.reaction: Reaction = steps[0]
        self.decays: list[Decay] = []
        self.excitations = excitations
        self.polar_dists = polar_dists
        self.event_sample_limit = event_sample_limit

        for idx in range(1, len(steps)):
            cur_step = steps[idx]
            if not isinstance(cur_step, Decay):
                raise PipelineError(
                    "All elements in the pipeline after the first element must be Decay!"
                )
            prev_step = steps[idx - 1]
            if isinstance(prev_step, Reaction):
                if (
                    prev_step.residual.isotopic_symbol
                    != cur_step.parent.isotopic_symbol
                ):
                    raise PipelineError(
                        "Broken step in pipeline! Step 0 residual does not match to Step 1 parent!"
                    )
            else:
                if (
                    prev_step.residual_2.isotopic_symbol
                    != cur_step.parent.isotopic_symbol
                ):
                    raise PipelineError(
                        f"Broken step in pipeline! Step {idx - 1} residual_2 does not"
                        f" match Step {idx} parent!"
                    )
            self.decays.append(cur_step)

        self.n_nuclei = 4 + len(self.decays) * 2
        self.beam_energy = beam_energy
        self.target_material = target_material

        # Beam energy-loss table over the vertex z span, interpolated per
        # lane on the device (ops.interp, jnp.interp's formula)
        if target_material is not None:
            z_hi = max(target_material.z_range)
            z_grid = np.linspace(0.0, max(z_hi, 1e-6), _ELOSS_TABLE_SIZE)
            eloss = target_material.material.get_energy_loss(
                self.reaction.projectile, beam_energy, z_grid
            )
            self._z_grid = np.asarray(z_grid, dtype=np.float64)
            self._eloss_grid = np.asarray(eloss, dtype=np.float64)
        else:
            self._z_grid = None
            self._eloss_grid = None
        self._tables: dict = {}  # device -> (z grid, eloss grid) tensors

        # the noise of each phase-space parameter j (see the module
        # docstring): (kind, count), None for the vertex without a target
        vertex = (target_material is not None)
        self._noise_kinds: list[tuple[str, int] | None] = [
            ("normal", 1) if vertex else None,
            ("uniform", 1) if vertex else None,
            ("uniform", 1) if vertex else None,
        ]
        for exc, polar in zip(excitations, polar_dists):
            self._noise_kinds += [exc.NOISE, polar.NOISE, ("uniform", 1)]

    def __str__(self) -> str:
        chain = f"{self.reaction}"
        for decay in self.decays:
            chain += f", {str(decay)}"
        return chain

    # ------------------------------------------------------------------ #
    # sampling internals                                                   #
    # ------------------------------------------------------------------ #

    def _draw_noise(self, draw: int, seed: int, event_start: int, n: int,
                    device: torch.device) -> list[tuple[torch.Tensor, ...] | None]:
        """The noise of draw ``draw`` for events [event_start, event_start
        + n): per phase-space parameter j, a tuple of its ``count`` f64
        tensors [n] (None where the parameter is unused), from its Philox
        stream (module docstring). All parameters' blocks are one Philox
        evaluation over [parameters, n]. Tests replace this method to feed
        the JAX package's draws."""
        used = [j for j, k in enumerate(self._noise_kinds) if k is not None]
        i64 = dict(dtype=torch.int64, device=device)
        seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        shape = (len(used), n)
        ev = (event_start + torch.arange(n, **i64)) & _MASK32
        counter = [
            torch.full(shape, draw, **i64),
            torch.zeros(shape, **i64),
            (KINEMATICS_STREAM + torch.tensor(used, **i64))[:, None].expand(shape),
            torch.full(shape, seed >> 32, **i64),
        ]
        key = [torch.full(shape, seed & _MASK32, **i64),
               ev[None, :].expand(shape)]
        w = philox4x32(counter, key)
        bits_a = _uniform53(w[0], w[1])
        bits_b = _uniform53(w[2], w[3])
        noise: list[tuple[torch.Tensor, ...] | None] = [None] * len(
            self._noise_kinds)
        for row, j in enumerate(used):
            kind, count = self._noise_kinds[j]
            if kind == "normal":
                u1 = (bits_a[row] + 1).to(torch.float64) * _TWO_M53
                u2 = bits_b[row].to(torch.float64) * _TWO_M53
                noise[j] = (torch.sqrt(-2.0 * torch.log(u1))
                            * torch.cos(_PI2 * u2),)
            else:
                us = (bits_a[row], bits_b[row])[:count]
                noise[j] = tuple(u.to(torch.float64) * _TWO_M53 for u in us)
        return noise

    def _eloss_tables(self, device: torch.device):
        tables = self._tables.get(device)
        if tables is None:
            tables = tuple(torch.as_tensor(a, device=device)
                           for a in (self._z_grid, self._eloss_grid))
            self._tables[device] = tables
        return tables

    def _sample(self, noise: list, n: int, device: torch.device) -> Sample:
        """One full set of batched phase-space parameters from ``noise``
        (``_draw_noise``'s layout)."""
        n_decays = len(self.decays)
        if self.target_material is not None:
            rho = torch.abs(noise[0][0] * self.target_material.rho_sigma)
            theta = uniform_transform(noise[1][0], 0.0, _PI2)
            z = uniform_transform(noise[2][0], *map(
                float, self.target_material.z_range))
            vertex = torch.stack([rho * torch.cos(theta),
                                  rho * torch.sin(theta), z], dim=-1)
            eloss = interp(z, *self._eloss_tables(device))
            beam_energy = self.beam_energy - eloss
        else:
            vertex = torch.zeros((n, 3), dtype=torch.float64, device=device)
            beam_energy = torch.full((n,), float(self.beam_energy),
                                     dtype=torch.float64, device=device)

        def step(s: int):
            return (self.excitations[s].transform(*noise[3 + 3 * s]),
                    self.polar_dists[s].transform(*noise[4 + 3 * s]),
                    uniform_transform(noise[5 + 3 * s][0], 0.0, _PI2))

        ex, theta_cm, phi = step(0)
        decays = [step(i + 1) for i in range(n_decays)]
        return Sample(
            beam_energy=beam_energy,
            reaction_excitation=ex,
            reaction_theta=theta_cm,
            reaction_phi=phi,
            vertex=vertex,
            decay_excitations=[d[0] for d in decays],
            decay_thetas=[d[1] for d in decays],
            decay_phis=[d[2] for d in decays],
        )

    def _compute_chain(self, sample: Sample) -> tuple[torch.Tensor, torch.Tensor]:
        """Evaluate the full reaction chain for a batch of samples.

        Returns (momenta [n, n_nuclei, 4], allowed [n])."""
        vectors, allowed = reaction_batch(
            self.reaction.masses,
            sample.beam_energy,
            sample.reaction_theta,
            sample.reaction_phi,
            sample.reaction_excitation,
        )
        rows = [vectors[:, 0], vectors[:, 1], vectors[:, 2], vectors[:, 3]]
        prev_resid = vectors[:, 3]
        for i, decay in enumerate(self.decays):
            dvec, ok = decay_batch(
                decay.masses,
                prev_resid,
                sample.decay_thetas[i],
                sample.decay_phis[i],
                sample.decay_excitations[i],
            )
            allowed = allowed & ok
            rows.append(dvec[:, 0])
            rows.append(dvec[:, 1])
            prev_resid = dvec[:, 1]
        return torch.stack(rows, dim=1), allowed

    def sample_events(self, n: int, seed: int, event_start: int = 0,
                      device: torch.device | str | None = None) -> EventBatch:
        """Events [event_start, event_start + n) under ``seed`` by the
        masked resampling loop, on ``device`` (the pipeline's by default).
        Raises nothing on lanes left unaccepted: see ``accepted``."""
        device = torch.device(device if device is not None else self.device)

        def draw(d: int):
            sample = self._sample(
                self._draw_noise(d, seed, event_start, n, device), n, device)
            momenta, allowed = self._compute_chain(sample)
            return sample.vertex, momenta, allowed

        vertices, momenta, accepted = draw(0)
        accepted_at = torch.where(accepted, 0, -1).to(torch.int32)
        draws = 1
        while draws < self.event_sample_limit and not bool(accepted.all()):
            v_new, m_new, ok = draw(draws)
            newly = ok & ~accepted
            vertices = torch.where(newly[:, None], v_new, vertices)
            momenta = torch.where(newly[:, None, None], m_new, momenta)
            accepted_at = torch.where(newly, draws, accepted_at)
            accepted = accepted | ok
            draws += 1
        return EventBatch(vertices, momenta, accepted, accepted_at, draws)

    # ------------------------------------------------------------------ #
    # public API                                                           #
    # ------------------------------------------------------------------ #

    def run_batch(self, n: int, seed: int | None = None,
                  event_start: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Sample ``n`` valid events, events [event_start, event_start + n)
        of ``seed`` (a fresh seed from the OS if None: not reproducible, as
        the reference's default_rng), on the pipeline's device.

        Returns
        -------
        (vertices, momenta)
            ``vertices``: [n, 3] float64 meters. ``momenta``: [n, N, 4]
            float64 MeV with rows ordered (target, projectile, ejectile,
            residual, d1_res1, d1_res2, ...) as the reference file schema.

        Raises
        ------
        PipelineError
            If any lane failed to produce a valid event within
            ``event_sample_limit`` samples.
        """
        if seed is None:
            seed = _new_seed()
        batch = self.sample_events(n, seed, event_start)
        accepted = batch.accepted.cpu().numpy()
        if not accepted.all():
            raise _sample_limit_error(self.event_sample_limit,
                                      int((~accepted).sum()))
        return batch.vertices.cpu().numpy(), batch.momenta.cpu().numpy()

    def run(self, seed: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Single-event compatibility API. Returns (vertex [3], result [N, 4])."""
        vertices, momenta = self.run_batch(1, seed=seed)
        return vertices[0], momenta[0]

    def check_excitations_allowed(
        self, projectile_energy: float, excitations: list[float]
    ) -> bool:
        """Total chain Q-value check."""
        q_value = (
            (self.reaction.projectile.mass + projectile_energy)
            + self.reaction.target.mass
            - (
                self.reaction.ejectile.mass
                + self.reaction.residual.mass
                + excitations[0]
            )
        )
        for idx, decay in enumerate(self.decays):
            q_value += -1.0 * (
                decay.residual_1.mass + decay.residual_2.mass + excitations[idx + 1]
            )
        return q_value >= 0.0

    def get_proton_numbers(self) -> np.ndarray:
        """Proton number per nucleus row."""
        z = np.empty(self.n_nuclei, dtype=int)
        z[0] = self.reaction.target.Z
        z[1] = self.reaction.projectile.Z
        z[2] = self.reaction.ejectile.Z
        z[3] = self.reaction.residual.Z
        for idx, decay in enumerate(self.decays):
            offset = idx * 2 + 4
            z[offset] = decay.residual_1.Z
            z[offset + 1] = decay.residual_2.Z
        return z

    def get_mass_numbers(self) -> np.ndarray:
        """Mass number per nucleus row."""
        a = np.empty(self.n_nuclei, dtype=int)
        a[0] = self.reaction.target.A
        a[1] = self.reaction.projectile.A
        a[2] = self.reaction.ejectile.A
        a[3] = self.reaction.residual.A
        for idx, decay in enumerate(self.decays):
            offset = idx * 2 + 4
            a[offset] = decay.residual_1.A
            a[offset + 1] = decay.residual_2.A
        return a
