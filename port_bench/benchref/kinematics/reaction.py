# Frozen copy of attpc_engine_tpu_torch/kinematics/reaction.py; the benchmark's reference imports nothing of the port.
"""Two-body reaction and decay kinematics (port of
attpc_engine_tpu/kinematics/reaction.py).

The physics lives in batched functions of f64 tensors of phase-space
parameters (``[n]``, parent four-vectors ``[n, 4]``); ``Reaction`` and
``Decay`` hold the species (the residual inferred by Z/A conservation) and
offer the reference's scalar ``calculate``.

All kinematics runs in f64: MeV-scale precision against ~GeV masses is
unattainable in f32 (catastrophic cancellation). The CM energy is the
cancellation-free invariant form e_cm^2 = mt^2 + mp^2 + 2 mt (mp + T). The
expressions keep the JAX package's order, its ``maximum(..., 0)`` guards and
the ``b2 > 0`` safe divide of the boost, so that a disallowed lane stays
finite; the caller masks it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import nuclear_map
from ..nuclear.masses import NucleusData

__all__ = ["Reaction", "Decay", "FourVector", "reaction_batch", "decay_batch"]


# Copied from attpc_engine_tpu/kinematics/reaction.py:27-57.
class FourVector:
    """A minimal momentum 4-vector for the scalar convenience API.

    Mirrors the pieces of the ``vector`` package API the reference exposes to
    users (``.px .py .pz .E .M``).
    """

    __slots__ = ("px", "py", "pz", "E")

    def __init__(self, px: float, py: float, pz: float, E: float):
        self.px = float(px)
        self.py = float(py)
        self.pz = float(pz)
        self.E = float(E)

    @property
    def M(self) -> float:
        """Invariant mass."""
        p2 = self.px**2 + self.py**2 + self.pz**2
        return float(np.sqrt(max(self.E**2 - p2, 0.0)))

    @property
    def momentum(self) -> float:
        return float(np.sqrt(self.px**2 + self.py**2 + self.pz**2))

    def as_array(self) -> np.ndarray:
        return np.array([self.px, self.py, self.pz, self.E])

    def __repr__(self) -> str:
        return f"FourVector(px={self.px}, py={self.py}, pz={self.pz}, E={self.E})"


def _boost_from_cm(p_cm: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """Boost ``[..., 4]`` four-vectors (px, py, pz, E) from the CM frame of
    ``parent`` (``[..., 4]``, lab frame) to the lab frame."""
    pe = parent[..., 3:4]
    pvec = parent[..., :3]
    m = torch.sqrt(torch.clamp(pe**2 - torch.sum(pvec**2, dim=-1, keepdim=True),
                               min=0.0))
    beta = pvec / pe
    gamma = pe / m
    b2 = torch.sum(beta**2, dim=-1, keepdim=True)
    e_cm = p_cm[..., 3:4]
    v_cm = p_cm[..., :3]
    bp = torch.sum(v_cm * beta, dim=-1, keepdim=True)
    # safe divide for a parent at rest (b2 = 0): the coefficient is unused
    moving = b2 > 0.0
    coef = torch.where(moving, (gamma - 1.0) / torch.where(moving, b2, 1.0),
                       0.0)
    v_lab = v_cm + beta * (coef * bp + gamma * e_cm)
    e_lab = gamma * (e_cm + bp)
    return torch.cat([v_lab, e_lab], dim=-1)


def _masses(masses) -> list[float]:
    return [float(m) for m in masses]


def reaction_batch(
    masses,
    projectile_energy: torch.Tensor,
    ejectile_polar: torch.Tensor,
    ejectile_azimuthal: torch.Tensor,
    residual_excitation: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched two-body reaction a(b,c)d kinematics on f64 tensors.

    ``masses``: the four rest masses (target, projectile, ejectile,
    residual) in MeV; the other arguments are ``[n]``. Returns
    (``[n, 4, 4]`` lab four-vectors, rows target, projectile, ejectile,
    residual, columns px, py, pz, E; ``[n]`` bool, energetically allowed).
    Disallowed lanes hold finite values that the caller must mask.
    """
    mt, mp, me, mr = _masses(masses)
    t = projectile_energy

    pz_proj = torch.sqrt(t * (t + 2.0 * mp))
    e_cm = torch.sqrt(mt * mt + mp * mp + 2.0 * mt * (mp + t))
    mr_ex = mr + residual_excitation
    allowed = (me + mr_ex) < e_cm

    e_eject_cm = (me * me - mr_ex * mr_ex + e_cm * e_cm) / (2.0 * e_cm)
    p_eject = torch.sqrt(torch.clamp(e_eject_cm * e_eject_cm - me * me,
                                     min=0.0))

    sin_th = torch.sin(ejectile_polar)
    eject_cm = torch.stack(
        [
            p_eject * sin_th * torch.cos(ejectile_azimuthal),
            p_eject * sin_th * torch.sin(ejectile_azimuthal),
            p_eject * torch.cos(ejectile_polar),
            e_eject_cm,
        ],
        dim=-1,
    )

    zeros = torch.zeros_like(t)
    target_vec = torch.stack([zeros, zeros, zeros, torch.full_like(t, mt)],
                             dim=-1)
    proj_vec = torch.stack([zeros, zeros, pz_proj, t + mp], dim=-1)
    parent = target_vec + proj_vec

    eject_vec = _boost_from_cm(eject_cm, parent)
    resid_vec = parent - eject_vec

    vectors = torch.stack([target_vec, proj_vec, eject_vec, resid_vec], dim=1)
    return vectors, allowed


def decay_batch(
    masses,
    parent_vector: torch.Tensor,
    residual_1_polar: torch.Tensor,
    residual_1_azimuthal: torch.Tensor,
    residual_2_excitation: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched two-body decay a -> b + c kinematics on f64 tensors.

    ``masses``: the rest masses (residual_1, residual_2) in MeV;
    ``parent_vector`` ``[n, 4]`` lab four-vectors; the angles (in the parent
    CM frame) and the excitation ``[n]``. Returns (``[n, 2, 4]`` lab
    four-vectors of residual_1 and residual_2; ``[n]`` bool, q_value > 0).
    """
    m1, m2 = _masses(masses)
    pe = parent_vector[..., 3]
    p2 = torch.sum(parent_vector[..., :3] ** 2, dim=-1)
    parent_mass = torch.sqrt(torch.clamp(pe * pe - p2, min=0.0))

    m2_ex = m2 + residual_2_excitation
    allowed = (parent_mass - (m1 + m2_ex)) > 0.0

    e1_cm = ((m1 * m1 - m2_ex * m2_ex + parent_mass * parent_mass)
             / (2.0 * parent_mass))
    p1_cm = torch.sqrt(torch.clamp(e1_cm * e1_cm - m1 * m1, min=0.0))

    sin_th = torch.sin(residual_1_polar)
    r1_cm = torch.stack(
        [
            p1_cm * sin_th * torch.cos(residual_1_azimuthal),
            p1_cm * sin_th * torch.sin(residual_1_azimuthal),
            p1_cm * torch.cos(residual_1_polar),
            e1_cm,
        ],
        dim=-1,
    )
    r1_vec = _boost_from_cm(r1_cm, parent_vector)
    r2_vec = parent_vector - r1_vec
    return torch.stack([r1_vec, r2_vec], dim=1), allowed


def _scalars(device: torch.device, *values: float) -> list[torch.Tensor]:
    return [torch.tensor([v], dtype=torch.float64, device=device)
            for v in values]


class Reaction:
    """A two-body reaction a(b,c)d: the target, projectile and ejectile
    (``NucleusData``); the residual is inferred by Z/A conservation."""

    def __init__(
        self,
        target: NucleusData,
        projectile: NucleusData,
        ejectile: NucleusData,
    ):
        self.target = target
        self.projectile = projectile
        self.ejectile = ejectile
        resid_z = projectile.Z + target.Z - ejectile.Z
        resid_a = projectile.A + target.A - ejectile.A
        if resid_z < 0:
            raise ValueError(
                "Reaction calculated a residual Z (proton number) < 0, illegal reaction!"
            )
        if resid_a < 0:
            raise ValueError(
                "Reaction calculated a residual A (mass number) < 0, illegal reaction!"
            )
        self.residual = nuclear_map.get_data(resid_z, resid_a)
        self.reaction_symbol = (
            f"{self.target}({self.projectile},{self.ejectile}){self.residual}"
        )

    def __str__(self) -> str:
        return self.reaction_symbol

    @property
    def masses(self) -> np.ndarray:
        """``[4]`` f64 rest masses (target, projectile, ejectile, residual)."""
        return np.array(
            [
                self.target.mass,
                self.projectile.mass,
                self.ejectile.mass,
                self.residual.mass,
            ],
            dtype=np.float64,
        )

    def is_excitation_allowed(
        self, projectile_energy: float, residual_excitation: float
    ) -> bool:
        """Scalar energetics check."""
        mt, mp = self.target.mass, self.projectile.mass
        e_cm = np.sqrt(mt * mt + mp * mp + 2.0 * mt * (mp + projectile_energy))
        return bool(
            (self.ejectile.mass + self.residual.mass + residual_excitation) < e_cm
        )

    def calculate(
        self,
        projectile_energy: float,
        ejectile_polar: float,
        ejectile_azimuthal: float,
        residual_excitation: float,
        device: torch.device | str = "cuda",
    ) -> list[FourVector]:
        """Lab four-vectors (target, projectile, ejectile, residual) of one
        event, computed on ``device`` (the card unless the caller asks for
        the CPU). Raises ``ValueError`` below the kinematic threshold."""
        device = torch.device(device)
        q_value = (
            self.target.mass
            + self.projectile.mass
            - (self.ejectile.mass + self.residual.mass + residual_excitation)
        )
        e_threshold = (
            -q_value
            * (self.ejectile.mass + self.residual.mass)
            / (self.ejectile.mass + self.residual.mass - self.projectile.mass)
        )
        if projectile_energy < e_threshold:
            raise ValueError("Beam energy below kinematic threshold!")

        vectors, _ = reaction_batch(
            self.masses,
            *_scalars(device, projectile_energy, ejectile_polar,
                      ejectile_azimuthal, residual_excitation),
        )
        return [FourVector(*row) for row in vectors[0].cpu().numpy()]


class Decay:
    """A two-body decay a -> b + c: the parent and residual_1
    (``NucleusData``); residual_2 is inferred by Z/A conservation."""

    def __init__(self, parent: NucleusData, residual_1: NucleusData):
        self.parent = parent
        self.residual_1 = residual_1
        resid_2_z = parent.Z - residual_1.Z
        resid_2_a = parent.A - residual_1.A
        if resid_2_z < 0:
            raise ValueError(
                "Decay calculated a residual2 Z (proton number) < 0, illegal decay!"
            )
        if resid_2_a < 0:
            raise ValueError(
                "Decay calculated a residual2 A (mass number) < 0, illegal decay!"
            )
        self.residual_2 = nuclear_map.get_data(resid_2_z, resid_2_a)
        self.decay_symbol = f"{self.parent}->{self.residual_1}+{self.residual_2}"

    def __str__(self) -> str:
        return self.decay_symbol

    @property
    def masses(self) -> np.ndarray:
        """``[2]`` f64 rest masses (residual_1, residual_2)."""
        return np.array(
            [self.residual_1.mass, self.residual_2.mass], dtype=np.float64
        )

    def is_excitation_allowed(
        self, parent_vector: FourVector, residual_2_excitation: float
    ) -> bool:
        """Scalar energetics check."""
        q = parent_vector.M - (
            self.residual_1.mass + self.residual_2.mass + residual_2_excitation
        )
        return bool(q > 0.0)

    def calculate(
        self,
        parent_vector: FourVector,
        residual_1_polar: float,
        residual_1_azimuthal: float,
        residual_2_excitation: float,
        device: torch.device | str = "cuda",
    ) -> list[FourVector]:
        """(parent, residual_1, residual_2) lab four-vectors of one decay,
        computed on ``device`` (the card unless the caller asks for the
        CPU). Raises ``ValueError`` where the parent cannot decay."""
        device = torch.device(device)
        q = parent_vector.M - (
            self.residual_1.mass + self.residual_2.mass + residual_2_excitation
        )
        if q < 0.0:
            raise ValueError("Parent doesn't have enough energy to decay!")
        parent = torch.tensor(parent_vector.as_array()[None, :],
                              dtype=torch.float64, device=device)
        vectors, _ = decay_batch(
            self.masses, parent,
            *_scalars(device, residual_1_polar, residual_1_azimuthal,
                      residual_2_excitation),
        )
        arr = vectors[0].cpu().numpy()
        return [parent_vector, FourVector(*arr[0]), FourVector(*arr[1])]
