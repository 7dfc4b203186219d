"""Kinematics stage on PyTorch: batched f64 reaction/decay phase-space
sampling (port of ``attpc_engine_tpu.kinematics``, with the same exports,
plus ``run_kinematics``, the batch loop of ``run_kinematics_pipeline``).
"""

from .reaction import Reaction, Decay, FourVector, reaction_batch, decay_batch
from .excitation import (
    ExcitationDistribution,
    ExcitationGaussian,
    ExcitationUniform,
    ExcitationBreitWigner,
)
from .angle import PolarDistribution, PolarUniform, PolarArbitrary
from .pipeline import (
    KinematicsPipeline,
    KinematicsTargetMaterial,
    PipelineError,
    run_kinematics_pipeline,
    run_kinematics,
    Sample,
)

__all__ = [
    "Reaction",
    "Decay",
    "FourVector",
    "reaction_batch",
    "decay_batch",
    "ExcitationDistribution",
    "ExcitationGaussian",
    "ExcitationUniform",
    "ExcitationBreitWigner",
    "PolarDistribution",
    "PolarUniform",
    "PolarArbitrary",
    "KinematicsPipeline",
    "KinematicsTargetMaterial",
    "PipelineError",
    "run_kinematics_pipeline",
    "run_kinematics",
    "Sample",
]
