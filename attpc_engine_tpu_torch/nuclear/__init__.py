# Copied from attpc_engine_tpu/nuclear/__init__.py; the port imports no jax, so it holds its own copy.
"""Nuclear data and materials layer (L0): masses, gas targets, stopping power."""

from .masses import NuclearDataMap, NucleusData
from .target import GasTarget, SolidTarget, load_target

__all__ = [
    "NuclearDataMap",
    "NucleusData",
    "GasTarget",
    "SolidTarget",
    "load_target",
]
