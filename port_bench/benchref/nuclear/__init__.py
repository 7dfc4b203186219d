# Frozen copy of attpc_engine_tpu_torch/nuclear/__init__.py; the benchmark's reference imports nothing of the port.
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
