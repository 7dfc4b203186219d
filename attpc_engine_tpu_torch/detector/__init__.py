"""Detector stage on PyTorch: transport, diffusion, merge, Spyral output.

Exports mirror ``attpc_engine_tpu.detector``.
"""

from .parameters import Config, DetectorParams, ElectronicsParams, PadParams
from .response import apply_response, get_response
from .simulator import DetectorSimulator, EngineParams, run_simulation, simulate
from .writer import (
    SimulationWriter,
    SpyralWriter,
    SpyralWriterProc,
    convert_to_spyral,
)

__all__ = [
    "Config",
    "DetectorParams",
    "ElectronicsParams",
    "PadParams",
    "DetectorSimulator",
    "EngineParams",
    "run_simulation",
    "simulate",
    "SimulationWriter",
    "SpyralWriter",
    "SpyralWriterProc",
    "convert_to_spyral",
    "get_response",
    "apply_response",
]
