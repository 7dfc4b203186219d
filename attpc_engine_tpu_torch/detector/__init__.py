"""Detector stage on PyTorch: transport, diffusion, merge, Spyral output.

Exports mirror ``attpc_engine_tpu.detector`` for the ported part.
"""

from .parameters import Config, DetectorParams, ElectronicsParams, PadParams
from .response import apply_response, get_response
from .simulator import DetectorSimulator, EngineParams, run_simulation
from .writer import SpyralWriter, SpyralWriterProc

__all__ = [
    "Config",
    "DetectorParams",
    "ElectronicsParams",
    "PadParams",
    "DetectorSimulator",
    "EngineParams",
    "run_simulation",
    "SpyralWriter",
    "SpyralWriterProc",
    "get_response",
    "apply_response",
]
