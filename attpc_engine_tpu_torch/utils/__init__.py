"""Utilities: phase timing and run records."""

from .manifest import write_run_manifest
from .profiling import PhaseTimes, phase_timer

__all__ = ["PhaseTimes", "phase_timer", "write_run_manifest"]
