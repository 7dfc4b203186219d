"""Utilities: phase timing, trace capture and run records."""

from .manifest import write_run_manifest
from .profiling import PhaseTimes, phase_timer, trace_to

__all__ = ["PhaseTimes", "phase_timer", "trace_to", "write_run_manifest"]
