"""One detector run split over several processes, one a GPU (port of
attpc_engine_tpu/parallel, less its in-process device mesh)."""

from .multihost import process_plan, resolve_process, run_simulation_multihost

__all__ = ["process_plan", "resolve_process", "run_simulation_multihost"]
