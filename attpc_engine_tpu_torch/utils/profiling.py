"""Per-phase wall timing and trace capture (port of
attpc_engine_tpu/utils/profiling.py: a lock in ``PhaseTimes.add``, and
``trace_to`` on ``torch.profiler`` in place of ``jax.profiler``)."""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class PhaseTimes:
    """Accumulated wall-clock seconds per named phase; ``add`` may be
    called from several threads."""

    seconds: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def add(self, name: str, dt: float) -> None:
        with self._lock:
            self.seconds[name] += dt
            self.counts[name] += 1

    def summary(self) -> str:
        total = sum(self.seconds.values())
        lines = [f"total {total:.2f}s"]
        for name, s in sorted(self.seconds.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name}: {s:.2f}s ({self.counts[name]}x)")
        return "\n".join(lines)


@contextmanager
def phase_timer(times: PhaseTimes, name: str):
    """Accumulate the wall time of a block into ``times``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        times.add(name, time.perf_counter() - t0)


@contextmanager
def trace_to(log_dir: str | Path | None):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (no-op if None): CPU activity, and CUDA activity where torch finds a
    CUDA device. The trace is a Chrome trace JSON file,
    ``trace_<pid>.json``, that TensorBoard and Perfetto open."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(log_dir / f"trace_{os.getpid()}.json"))
