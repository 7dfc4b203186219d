"""Per-phase wall timing (copy of attpc_engine_tpu/utils/profiling.py, less its jax.profiler helper, with a lock in add)."""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field


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
