"""The ``--trace 1`` run's device trace: ``torch.profiler`` over a steady
run of batches, read back from its Chrome trace.

``Tracer`` starts the profiler when the reader is asked for batch
``skip`` and stops it when it is asked for batch ``skip + active`` (or when
the window ends), synchronising the card at both ends, so that the trace
holds every device operation of those batches' dispatches and nothing of
the others'. While it records, ``record_dispatch`` keeps the shapes of
each step it sees, for the rooflines' bytes.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver")


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces,
    template arguments or argument list."""
    name = name.replace("(anonymous namespace)::", "").strip()
    for cut in ("(", "<"):
        if cut in name:
            name = name[:name.index(cut)]
    name = name.strip()
    return name[len("void "):] if name.startswith("void ") else name


def symbol(name: str) -> str:
    """A kernel's own name, without its namespaces."""
    return short_name(name).split("::")[-1]


@dataclass
class Trace:
    """Device and host events of the traced batches, in microseconds."""

    batches: int
    kernels: list  # (name, start, duration)
    device: list  # (name, start, duration): kernels, copies, sets
    host: list  # (name, start, duration)
    dispatches: list = field(default_factory=list)  # (E, point, uniq)

    @classmethod
    def from_chrome(cls, data: dict, batches: int, dispatches: list):
        kernels, device, host = [], [], []
        for ev in data.get("traceEvents", []):
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            item = (ev.get("name", ""), float(ev["ts"]), float(ev["dur"]))
            cat = ev.get("cat", "")
            if cat in DEVICE_CATEGORIES:
                device.append(item)
                if cat == "kernel":
                    kernels.append(item)
            elif cat in HOST_CATEGORIES:
                host.append(item)
        return cls(batches, kernels, device, host, list(dispatches))

    def span(self) -> tuple[float, float]:
        """The traced window: from the first event to the end of the last."""
        events = self.device + self.host
        if not events:
            return (0.0, 0.0)
        return (min(s for _, s, _ in events), max(s + d for _, s, d in events))

    def busy(self) -> list[tuple[float, float]]:
        lo, hi = self.span()
        return clip(union((s, s + d) for _, s, d in self.device), lo, hi)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def window_s(self) -> float:
        lo, hi = self.span()
        return (hi - lo) * 1e-6

    def kernel_us(self, names=None) -> float:
        """Summed device time of the kernels, or of those whose short name
        is in ``names``."""
        return sum(d for n, _, d in self.kernels
                   if names is None or symbol(n) in names)

    def gaps(self) -> list[tuple[float, float]]:
        lo, hi = self.span()
        out, at = [], lo
        for a, b in self.busy():
            if a > at:
                out.append((at, a))
            at = max(at, b)
        if hi > at:
            out.append((at, hi))
        return out

    def breakdown(self, top: int = 10, longest: int = 256) -> dict:
        """The device operations that took most time, and the ``longest``
        idle gaps summed by the innermost host operation under each gap's
        middle, in seconds."""
        import numpy as np

        ops: dict[str, float] = {}
        for n, _, d in self.device:
            key = short_name(n) if n else "unnamed"
            ops[key] = ops.get(key, 0.0) + d * 1e-6
        names = [h[0] for h in self.host]
        starts = np.array([h[1] for h in self.host], dtype=np.float64)
        durs = np.array([h[2] for h in self.host], dtype=np.float64)
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:longest]
        idle: dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inside = np.nonzero((starts <= mid) & (starts + durs >= mid))[0]
            key = (names[inside[np.argmin(durs[inside])]] if len(inside)
                   else "host outside any traced operation")
            idle[key] = idle.get(key, 0.0) + (b - a) * 1e-6
        by = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                              key=lambda kv: -kv[1])[:top]
        return {"device_ops": by(ops), "idle_gaps": by(idle)}


class Tracer:
    """The profiler over batches [skip, skip + active) of a window whose
    reader calls ``on_read(start)`` for each batch of ``per_batch``
    events. ``own_s`` is the wall time the tracer itself spent inside
    ``on_read`` (the syncs and the profiler's start and stop), which the
    driver books under its ``read`` phase."""

    def __init__(self, skip: int, active: int, per_batch: int):
        self.skip, self.active, self.per_batch = skip, active, per_batch
        self.prof = None
        self.recording = False
        self.first = self.last = None
        self.dispatches: list = []
        self.own_s = 0.0

    def on_read(self, start: int) -> None:
        batch = start // self.per_batch
        t0 = time.perf_counter()
        if batch == self.skip and self.prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.recording, self.first = True, batch
        elif batch == self.skip + self.active:
            self.stop(batch)
        self.own_s += time.perf_counter() - t0

    def record_dispatch(self, e: int, point_budget: int,
                        uniq_budget: int) -> None:
        if self.recording:
            self.dispatches.append((e, point_budget, uniq_budget))

    def stop(self, batch: int) -> None:
        """Stop recording before batch ``batch`` is read, or at the end of
        the window."""
        if not self.recording:
            return
        import torch

        torch.cuda.synchronize()
        self.prof.stop()
        self.recording, self.last = False, batch

    def trace(self) -> Trace | None:
        """The recorded trace, read back from its Chrome trace (written to
        a temporary file and deleted), or None if nothing was recorded."""
        if self.prof is None or self.last is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        return Trace.from_chrome(data, self.last - self.first,
                                 self.dispatches)
