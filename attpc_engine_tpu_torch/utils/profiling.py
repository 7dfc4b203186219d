"""Per-phase wall timing, the run's spans and counters, and trace capture
(port of attpc_engine_tpu/utils/profiling.py: a lock in ``PhaseTimes.add``,
and ``trace_to`` on ``torch.profiler`` in place of ``jax.profiler``; the
spans, counters and ``stage`` are the port's own).

One recorder, ``PhaseTimes``, for each ``run_reader`` call:

- always, at the cost the phases always had, the summed wall seconds of
  each phase (``seconds``: ``run_reader``'s ``phase_seconds``) and the
  counters (``count``): plain integer increments at the run's layer
  boundaries;
- while a ``torch.profiler`` records in the process (``trace_to``, or any
  other profiler: ``torch.autograd.profiler._is_profiler_enabled``), and
  only then, every phase and every step stage (``stage``) is also a span:
  a ``record_function`` range of its name on the profiler's timeline,
  kept here (``spans``) with its start and end in Unix nanoseconds (the
  clock of the profiler's CPU events), its parent span and its batch (the
  batch's first event id). A step stage on a CUDA device also records a
  pair of timing events on the current stream, read by ``resolve`` after a
  sync that covers them. Counters also add into ``traced`` while the
  profiler records.

torch's profiler records the ranges of the thread that started it only: a
span of another thread (``run_reader``'s writer thread) is kept here, on
the same clock, but enters no range.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler

# the recorder of the run on this thread's context, for the step's stages
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "attpc_recorder", default=None)
_LAST: list = [None]
_OFF = nullcontext()


def profiling() -> bool:
    """True while a torch profiler records in the process."""
    return _autograd_profiler._is_profiler_enabled


def _new_counters() -> dict:
    return {"syncs": {}, "pinned_allocs": 0, "pinned_bytes": 0,
            "retries": {}, "batches": 0}


@dataclass(eq=False)
class Span:
    """A recorded span: Unix nanoseconds on the profiler's clock, the span
    it ran inside (None at the top of its thread), its batch's first event
    id, and, for a step stage on the card, the stream's seconds between its
    two CUDA events (None until read)."""

    name: str
    start_ns: int
    end_ns: int
    parent: Span | None
    batch: int | None
    thread: str
    device_s: float | None = None


@dataclass
class PhaseTimes:
    """Accumulated wall-clock seconds per named phase, the counters and,
    under a profiler, the spans; ``add``, ``count`` and spans may be used
    from several threads. ``cuda``: the CUDA device whose current stream
    the step stages' events are recorded on (None: no events)."""

    seconds: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    counters: dict = field(default_factory=_new_counters)
    traced: dict = field(default_factory=_new_counters)
    spans: list[Span] = field(default_factory=list)
    cuda: torch.device | None = None
    _pending: list = field(default_factory=list, repr=False)
    _local: threading.local = field(default_factory=threading.local,
                                    repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def add(self, name: str, dt: float) -> None:
        with self._lock:
            self.seconds[name] += dt
            self.counts[name] += 1

    def count(self, name: str, site: str | None = None, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` (at ``site``, for the counters kept
        by site), and to its traced twin while a profiler records."""
        sides = (self.counters, self.traced) if profiling() else (
            self.counters,)
        with self._lock:
            for c in sides:
                if site is None:
                    c[name] += n
                else:
                    c[name][site] = c[name].get(site, 0) + n

    def summary(self) -> str:
        total = sum(self.seconds.values())
        lines = [f"total {total:.2f}s"]
        for name, s in sorted(self.seconds.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name}: {s:.2f}s ({self.counts[name]}x)")
        return "\n".join(lines)

    def span_summary(self) -> dict:
        """Each span name's summed host seconds, count and summed device
        seconds (None where no span of the name timed the card)."""
        out: dict = {}
        with self._lock:
            spans = list(self.spans)
        for s in spans:
            d = out.setdefault(s.name, {"host_s": 0.0, "count": 0,
                                        "device_s": None})
            d["host_s"] += (s.end_ns - s.start_ns) * 1e-9
            d["count"] += 1
            if s.device_s is not None:
                d["device_s"] = (d["device_s"] or 0.0) + s.device_s
        return out

    def resolve(self) -> None:
        """Read the CUDA event pairs of the stages that have ended; call
        after a sync of the stream that covers them."""
        if not self._pending:
            return
        with self._lock:
            pending, self._pending = self._pending, []
        for span, e0, e1 in pending:
            span.device_s = e0.elapsed_time(e1) * 1e-3

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _enter(self, name: str, batch: int | None, stage: bool):
        stack = self._stack()
        parent = stack[-1] if stack else None
        if batch is None and parent is not None:
            batch = parent.batch
        rf = None
        if torch._C._autograd._profiler_enabled():  # this thread records
            rf = _autograd_profiler.record_function(name)
        # the profiler stamps the range inside its enter: take the middle
        a = time.time_ns()
        if rf is not None:
            rf.__enter__()
        span = Span(name, (a + time.time_ns()) // 2, 0, parent, batch,
                    threading.current_thread().name)
        e0 = None
        if stage and self.cuda is not None:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record(torch.cuda.current_stream(self.cuda))
        stack.append(span)
        return span, rf, e0

    def _exit(self, opened) -> None:
        span, rf, e0 = opened
        if e0 is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record(torch.cuda.current_stream(self.cuda))
            with self._lock:
                self._pending.append((span, e0, e1))
        c = time.time_ns()
        if rf is not None:
            rf.__exit__(None, None, None)
        span.end_ns = (c + time.time_ns()) // 2
        self._stack().pop()
        with self._lock:
            self.spans.append(span)


class _Phase:
    """``phase_timer``'s block."""

    __slots__ = ("times", "name", "batch", "t0", "opened")

    def __init__(self, times: PhaseTimes, name: str, batch: int | None):
        self.times, self.name, self.batch = times, name, batch

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.opened = (self.times._enter(self.name, self.batch, False)
                       if profiling() else None)
        return self

    def __exit__(self, *exc):
        if self.opened is not None:
            self.times._exit(self.opened)
        self.times.add(self.name, time.perf_counter() - self.t0)
        return False


class _Stage:
    """``stage``'s block under a profiler, in a run with a recorder."""

    __slots__ = ("times", "name", "opened")

    def __init__(self, times: PhaseTimes, name: str):
        self.times, self.name = times, name

    def __enter__(self):
        self.opened = self.times._enter(self.name, None, True)
        return self

    def __exit__(self, *exc):
        self.times._exit(self.opened)
        return False


def phase_timer(times: PhaseTimes, name: str, batch: int | None = None):
    """Accumulate the wall time of a block into ``times`` under ``name``;
    under a profiler the block is also a span of batch ``batch`` (None:
    its parent's)."""
    return _Phase(times, name, batch)


def stage(name: str):
    """A step stage's block: without a profiler nothing (one flag check);
    under one a ``record_function`` range, and a span of the current run's
    recorder (``begin_run``) where there is one."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    times = _CURRENT.get()
    if times is None:
        return _autograd_profiler.record_function(name)
    return _Stage(times, name)


def count(name: str, site: str | None = None, n: int = 1) -> None:
    """``PhaseTimes.count`` on the current run's recorder, if any."""
    times = _CURRENT.get()
    if times is not None:
        times.count(name, site, n)


def begin_run(times: PhaseTimes) -> contextvars.Token:
    """Make ``times`` the recorder of the step stages and counters on this
    thread's context, until ``end_run`` of the token returned, and the one
    ``last_run`` returns."""
    _LAST[0] = times
    return _CURRENT.set(times)


def end_run(token: contextvars.Token) -> None:
    """Give back the recorder ``begin_run`` replaced."""
    _CURRENT.reset(token)


def last_run() -> PhaseTimes | None:
    """The recorder of the most recent ``run_reader`` call in the
    process."""
    return _LAST[0]


@contextmanager
def trace_to(log_dir: str | Path | None):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (no-op if None): CPU activity, and CUDA activity where torch finds a
    CUDA device. The trace is a Chrome trace JSON file,
    ``trace_<pid>.json``, that TensorBoard and Perfetto open."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    # the first range of a process, and a profiler's first once started,
    # take 0.1-1 ms to enter: take them here, so that the spans' times stay
    # within microseconds of their ranges
    with _autograd_profiler.record_function("trace_to"):
        pass
    with profile(activities=activities) as prof:
        with _autograd_profiler.record_function("trace_to"):
            pass
        yield
    prof.export_chrome_trace(str(log_dir / f"trace_{os.getpid()}.json"))
