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
span of another thread (``run_reader``'s writer thread, its card threads)
is kept here, on the same clock, but enters no range.

A run over several devices drives each from a thread of its own, under a
copy of the caller's context marked with its card (``on_card``): there a
step stage's CUDA events go on that card's current stream, and the
``syncs`` counter's sites carry the card's name (``pull-meta.card-1``).
The card threads take turns at the host's work, holding the run's
``baton`` (a lock) except inside a ``device_wait`` block, where a thread
waits on its card and another card's thread dispatches: threads that all
launch small operations at once would otherwise hand the interpreter's
lock to one another at every operation, which costs far more than the
operations. Under a profiler, inside a ``card_turns`` block, each stretch
of a card thread's host work between its waits (a turn, from taking the
baton to giving it up) is a ``shard.turn`` span with a CUDA event pair on
the card's stream: its host time leaves out the waits on the card and for
the baton, and its time on the card runs from the turn's start to the end
of the work launched in it, which leaves out the card's idle time while
its thread waits for a turn.

A step captured as a CUDA graph (``detector/step_graph.py``) runs its
Python once, under a ``Tape`` (``taping``): there ``count`` keeps what the
step counts on the tape instead, and a step stage records a pair of
timing events on the capture stream that the graph records again at each
replay (``torch.cuda.Event(external=True)``). Each run of the graph then
plays the tape (``Tape.play``): its counts are added to the current run's
recorder, and under a profiler each stage is a span of the current span's
batch, timed on the stream by the events of that run of the graph (its
host start and end are the play's instant).
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
# the card this thread's context drives (``_Card``), in a run over several
# devices; None in a run over one
_CARD: contextvars.ContextVar = contextvars.ContextVar(
    "attpc_card", default=None)
# the tape of a step being captured as a CUDA graph on this thread's
# context, or None
_TAPE: contextvars.ContextVar = contextvars.ContextVar(
    "attpc_tape", default=None)
_LAST: list = [None]
_OFF = nullcontext()


def profiling() -> bool:
    """True while a torch profiler records in the process."""
    return _autograd_profiler._is_profiler_enabled


def _new_counters() -> dict:
    return {"syncs": {}, "pinned_allocs": 0, "pinned_bytes": 0,
            "retries": {}, "batches": 0, "merge_sort.lanes": 0,
            "merge_sort.width_lanes": 0, "merge_sort.rows": {},
            "fano.draws": {}, "step.graph": {}, "driver.ahead": {}}


@dataclass(eq=False)
class Span:
    """A recorded span: Unix nanoseconds on the profiler's clock, the span
    it ran inside (None at the top of its thread), its batch's first event
    id, for a step stage or a turn on the card the stream's seconds
    between its two CUDA events (None until read) and, for a phase or a
    stage, the clock's readings just before and after its range was
    entered (``entered_ns``: the profiler stamps the range between them;
    ``start_ns`` is their middle)."""

    name: str
    start_ns: int
    end_ns: int
    parent: Span | None
    batch: int | None
    thread: str
    device_s: float | None = None
    entered_ns: tuple[int, int] | None = None


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
        by site), and to its traced twin while a profiler records. On a
        card's thread a ``syncs`` site carries the card's name."""
        sides = (self.counters, self.traced) if profiling() else (
            self.counters,)
        card = _CARD.get()
        if card is not None and name == "syncs":
            site = f"{site}.{card.name}"
        with self._lock:
            for c in sides:
                if site is None:
                    c[name] += n
                else:
                    by_site = c.setdefault(name, {})
                    by_site[site] = by_site.get(site, 0) + n

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

    def resolve(self, wait: bool = False) -> None:
        """Read the CUDA event pairs of the stages that have ended: call
        after a sync of the stream that covers them (pairs on another card
        that has not reached them stay pending), or with ``wait``, which
        waits for every pair."""
        if not self._pending:
            return
        with self._lock:
            pending, ended, self._pending = self._pending, [], []
            for p in pending:
                (ended if wait or p[2].query() else self._pending).append(p)
        for span, e0, e1 in ended:
            e1.synchronize()
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
        b = time.time_ns()
        span = Span(name, (a + b) // 2, 0, parent, batch,
                    threading.current_thread().name, entered_ns=(a, b))
        e0 = dev = None
        if stage:
            card = _CARD.get()
            dev = self.cuda if card is None else card.device
            if dev is not None and dev.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record(torch.cuda.current_stream(dev))
        stack.append(span)
        return span, rf, e0, dev

    def _exit(self, opened) -> None:
        span, rf, e0, dev = opened
        if e0 is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record(torch.cuda.current_stream(dev))
            with self._lock:
                self._pending.append((span, e0, e1))
        c = time.time_ns()
        if rf is not None:
            rf.__exit__(None, None, None)
        span.end_ns = (c + time.time_ns()) // 2
        self._stack().pop()
        with self._lock:
            self.spans.append(span)

    def _played(self, name: str, e0, e1) -> None:
        """A span ``name`` of a taped stage, timed on the stream by the
        events ``e0`` and ``e1`` of the graph run just launched, inside the
        current span and of its batch, at this instant on the host."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        now = time.time_ns()
        span = Span(name, now, now, parent,
                    parent.batch if parent is not None else None,
                    threading.current_thread().name)
        with self._lock:
            self._pending.append((span, e0, e1))
            self.spans.append(span)

    def _turn_begin(self, card: _Card) -> None:
        """Open a ``shard.turn`` span of ``card``'s batch on this thread."""
        e0 = None
        if card.device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record(torch.cuda.current_stream(card.device))
        stack = self._stack()
        card.turn = (Span("shard.turn", time.time_ns(), 0,
                          stack[-1] if stack else None, card.batch,
                          threading.current_thread().name), e0)

    def _turn_end(self, card: _Card) -> None:
        """Close ``card``'s open turn."""
        (span, e0), card.turn = card.turn, None
        span.end_ns = time.time_ns()
        e1 = None
        if e0 is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record(torch.cuda.current_stream(card.device))
        with self._lock:
            if e1 is not None:
                self._pending.append((span, e0, e1))
            self.spans.append(span)


@dataclass(eq=False)
class _Card:
    """The card a thread drives in a run over several devices: its name
    ("card-<k>"), its device, the baton the card threads take turns at
    and, inside a ``card_turns`` block, the recorder and batch of its
    turns and the open turn (its span and CUDA start event)."""

    name: str
    device: torch.device
    baton: threading.Lock | None
    recorder: PhaseTimes | None = None
    batch: int | None = None
    turn: tuple | None = None


class _Phase:
    """``phase_timer``'s block."""

    __slots__ = ("times", "name", "batch", "device_time", "t0", "opened")

    def __init__(self, times: PhaseTimes, name: str, batch: int | None,
                 device_time: bool = False):
        self.times, self.name, self.batch = times, name, batch
        self.device_time = device_time

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.opened = (self.times._enter(self.name, self.batch,
                                         self.device_time)
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


def phase_timer(times: PhaseTimes, name: str, batch: int | None = None,
                device_time: bool = False):
    """Accumulate the wall time of a block into ``times`` under ``name``;
    under a profiler the block is also a span of batch ``batch`` (None:
    its parent's), with ``device_time`` timed on the card as a step stage
    is."""
    return _Phase(times, name, batch, device_time)


class Tape:
    """What a step captured as a CUDA graph counts and times, for every
    run of the graph: ``counts``, the (name, site, n) of each ``count``
    made while it was captured, and ``stages``, the (name, start event, end
    event) of each stage. ``event`` makes a timing event that a graph
    records at each run (None: the stages are not timed)."""

    def __init__(self, event=None):
        self.event = event
        self.counts: list = []
        self.stages: list = []

    def play(self) -> None:
        """The tape of a graph run just launched: its counts added to the
        current run's recorder and, under a profiler, its stages' spans."""
        for c in self.counts:
            count(*c)
        times = _CURRENT.get()
        if times is not None and profiling():
            for name, e0, e1 in self.stages:
                times._played(name, e0, e1)


class _TapedStage:
    """``stage``'s block while a step is captured: a pair of the tape's
    timing events around it, recorded on the capture stream."""

    __slots__ = ("tape", "name", "e0")

    def __init__(self, tape: Tape, name: str):
        self.tape, self.name = tape, name

    def __enter__(self):
        self.e0 = self.tape.event()
        self.e0.record()
        return self

    def __exit__(self, *exc):
        e1 = self.tape.event()
        e1.record()
        self.tape.stages.append((self.name, self.e0, e1))
        return False


@contextmanager
def taping(tape: Tape):
    """The block in which a step is captured: ``count`` and ``stage`` go
    to ``tape`` (see the module's docstring)."""
    token = _TAPE.set(tape)
    try:
        yield tape
    finally:
        _TAPE.reset(token)


def stage(name: str):
    """A step stage's block: without a profiler nothing (one flag check);
    under one a ``record_function`` range, and a span of the current run's
    recorder (``begin_run``) where there is one. While a step is captured
    (``taping``), a pair of the tape's timing events, whatever the
    profiler."""
    tape = _TAPE.get()
    if tape is not None:
        return _OFF if tape.event is None else _TapedStage(tape, name)
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    times = _CURRENT.get()
    if times is None:
        return _autograd_profiler.record_function(name)
    return _Stage(times, name)


def count(name: str, site: str | None = None, n: int = 1) -> None:
    """``PhaseTimes.count`` on the current run's recorder, if any; while
    a step is captured (``taping``), onto the tape instead."""
    tape = _TAPE.get()
    if tape is not None:
        tape.counts.append((name, site, n))
        return
    times = _CURRENT.get()
    if times is not None:
        times.count(name, site, n)


def begin_run(times: PhaseTimes) -> contextvars.Token:
    """Make ``times`` the recorder of the step stages and counters on this
    thread's context, until ``end_run`` of the token returned, and the one
    ``last_run`` returns."""
    _LAST[0] = times
    return _CURRENT.set(times)


def on_card(name: str, device: torch.device,
            baton: threading.Lock | None = None) -> None:
    """Mark this thread's context as the one that drives card ``name`` on
    ``device``, in a run over several devices whose card threads take
    turns at ``baton`` (see the module's docstring)."""
    _CARD.set(_Card(name, device, baton))


class _Wait:
    """``device_wait``'s block on a card thread: the baton is given up
    for the block, and the card's open turn ends before it and a new one
    begins after it."""

    __slots__ = ("card",)

    def __init__(self, card: _Card):
        self.card = card

    def __enter__(self):
        card = self.card
        if card.turn is not None:
            card.recorder._turn_end(card)
        card.baton.release()
        return self

    def __exit__(self, *exc):
        card = self.card
        card.baton.acquire()
        if card.recorder is not None:
            card.recorder._turn_begin(card)
        return False


def device_wait():
    """A block in which the host waits on the device: on a card thread of
    a run over several devices, another card's thread runs the host's work
    meanwhile (the block gives up the run's baton); elsewhere nothing."""
    card = _CARD.get()
    if card is None or card.baton is None:
        return _OFF
    return _Wait(card)


class _Turns:
    """``card_turns``'s block."""

    __slots__ = ("times", "card", "batch")

    def __init__(self, times: PhaseTimes, card: _Card, batch: int):
        self.times, self.card, self.batch = times, card, batch

    def __enter__(self):
        card = self.card
        card.recorder, card.batch = self.times, self.batch
        self.times._turn_begin(card)
        return self

    def __exit__(self, *exc):
        card = self.card
        if card.turn is not None:
            self.times._turn_end(card)
        card.recorder = card.batch = None
        return False


def card_turns(times: PhaseTimes, batch: int):
    """A block of a card thread's work on batch ``batch``, holding the
    baton: under a profiler each of its turns is a ``shard.turn`` span of
    ``times`` (see the module's docstring); elsewhere nothing."""
    card = _CARD.get()
    if card is None or not profiling():
        return _OFF
    return _Turns(times, card, batch)


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
