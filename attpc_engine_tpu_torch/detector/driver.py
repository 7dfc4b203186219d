"""Detector stage: the driver (port of the JAX package's run loop,
attpc_engine_tpu/detector/simulator.py:1051-1479).

``run_simulation`` streams the batches of a kinematics file through the
detector step (``simulator.DetectorSimulator``) into a writer;
``run_reader`` is its batch loop over any reader. Every batch takes one
path:

 -> cut into contiguous shards, one a device (``_shards``: one shard on
    one device), each with its own copy of the budgets
 -> each shard dispatched, with the outputs its pull reads copied out of
    the step's and its metadata on its way to the host behind them
    (``_Flight``)
 -> once the run's budgets are tuned, left in flight: the next batch is
    read and dispatched before the shard is pulled, so that the card runs
    a step while the host reads, stages and launches the next
 -> each shard pulled: its metadata read (``StepMeta``), run again while
    a budget overflows, and its rows pulled on its device by the run's
    output (``_Output``: packed rows, rows assembled on the device, or the
    reference protocol's raw clouds, chosen once a run)
 -> the shards' rows copied to the host end to end (``_HostCopies``), and
    the budgets grown to the largest a shard reached
 -> the batch handed to the writer thread once the next batch after it
    is dispatched; the thread finishes the copies and writes.

The number of devices decides only who runs a shard: on one device the
main thread, under the ``dispatch`` span; over several, each card's own
host thread (``_Cards``), under ``shard.step``, ``shard.dispatch`` and
the card's turns.
"""

from __future__ import annotations

import contextvars
import copy
import os
import queue
import sys
import threading
import time
import weakref
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..kernels import require_devices
from ..utils.profiling import (
    PhaseTimes,
    begin_run,
    card_turns,
    device_wait,
    end_run,
    on_card,
    phase_timer,
    profiling,
)
from .parameters import Config
from .simulator import (
    DetectorSimulator,
    EngineParams,
    PoolOverflow,
    StepMeta,
    overflow_kinds,
)

__all__ = ["run_reader", "run_simulation"]


class _HostCopies:
    """Copies of a batch's rows to the host (the assembled Spyral rows and
    labels, or the packed rows), started behind the batch's step and
    finished on the writer thread (simulator.py:1353-1363).

    ``start`` copies the rows of one tensor a shard, end to end, into one
    buffer. On a CUDA device each shard's copy runs on its card's side
    stream, after an event recorded on the card's current stream, into a
    page-locked buffer of the sources' type and row shape; each source is
    kept alive for its side stream (``record_stream``). ``finish`` waits
    for the copies, copies the rows out into an array the caller owns and
    only then frees the buffer for another batch; ``lend`` hands the
    buffer's rows to a callback without a copy and frees the buffer after
    it, unless the callback kept them. ``start`` runs on the main thread
    and ``finish`` and ``lend`` on the writer thread: the free list is
    taken and refilled under a lock. On the CPU the rows are a tensor's
    own memory. ``times`` counts each fresh page-locked buffer
    (``pinned_allocs``, ``pinned_bytes``) and each wait for a shard's copy
    (``syncs`` at the site given for it).
    """

    ROWS_QUANTUM = 1 << 16

    def __init__(self, device: torch.device,
                 times: PhaseTimes | None = None):
        self.cuda = device.type == "cuda"
        # the side stream of each card: ``device``'s made here, another
        # card's on the first copy from it
        self.streams = {}
        if self.cuda:
            side = torch.cuda.Stream(device)
            self.streams[side.device] = side
        self.free: list[torch.Tensor] = []
        self.lock = threading.Lock()
        self.times = times if times is not None else PhaseTimes()

    def take_free(self, rows: int,
                  like: torch.Tensor | None = None) -> torch.Tensor | None:
        """The first free buffer of at least ``rows`` rows (and of
        ``like``'s type and row shape, where given), taken out of the free
        list by its position (``list.remove`` would compare buffers with
        the elementwise tensor ``==``), or None."""
        with self.lock:
            for i, buf in enumerate(self.free):
                if buf.shape[0] >= rows and (
                        like is None or (buf.dtype == like.dtype
                                         and buf.shape[1:] == like.shape[1:])):
                    return self.free.pop(i)
        return None

    def _buffer(self, rows: int, like: torch.Tensor) -> torch.Tensor:
        """A free page-locked buffer of at least ``rows`` rows of
        ``like``'s type and row shape, or a new one."""
        buf = self.take_free(rows, like=like)
        if buf is None:
            q = self.ROWS_QUANTUM
            buf = torch.empty((max(-(-rows // q), 1) * q, *like.shape[1:]),
                              dtype=like.dtype, pin_memory=True)
            self.times.count("pinned_allocs")
            self.times.count("pinned_bytes", n=buf.nbytes)
        return buf

    def _copy(self, buf: torch.Tensor, at: int, src: torch.Tensor):
        """Copy ``src`` into ``buf[at:]`` on its card's side stream, after
        the work queued on its card's current stream; the copy's event."""
        side = self.streams.get(src.device)
        if side is None:
            side = self.streams[src.device] = torch.cuda.Stream(src.device)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(src.device))
        side.wait_event(ready)
        with torch.cuda.stream(side):
            buf[at:at + src.shape[0]].copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        src.record_stream(side)
        return done

    def start(self, srcs: list, sites: list):
        """One handle for the rows of ``srcs`` (one tensor a shard, of one
        type and row shape) end to end; waiting for it counts a ``syncs``
        at ``sites[k]`` for shard k's copy."""
        if not self.cuda:
            return torch.cat(srcs)
        rows = sum(src.shape[0] for src in srcs)
        buf = self._buffer(rows, srcs[0])
        waits, at = [], 0
        for src, site in zip(srcs, sites):
            waits.append((site, self._copy(buf, at, src)))
            at += src.shape[0]
        return buf, rows, waits

    def _wait(self, waits) -> None:
        """Wait for each shard's copy of a handle, counting each wait."""
        for site, event in waits:
            self.times.count("syncs", site)
            event.synchronize()

    def finish(self, handle) -> np.ndarray:
        if not self.cuda:
            return handle.numpy()
        buf, rows, waits = handle
        self._wait(waits)
        rows_np = buf[:rows].numpy().copy()
        with self.lock:
            self.free.append(buf)
        return rows_np

    def lend(self, handles, use) -> None:
        """Call ``use(*arrays)`` with host views of the copies' page-locked
        buffers, once each copy is done: no copy out. Then each buffer goes
        back to the pool, unless its array outlived the call (``use`` kept
        it, or a view of it): such a buffer stays with its array and
        leaves the pool, so that no later copy overwrites what a caller
        kept. On the CPU the arrays are the tensors' own memory."""
        if not self.cuda:
            use(*(h.numpy() for h in handles))
            return
        arrays = []
        for buf, rows, waits in handles:
            self._wait(waits)
            arrays.append(buf[:rows].numpy())
        alive = [weakref.ref(a) for a in arrays]
        use(*arrays)
        del arrays
        with self.lock:
            self.free.extend(buf for (buf, _, _), ref in zip(handles, alive)
                             if ref() is None)


def _round_up(k, q: int) -> int:
    """k rounded up to a multiple of q, at least q (simulator.py:1327-1330)."""
    return max(((int(k) + q - 1) // q) * q, q)


class _Cards:
    """One host thread a device of a run over several ("card-<k>"), each
    under a copy of the caller's context marked as its card's
    (``profiling.on_card``), so that the run's recorder finds it, and on
    its card as the thread's current CUDA device. ``submit`` hands card k
    a call; ``collect`` waits for the calls handed to the first ``n``
    cards and returns their results in card order, or raises the first
    exception once every card has answered. The threads run their calls
    in turns, holding ``baton``, which a thread gives up while it waits on
    its card (``profiling.device_wait``): a sync on one card holds up that
    card's thread only."""

    def __init__(self, devices: list):
        self.jobs = [queue.SimpleQueue() for _ in devices]
        self.results = [queue.SimpleQueue() for _ in devices]
        self.baton = threading.Lock()
        self.threads = []
        for k, dev in enumerate(devices):
            ctx = contextvars.copy_context()
            t = threading.Thread(target=ctx.run, args=(self._loop, k, dev),
                                 name=f"card-{k}", daemon=True)
            t.start()
            self.threads.append(t)

    def _loop(self, k: int, dev: torch.device) -> None:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        on_card(f"card-{k}", dev, self.baton)
        while True:
            job = self.jobs[k].get()
            if job is None:
                return
            fn, args = job
            try:
                with self.baton:
                    answer = (True, fn(*args))
            except BaseException as exc:  # raised on the caller's thread
                answer = (False, exc)
            self.results[k].put(answer)

    def submit(self, k: int, fn, *args) -> None:
        self.jobs[k].put((fn, args))

    def collect(self, n: int) -> list:
        answers = [self.results[k].get() for k in range(n)]
        for ok, value in answers:
            if not ok:
                raise value
        return [value for _, value in answers]

    def close(self) -> None:
        for q in self.jobs:
            q.put(None)
        for t in self.threads:
            t.join()


def _shards(n: int, n_devices: int) -> list[tuple[int, int]]:
    """A batch's events [0, n) cut into contiguous shards of
    ceil(n / n_devices) events, one a device (a short batch uses fewer)."""
    size = -(-n // n_devices)
    return [(lo, min(lo + size, n)) for lo in range(0, n, size)]


@dataclass(eq=False)
class _Flight:
    """A shard dispatched and not yet pulled: what dispatched it (to run it
    again where a budget overflows), the outputs its pull reads, copied out
    of the step's (``_Output.keep``), and its ``meta_i32`` on its way to
    the host: ``meta`` (page-locked on a card) holds it once ``ready``
    (None off the card) has passed."""

    k: int
    vertices: np.ndarray
    momenta: np.ndarray
    start: int
    batch: int
    budgets: dict
    span: str
    kept: dict
    meta: torch.Tensor
    ready: torch.cuda.Event | None


@dataclass
class _Shard:
    """A shard's result: its metadata, its rows as ``_Output.pull`` gives
    them, and the budgets it ended at."""

    meta: StepMeta
    rows: tuple
    budgets: dict


@dataclass
class _Batch:
    """A batch on its way to the writer: its first event id, its shards'
    metadata joined, and its rows as ``_Output.send`` gives them."""

    start: int
    meta: StepMeta
    rows: tuple

    @property
    def events(self) -> np.ndarray:
        return np.arange(self.start, self.start + len(self.meta.counts))


class _Output:
    """The writer's protocol, chosen once a run (``_output``): whether the
    step pools each event's raw cloud (``compact``), which of the step's
    outputs a shard's pull reads (``reads``, kept by ``keep`` at its
    dispatch), what a shard's rows are pulled as on its device once its
    metadata shows no overflow (``pull``, on the shard's thread), how a
    batch's shards' rows leave for the host (``send``, on the main thread)
    and how they are written (``write``, on the writer thread)."""

    compact = False
    reads = ("packed", "spyral_counts")

    def __init__(self, writer, config: Config, seed: int, times: PhaseTimes,
                 copies: _HostCopies):
        self.writer, self.config, self.seed = writer, config, seed
        self.times, self.copies = times, copies

    def keep(self, out: dict) -> dict:
        """The outputs ``pull`` reads, copied on the current stream: the
        next dispatch comes before this one's pull, and a replay of the
        step's graph overwrites the graph's own outputs
        (``step_graph.py``)."""
        return {name: out[name].clone() for name in self.reads}

    def send(self, parts: list, sites: list, batch: int) -> tuple:
        """Start the copies to the host of each kind of a batch's rows,
        the shards' end to end (shard k's wait counted at ``sites[k]``)."""
        with phase_timer(self.times, "pull-start", batch):
            return tuple(self.copies.start(list(srcs), sites)
                         for srcs in zip(*parts))


class _PackedRows(_Output):
    """A writer of packed rows (``write_packed``: SpyralWriterProc, whose
    child assembles them on the host)."""

    reads = ("packed",)

    def pull(self, sim, kept, meta: StepMeta, start: int, batch: int):
        return (kept["packed"][:meta.kept],)

    def write(self, b: _Batch) -> None:
        with phase_timer(self.times, "pull-packed", b.start):
            packed = self.copies.finish(b.rows[0])
        with phase_timer(self.times, "ship-to-writer", b.start):
            self.writer.write_packed(packed, b.meta.counts, b.events,
                                     raw_counts=b.meta.merged,
                                     wiggle_seed=self.seed)


class _AssembledRows(_Output):
    """Any other writer of ``write_spyral_pool`` (SpyralWriter): the rows
    assembled on the device, lent to the writer as views of page-locked
    buffers."""

    def pull(self, sim, kept, meta: StepMeta, start: int, batch: int):
        with phase_timer(self.times, "assemble-device", batch):
            return sim.assemble_device(
                kept["packed"][:meta.kept], kept["spyral_counts"],
                torch.arange(start, start + len(meta.counts),
                             device=sim.device),
                self.seed)

    def write(self, b: _Batch) -> None:
        pull = phase_timer(self.times, "pull-spyral", b.start).__enter__()

        def write(spyral, labels):
            pull.__exit__()
            with phase_timer(self.times, "h5py-write", b.start):
                self.writer.write_spyral_pool(spyral, labels, b.meta.counts,
                                              event_numbers=b.events,
                                              raw_counts=b.meta.merged)

        self.copies.lend(b.rows, write)


class _RawClouds(_Output):
    """A writer of neither (the reference ``SimulationWriter`` protocol):
    each event's merged [pad, tb, electrons] cloud through ``write``,
    pooled by the step and pulled to the host on the shard's thread."""

    compact = True
    reads = ("counts", "pads", "tbs", "charges", "labels", "cloud_overflow")

    def pull(self, sim, kept, meta: StepMeta, start: int, batch: int):
        n = len(meta.counts)
        with phase_timer(self.times, "pull-cloud", batch), device_wait():
            counts = kept["counts"][:n].cpu().numpy()
            total = int(counts.sum())
            raw = torch.stack([kept[k][:total].double()
                               for k in ("pads", "tbs", "charges")],
                              dim=-1).cpu().numpy()
            labels = kept["labels"][:total].long().cpu().numpy()
        return raw, labels, counts

    def send(self, parts: list, sites: list, batch: int) -> tuple:
        return tuple(np.concatenate(part) for part in zip(*parts))

    def write(self, b: _Batch) -> None:
        raw, labels, counts = b.rows
        offsets = np.concatenate([[0], np.cumsum(counts)])
        for i in range(len(counts)):
            lo, hi = int(offsets[i]), int(offsets[i + 1])
            if hi > lo:
                self.writer.write(raw[lo:hi], labels[lo:hi], self.config,
                                  b.start + i)


def _output(writer, *args) -> _Output:
    """The output a writer takes: raw clouds for a writer without
    ``write_spyral_pool``, packed rows for one with ``write_packed``, else
    rows assembled on the device."""
    if not hasattr(writer, "write_spyral_pool"):
        return _RawClouds(writer, *args)
    if hasattr(writer, "write_packed"):
        return _PackedRows(writer, *args)
    return _AssembledRows(writer, *args)


class _Run:
    """One ``run_reader`` call's batch loop and the state it shares
    between the main thread, the card threads and the writer thread: the
    simulators (one a device), the budgets, the output, the host copies,
    each device's free buffers for its steps' metadata, the batch in
    flight, the batch on its way to the writer and the writer thread's
    queue and first exception. ``start`` starts the threads and ``close``
    stops them."""

    def __init__(self, config: Config, reader, writer, indices,
                 engine: EngineParams, seed: int, auto_tune: bool,
                 devices: list, times: PhaseTimes, progress):
        self.engine, self.seed, self.times = engine, seed, times
        self.devices, self.progress = devices, progress
        self.sims = [DetectorSimulator(config, reader.proton_numbers,
                                       reader.mass_numbers, indices=indices,
                                       engine=engine, device=d)
                     for d in devices]
        self.copies = _HostCopies(devices[0], times)
        self.output = _output(writer, config, seed, times, self.copies)
        self.budgets = dict(
            point=engine.point_budget, uniq=engine.uniq_budget,
            cloud=engine.cloud_cap, out=engine.out_budget,
            # probe first: under auto-tuning the first batch runs one
            # chunk; the "steps" overflow climbs x4 up to the physics window
            steps=(min(engine.chunk_steps, engine.n_time_steps) if auto_tune
                   else engine.n_time_steps),
        )
        self.tuned = not auto_tune
        self.stats = {"events": 0, "rows": 0}
        # each device's free host buffers for its steps' metadata: a device
        # holds at most two flights, the one pulled and the one after it
        self.meta_free: list[list[torch.Tensor]] = [[] for _ in devices]
        self.flying: list[_Flight] | None = None
        self.pending: _Batch | None = None
        self.queue: queue.Queue = queue.Queue(maxsize=2)
        self.errors: list[BaseException] = []
        self.cards: _Cards | None = None
        self.writer_thread: threading.Thread | None = None

    def start(self) -> None:
        """Start the card threads of a run over several devices and the
        writer thread; name the sites of the waits for each shard's
        copy."""
        devices = self.devices
        if len(devices) == 1:
            # the main thread runs the shard: the step's stages are timed
            # on its device's stream
            self.times.cuda = devices[0] if devices[0].type == "cuda" else None
            self.copy_sites = ["copy-finish"]
        else:
            if devices[0].type == "cuda":
                kernels.library()  # built or loaded once, before the threads
            self.cards = _Cards(devices)
            self.copy_sites = [f"copy-finish.card-{k}"
                               for k in range(len(devices))]
        self.writer_thread = threading.Thread(target=self._write_loop,
                                              name="spyral-writer")
        self.writer_thread.start()

    def batch(self, vertices, momenta, start: int) -> None:
        """Batch ``start``: its shards dispatched and, once the budgets are
        tuned, left in flight while the batch dispatched before it is
        pulled and its rows start for the host. The probe batch is pulled
        at once and the budgets retightened to its multiplicities, before
        any other dispatch. ``driver.ahead`` counts the batch at
        ``queued`` where the batch before it was still in flight, else at
        ``serial``."""
        held, self.flying = self.flying, None
        self.times.count("driver.ahead",
                         "serial" if held is None else "queued")
        jobs = [(vertices[lo:hi], momenta[lo:hi], start + lo, start,
                 dict(self.budgets))
                for lo, hi in _shards(len(vertices), len(self.sims))]
        flights, shards = self._turns(jobs, held)
        if held is not None:
            self._send(held[0].batch, shards)
        if self.tuned:
            self.flying = flights
            return
        _, shards = self._turns([], flights)
        self._retighten(self._send(start, shards))
        self.tuned = True

    def _turns(self, jobs: list, held: list[_Flight] | None):
        """Each device's turn: its shard of ``jobs`` dispatched, then its
        shard of the batch in flight (``held``) pulled; the batch on its
        way to the writer goes to the writer thread in between. On one
        device the main thread takes the turn, dispatching under the
        ``dispatch`` span; over several, each card's thread takes its own
        (``_card_turn``). Returns (the new flights, the pulled shards),
        each in shard order."""
        held = held or []
        if self.cards is None:
            flights = [self._dispatch(0, *job, "dispatch") for job in jobs]
            self._flush()
            shards = [self._pull(f, flights[0] if flights else None)
                      for f in held]
            return flights, shards
        n = max(len(jobs), len(held))
        for k in range(n):
            self.cards.submit(k, self._card_turn, k,
                              jobs[k] if k < len(jobs) else None,
                              held[k] if k < len(held) else None)
        self._flush()
        answers = self.cards.collect(n)
        return ([f for f, _ in answers if f is not None],
                [s for _, s in answers if s is not None])

    def _card_turn(self, k: int, job, held: _Flight | None):
        """Card k's turn, on card k's thread: a ``shard.step`` span of the
        batch it dispatches (else of the one it pulls), timed on card k's
        stream, around the ``shard.dispatch`` of its shard of the batch and
        the pull of the shard in flight on it, and under a profiler its
        turns (``shard.turn``)."""
        batch = job[3] if job is not None else held.batch
        with phase_timer(self.times, "shard.step", batch, device_time=True), \
                card_turns(self.times, batch):
            flight = shard = None
            if job is not None:
                self.times.count("shard.events", f"card-{k}", len(job[0]))
                flight = self._dispatch(k, *job, "shard.dispatch")
            if held is not None:
                shard = self._pull(held, flight)
            return flight, shard

    def _dispatch(self, k: int, vertices, momenta, start: int, batch: int,
                  budgets: dict, span: str) -> _Flight:
        """Events [start, start + n) of batch ``batch`` dispatched on
        device k under ``span`` at ``budgets``; behind the step, on the
        current stream, the outputs the pull reads copied out
        (``_Output.keep``) and ``meta_i32`` copied to the host."""
        sim = self.sims[k]
        with phase_timer(self.times, span, batch):
            # through the instance at every dispatch: a caller may replace
            # the class's method while the run goes on
            out = sim.simulate_batch(
                vertices, momenta, seed=self.seed, event_start=start,
                assemble=False, point_budget=budgets["point"],
                uniq_budget=budgets["uniq"], out_budget=budgets["out"],
                n_steps=budgets["steps"], compact=self.output.compact,
                cloud_cap=budgets["cloud"],
            )
            kept = self.output.keep(out)
            meta, ready = self._meta_to_host(k, out["meta_i32"])
        return _Flight(k, vertices, momenta, start, batch, budgets, span,
                       kept, meta, ready)

    def _meta_to_host(self, k: int, src: torch.Tensor):
        """``src``, a step's ``meta_i32``, copied behind the work queued on
        the current stream into a free host buffer of device k of its shape
        (page-locked on a card) or a new one: (the buffer, the copy's event,
        None off the card)."""
        free, cuda = self.meta_free[k], src.device.type == "cuda"
        for i, buf in enumerate(free):  # by position, as in _HostCopies
            if buf.shape == src.shape:
                meta = free.pop(i)
                break
        else:
            meta = torch.empty(src.shape, dtype=src.dtype, pin_memory=cuda)
            if cuda:
                self.times.count("pinned_allocs")
                self.times.count("pinned_bytes", n=meta.nbytes)
        meta.copy_(src, non_blocking=True)
        if not cuda:
            return meta, None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(src.device))
        return meta, ready

    def _pull(self, flight: _Flight, behind: _Flight | None) -> _Shard:
        """A shard in flight pulled: its metadata read, and while a budget
        overflows, the shard run again with every overflowing budget of
        its own doubled (the window climbed), at most 8 runs in all; then
        its rows pulled by the output. ``behind``: the shard dispatched
        after it on its device, if any, which a first retry waits for (a
        retry's new budgets drop the step's graph, whose replay may still
        be queued: ``step_graph.py``)."""
        sim, eng = self.sims[flight.k], self.engine
        budgets = flight.budgets
        for attempt in range(8):
            try:
                meta = self._pull_meta(sim, flight)
            except PoolOverflow as ov:
                for kind in ov.kinds:
                    self.times.count("retries", kind)
                    if kind == "steps":
                        budgets["steps"] = min(
                            _round_up(budgets["steps"] * 4, eng.chunk_steps),
                            eng.n_time_steps)
                    else:
                        budgets[kind] *= 2
                        if budgets[kind] > 2**21:
                            raise
                if attempt == 7:
                    break
                if behind is not None:
                    self.times.count("syncs", "retry")
                    if behind.ready is not None:
                        with device_wait():
                            behind.ready.synchronize()
                    behind = None
                flight = self._dispatch(flight.k, flight.vertices,
                                        flight.momenta, flight.start,
                                        flight.batch, budgets, flight.span)
                continue
            rows = self.output.pull(sim, flight.kept, meta, flight.start,
                                    flight.batch)
            return _Shard(meta, rows, budgets)
        raise RuntimeError("pool budgets failed to converge")

    def _pull_meta(self, sim, flight: _Flight) -> StepMeta:
        """A flight's metadata (a wait for its copy to the host, which the
        step dispatched after it does not hold up), its merge sort
        counted, its overflows raised as PoolOverflow."""
        with phase_timer(self.times, "pull-meta", flight.batch):
            self.times.count("syncs", "pull-meta")
            if flight.ready is not None:
                with device_wait():
                    flight.ready.synchronize()
            meta_i32 = flight.meta.numpy().copy()
            self.meta_free[flight.k].append(flight.meta)
        self.times.resolve()
        cloud_overflow = 0
        if "cloud_overflow" in flight.kept:
            self.times.count("syncs", "cloud-overflow")
            with device_wait():
                cloud_overflow = int(flight.kept["cloud_overflow"])
        meta = StepMeta.decode(meta_i32, cloud_overflow)
        sim.count_merge_sort(meta, flight.budgets["point"])
        kinds = overflow_kinds(meta, flight.budgets["steps"],
                               self.engine.n_time_steps)
        if kinds:
            raise PoolOverflow(kinds)
        return meta

    def _send(self, start: int, shards: list[_Shard]) -> StepMeta:
        """Batch ``start``'s pulled shards: the budgets grown to the
        largest a shard reached, the rows on their way to the host and the
        batch on its way to the writer (``pending``); its metadata."""
        for shard in shards:
            for key, value in shard.budgets.items():
                self.budgets[key] = max(self.budgets[key], value)
        meta = StepMeta.join([s.meta for s in shards])
        rows = self.output.send([s.rows for s in shards], self.copy_sites,
                                start)
        self.pending = _Batch(start, meta, rows)
        self.stats["events"] += len(meta.counts)
        self.stats["rows"] += meta.kept
        return meta

    def _retighten(self, meta: StepMeta) -> None:
        """The budgets retightened to the first batch's multiplicities (the
        JAX rule: 1.3x, rounded up)."""
        eng, b = self.engine, self.budgets
        b["point"] = min(b["point"],
                         _round_up(meta.n_points.max(initial=0) * 1.3, 64))
        b["uniq"] = min(b["uniq"], _round_up(meta.uniq_max * 1.3, 1024))
        b["out"] = min(b["out"], _round_up(
            meta.kept / eng.events_per_batch * 1.3, 1024))
        b["steps"] = min(_round_up(meta.steps_alive * 1.3, eng.chunk_steps),
                         eng.n_time_steps)

    def _flush(self) -> None:
        """Hand the batch on its way to the writer thread, raising the
        writer's first exception instead where it has raised."""
        if self.pending is not None:
            if self.errors:
                raise self.errors[0]
            self.queue.put(self.pending)
            self.pending = None

    def _write_loop(self) -> None:
        """The writer thread: each batch's copies finished and written, in
        order; after an exception nothing more is written."""
        while True:
            b = self.queue.get()
            if b is None:
                return
            try:
                if not self.errors:
                    self.output.write(b)
                    if self.progress is not None:
                        self.progress.update(len(b.meta.counts))
            except BaseException as exc:  # raised on the main thread
                self.errors.append(exc)

    def drain(self) -> None:
        """Pull the batch in flight, hand the last batches to the writer
        thread, wait for every write, and raise the writer's first
        exception."""
        if self.flying is not None:
            held, self.flying = self.flying, None
            _, shards = self._turns([], held)
            self._send(held[0].batch, shards)
        self._flush()
        self.queue.put(None)
        self.writer_thread.join()
        if self.errors:
            raise self.errors[0]

    def close(self) -> None:
        """Stop the card threads and the writer thread."""
        if self.cards is not None:
            self.cards.close()
        if self.writer_thread is not None and self.writer_thread.is_alive():
            self.queue.put(None)
            self.writer_thread.join()


def run_reader(
    config: Config,
    reader,
    writer,
    indices: list[int] | None = None,
    engine: EngineParams | None = None,
    seed: int | None = None,
    show_progress: bool = True,
    start_event: int = 0,
    stop_event: int | None = None,
    auto_tune: bool = True,
    device: torch.device | str | list = "cuda",
    input_name: str | None = None,
) -> dict:
    """The batch loop of ``run_simulation`` over an open kinematics
    ``reader``: an object with ``n_events``, ``proton_numbers``,
    ``mass_numbers``, ``read_range(start, stop)`` -> (vertices, momenta)
    and ``close()``. It closes the reader and the writer on every exit.
    ``input_name`` is the input's name in the run manifest. Arguments and
    result as ``run_simulation``'s; a factoring of its body (so that a run
    can read arrays where no HDF5 reader exists), not an entry point.
    """
    times = PhaseTimes()
    token = begin_run(times)
    wall_t0 = time.perf_counter()
    # from the call to the first read: the simulators and their tables, the
    # host copies, the card threads and the writer thread
    init = phase_timer(times, "init").__enter__()
    progress = None
    devices: list = []
    run = None
    stop = None
    try:
        devices = require_devices(device)
        engine = engine or EngineParams()
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2**31))
        stop = (reader.n_events if stop_event is None
                else min(stop_event, reader.n_events))
        if show_progress:
            try:
                from tqdm import tqdm

                progress = tqdm(total=reader.n_events)
            except ImportError:
                pass
        run = _Run(config, reader, writer, indices, engine, seed, auto_tune,
                   devices, times, progress)
        run.start()
        init.__exit__()
        init = None
        eb = engine.events_per_batch
        for start in range(start_event, stop, eb):
            with phase_timer(times, "read", start):
                vertices, momenta = reader.read_range(start,
                                                      min(start + eb, stop))
            if profiling():
                times.count("batches")
            run.batch(vertices, momenta, start)
        run.drain()
        times.resolve(wait=True)
        if os.environ.get("ATTPC_TPU_TIMING"):
            print(f"[run_simulation] budgets={run.budgets}\n"
                  f"{times.summary()}", file=sys.stderr)
        return {**run.stats, "budgets": dict(run.budgets),
                "phase_seconds": dict(times.seconds),
                "counters": copy.deepcopy(times.counters),
                "spans": times.span_summary()}
    finally:
        if init is not None:
            init.__exit__()
        end_run(token)
        if run is not None:
            run.close()
        try:
            writer.close()
        finally:
            reader.close()
            if progress is not None:
                progress.close()
        if run is not None and hasattr(writer, "get_directory_name"):
            from ..utils.manifest import write_run_manifest

            dp, ep = config.det_params, config.elec_params
            write_run_manifest(
                writer.get_directory_name(),
                stage="detector",
                seed=seed,
                event_range=(start_event, stop),
                device=devices,
                config={
                    "input": input_name,
                    "length_m": dp.length,
                    "efield": dp.efield,
                    "bfield": dp.bfield,
                    "mpgd_gain": dp.mpgd_gain,
                    "diffusion": dp.diffusion,
                    "fano_factor": dp.fano_factor,
                    "w_value": dp.w_value,
                    "adc_threshold": ep.adc_threshold,
                    "sim_indices": run.sims[0].sim_indices,
                },
                budgets=run.budgets,
                phase_seconds=dict(times.seconds),
                wall_seconds=time.perf_counter() - wall_t0,
                extra={"events_per_batch": engine.events_per_batch,
                       "counters": times.counters,
                       "spans": times.span_summary()},
            )


def run_simulation(
    config: Config,
    input_path: Path | str,
    writer,
    indices: list[int] | None = None,
    engine: EngineParams | None = None,
    seed: int | None = None,
    show_progress: bool = True,
    start_event: int = 0,
    stop_event: int | None = None,
    auto_tune: bool = True,
    device: torch.device | str | list = "cuda",
) -> dict:
    """Run the detector simulation over a kinematics file into ``writer``
    (simulator.py:1051-1479; its device mesh as threads, one a card).

    Batches of ``engine.events_per_batch`` events are read with
    ``KinematicsReader`` and simulated on ``device``: by default
    (``"cuda"``) on every CUDA card torch finds, on one card with an
    index (``"cuda:1"``), the plain PyTorch versions with ``device="cpu"``,
    or on each device of a list; a CUDA device where torch finds none
    raises before any work. Over several devices each batch is cut into
    contiguous shards of ceil(events / devices) events, one a device (a
    short batch uses fewer), each dispatched on its device by a host
    thread of its own ("card-<k>") with its global event ids, so that a
    sync on one card holds up no other; the writer gets each batch's rows
    whole and in event order, as from one device. The rows do not depend
    on the layout: every draw is keyed by (seed, global event id).

    With ``auto_tune`` the first batch runs one chunk of ``chunk_steps``
    steps (a window that the "steps" overflow climbs x4, up to
    ``n_time_steps``), and then the window and the point, uniq and out
    budgets are retightened to 1.3x the first batch's multiplicities
    (rounded up to chunk_steps, 64, 1024 and 1024). A batch that overflows
    a budget runs again with every overflowing budget doubled (the window
    climbed), at most 8 times; over several devices only the shard that
    overflowed runs again, the run's budgets, shared by the shards, grow
    to the largest a shard reached once the batch is pulled, and the
    probe's retightening takes the largest multiplicities of the
    shards. Every draw depends only on the event's
    global id, so a retry or a tuned window reproduces the same physics,
    and a run resumed with the same seed at ``start_event`` reproduces the
    events it would have produced, for any ``events_per_batch``.

    Once the budgets are tuned (after the probe, or from the first batch
    without ``auto_tune``), one batch is in flight: each batch is
    dispatched before the one before it is pulled, so that the device
    runs a step while the host pulls, reads and stages. A batch keeps the
    budgets it was dispatched at: where the batch before it overflows and
    runs again, the budgets grow for the batches after it, and it runs
    again only where it overflows itself.

    Each batch's rows are assembled on ``device`` once its metadata shows
    no overflow (``DetectorSimulator.assemble_device``: on the card one
    kernel launch a batch) and copied to the host behind the next batch's
    step; one background thread finishes the copies and writes (a bounded
    queue, batches in order; its first exception is raised here). The
    writer takes packed rows (``write_packed``, SpyralWriterProc, whose
    child assembles them on the host), assembled rows
    (``write_spyral_pool``, SpyralWriter; on the card it gets views of
    page-locked buffers, which the driver reuses after the call unless the
    writer kept the arrays) or, lacking both, each event's raw [pad, tb,
    electrons] cloud (``write``, the reference ``SimulationWriter``
    protocol; the "cloud" overflow doubles ``cloud_cap``). The writer is closed on every
    exit; one with ``get_directory_name`` gets a run manifest there.
    ``show_progress`` shows a tqdm bar where tqdm is installed;
    ``ATTPC_TPU_TIMING`` prints the budgets and phase times to stderr.

    Returns {"events": n, "rows": Spyral rows kept, "budgets": the final
    budgets, "phase_seconds": wall seconds by phase ("init": from the call
    to the first read; then each batch's "read", "dispatch", "pull-meta",
    "assemble-device" and "pull-start" on this thread, "pull-spyral" and
    "h5py-write" on the writer thread), "counters", "spans"}. The run
    manifest holds the counters and spans too.

    "counters", always kept: "syncs", the host's waits on the device by
    site ("pull-meta": a batch's metadata; "cloud-overflow": the raw cloud's
    pool overflow; "assemble": ``simulate_batch(assemble=True)``;
    "copy-finish": the writer thread's wait for a batch's copy; "retry":
    before a batch runs again, the wait for the batch dispatched after it
    on its device; over several devices each site carries the card's name,
    "pull-meta.card-1", "copy-finish.card-1");
    "pinned_allocs" and "pinned_bytes", the page-locked buffers allocated
    for the copies to the host; "retries", the batches run again, by the
    budget that overflowed; "batches", the batches read while a torch
    profiler recorded; over several devices "shard.events", the events
    each card ran, by card ("card-0", ...); in the default configuration
    (``merge="sorts"``, ``lookup="two_stage"``), whose merge sort takes
    K3's live route over each event's point prefix (``sort_cuda.
    sort_rows_live``), counted from each step's metadata: "merge_sort.lanes",
    the prefixes' lanes (min(n_points, point_budget) * 100 an event),
    "merge_sort.width_lanes", the rows' lanes (point_budget * 100 an
    event), and "merge_sort.rows", the events by the route their prefix
    takes on the card (``sort_cuda.live_sites``: "cluster-1" ...
    "cluster-8", "wide", "empty"); "fano.draws", each step's Fano draws
    (steps x events x tracks) by where they were made: "kernel"
    (``fano_cuda``, on the card) or "plain" (``fano_noise``, or the
    caller's noise); "step.graph", the steps on the card that may run as a
    CUDA graph (``step_graph.py``), by how they ran: "eager" (the first at
    its budgets), "capture" (the second, captured and run) or "replay";
    "driver.ahead", the batches by what was in flight at their dispatch:
    "queued" (the batch before, not yet pulled) or "serial" (nothing: the
    probe, the batch after it, a run's first batch).

    "spans", while a torch profiler records (``utils.trace_to``; empty
    without one): each span's host seconds, count and, for a step stage
    on the card, the seconds the stream spent between the stage's two
    CUDA events (else None), by name: the phases above, and the stages of
    each "dispatch" (``DetectorSimulator.simulate_batch``): "step.prepare"
    (the initial gamma*beta and its copy to the device), "step.transport",
    "step.fano" (the Fano draws and the electrons), "step.deposit" (the
    points' compaction and their pixel rows), "step.merge" (the merge of
    equal (pad, tb) keys) and "step.convert" (threshold, z order and the
    pooled rows). Each is also a ``record_function`` range of the trace;
    ``utils.profiling.last_run()`` holds the last call's spans themselves.
    Over several devices each card's thread (its span's ``thread``,
    "card-<k>") has, for each batch, in place of "dispatch": a
    "shard.step" span of the batch, timed on the card's stream from before
    the shard's dispatch to after the assembly of the shard in flight,
    around "shard.dispatch" (the shard's ``simulate_batch``, with the
    stages inside it timed on the card's stream), and the "pull-meta" and
    "assemble-device" of the shard in flight (of the batch before, once
    the budgets are tuned), and its "shard.turn"
    spans, one for each stretch of the thread's host work between its
    waits on the card and for its turn (``utils.profiling``), timed on the
    card's stream from the turn's start to the end of the work launched in
    it; "pull-start" (the copies of every card's rows into one page-locked
    buffer) stays on this thread.
    """
    from ..io.kinematics_file import KinematicsReader

    try:
        require_devices(device)
        reader = KinematicsReader(input_path)
    except BaseException:
        writer.close()
        raise
    return run_reader(config, reader, writer, indices=indices, engine=engine,
                      seed=seed, show_progress=show_progress,
                      start_event=start_event, stop_event=stop_event,
                      auto_tune=auto_tune, device=device,
                      input_name=str(input_path))
