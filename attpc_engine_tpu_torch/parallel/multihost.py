"""One process per GPU: one detector run spread over several processes
(port of attpc_engine_tpu/parallel/multihost.py).

The workload is parallel over events and every random stream is keyed by
the global event id, so the decomposition needs no collectives and no
``torch.distributed``:

- each process owns one contiguous slice of the kinematics file's events,
- simulates it on its own card with the port's ``run_simulation``,
- and writes its own run files through its own ``SpyralWriterProc``, with
  disjoint run numbers (``first_run_number = process_id * stride``).

The union of all processes' run files equals, event for event and bit for
bit, a single-process run with the same seed (tests/test_torch_parallel.py),
which is also what makes the split restartable per process. Start the
processes with ``torchrun --nproc-per-node N`` or with ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK`` set by hand; each calls
``run_simulation_multihost`` with the same arguments.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import NamedTuple

import torch

from ..kernels import require_device

__all__ = ["ProcessPlan", "process_plan", "resolve_process",
           "run_simulation_multihost"]


def _scan_resume_block(
    output_dir: Path, first_run: int, stride: int
) -> tuple[int | None, int, list[Path]]:
    """Walk this process's run-number block for a crash-resume point
    (multihost.py:40-85).

    Returns ``(resume_event, n_closed, stale)``: the global event id to
    restart from (``None`` when no durable file exists), how many
    consecutive properly-closed run files lead up to it, and the paths of
    any files after them (unreadable or never-closed partials from the
    crash, or files orphaned beyond a partial) that must be deleted before
    rewriting.

    A file is durable iff its ``cloud`` group carries the ``max_event``
    attr: the writers write attrs only in ``close()``, and ``run_simulation``
    closes its writer even when unwinding on an exception; a file from a
    hard-killed process has no attrs (usually it is not even readable
    HDF5). Under-full closed files are still durable (an interrupted run's
    final file legitimately holds fewer than ``max_events_per_file``
    events), so the walk continues past them.
    """
    import h5py

    n = 0
    resume_event: int | None = None
    while n < stride:
        path = output_dir / f"run_{first_run + n:04d}.h5"
        if not path.exists():
            break
        try:
            with h5py.File(path, "r") as f:
                last = int(f["cloud"].attrs["max_event"])
        except (OSError, KeyError):
            break  # crash partial: not closed (or not even HDF5)
        resume_event = last + 1
        n += 1
    stale = [
        p
        for i in range(n, stride)
        if (p := output_dir / f"run_{first_run + i:04d}.h5").exists()
    ]
    return resume_event, n, stale


class ProcessPlan(NamedTuple):
    """A process's share of a run: the events ``[start, stop)`` it
    simulates (empty where ``start == stop``), the run number of its first
    file, and the files of an interrupted run it must delete first."""

    start: int
    stop: int
    first_run: int
    stale: list[Path]


def resolve_process(
    process_id: int | None = None,
    num_processes: int | None = None,
    device: torch.device | str | None = None,
) -> tuple[int, int, torch.device]:
    """(process id, number of processes, device) of this process: the
    arguments where given, else ``RANK`` and ``WORLD_SIZE`` as ``torchrun``
    sets them (0 and 1 where unset), and ``cuda:{LOCAL_RANK}`` (0 where
    unset). Raises ValueError if the id is outside ``[0, num_processes)``;
    a CUDA device where torch finds none raises RuntimeError: nothing falls
    back to the CPU."""
    env = os.environ
    pid = int(env.get("RANK", 0)) if process_id is None else process_id
    nproc = (int(env.get("WORLD_SIZE", 1)) if num_processes is None
             else num_processes)
    if not 0 <= pid < nproc:
        raise ValueError(f"process_id {pid} outside [0, {nproc})")
    if device is None:
        device = f"cuda:{int(env.get('LOCAL_RANK', 0))}"
    return pid, nproc, require_device(device)


def process_plan(
    n_events: int,
    process_id: int,
    num_processes: int,
    *,
    max_events_per_file: int = 5_000,
    run_number_stride: int = 10_000,
    resume_dir: Path | str | None = None,
) -> ProcessPlan:
    """Process ``process_id``'s slice of ``n_events`` events, with the JAX
    driver's arithmetic (multihost.py:150-184): ``ceil(n_events /
    num_processes)`` events a process, run numbers from ``process_id *
    run_number_stride``. With ``resume_dir`` the process's run-number
    block there is scanned (``_scan_resume_block``): the slice restarts at
    the last durable file's ``max_event + 1`` with the next run number, and
    the files beyond it are returned as ``stale``; a slice already
    complete is returned empty at its stop, with nothing stale. The files
    are not touched here.

    Raises ValueError if ``process_id`` is outside ``[0, num_processes)``,
    or if the slice could need more run files than the block has left.
    """
    pid, nproc = process_id, num_processes
    if not 0 <= pid < nproc:
        raise ValueError(f"process_id {pid} outside [0, {nproc})")
    per_proc = math.ceil(n_events / nproc)
    start = pid * per_proc
    stop = min(n_events, start + per_proc)
    first_run = pid * run_number_stride
    if start >= stop:
        return ProcessPlan(start, start, first_run, [])
    stale: list[Path] = []
    if resume_dir is not None:
        resume_event, n_closed, stale = _scan_resume_block(
            Path(resume_dir), first_run, run_number_stride
        )
        if resume_event is not None:
            start = max(start, resume_event)
        if start >= stop:
            return ProcessPlan(stop, stop, first_run, [])  # slice complete
        first_run += n_closed

    # files hold up to max_events_per_file events each, regardless of
    # striping (striped children share one global run counter: child i
    # owns runs first+i, first+i+n_shards, ...)
    max_files = math.ceil((stop - start) / max_events_per_file)
    runs_left = run_number_stride - (first_run - pid * run_number_stride)
    if max_files > runs_left:
        raise ValueError(
            f"process {pid} may write {max_files} run files but its "
            f"run-number block has {runs_left} left; raise "
            "run_number_stride or max_events_per_file"
        )
    return ProcessPlan(start, stop, first_run, stale)


def run_simulation_multihost(
    config,
    input_path: Path | str,
    output_dir: Path | str,
    *,
    seed: int,
    indices: list[int] | None = None,
    engine=None,
    writer_shards: int = 1,
    max_events_per_file: int = 5_000,
    run_number_stride: int = 10_000,
    compression: str | None = None,
    show_progress: bool = False,
    process_id: int | None = None,
    num_processes: int | None = None,
    resume: bool = False,
    device: torch.device | str | None = None,
) -> tuple[int, int]:
    """Run this process's slice of a detector simulation on its card.

    Call from every process of the job with the same arguments; every
    process must pass the SAME ``seed``: all random streams are keyed by
    the seed and the global event id, so the union of the processes'
    outputs is bit-identical to a single-process run.

    Parameters mirror ``run_simulation`` plus:

    writer_shards: this process's striped writer children
        (``SpyralWriterProc(n_shards=...)``).
    run_number_stride: run-number block per process. Process ``p`` writes
        run files ``p * stride, p * stride + 1, ...``; a guard raises if
        its event slice could need more files than the block holds.
    process_id / num_processes: default to ``RANK`` / ``WORLD_SIZE``
        (``resolve_process``).
    resume: continue an interrupted run of the SAME configuration (seed,
        slicing, file and stride parameters). The process's run-number
        block is scanned for durable (properly closed) run files; the
        simulation restarts at the last durable file's ``max_event + 1``
        with the next run number, after deleting any crash partials beyond
        it (``process_plan``). The result is bit-identical to an
        uninterrupted run.
    device: defaults to ``cuda:{LOCAL_RANK}``; a process with no card
        raises before any work.

    Returns ``(start, stop_event)``: the events this call simulated
    (empty: ``(stop, stop)``, filesystem untouched).
    """
    from ..detector.simulator import run_simulation
    from ..detector.writer import SpyralWriterProc
    from ..io.kinematics_file import KinematicsReader

    pid, nproc, device = resolve_process(process_id, num_processes, device)
    reader = KinematicsReader(input_path)
    try:
        n_events = reader.n_events
    finally:
        reader.close()
    plan = process_plan(
        n_events, pid, nproc, max_events_per_file=max_events_per_file,
        run_number_stride=run_number_stride,
        resume_dir=output_dir if resume else None,
    )
    if plan.start >= plan.stop:
        return (plan.start, plan.stop)
    for p in plan.stale:
        p.unlink()
    writer = SpyralWriterProc(
        output_dir,
        config,
        max_events_per_file=max_events_per_file,
        first_run_number=plan.first_run,
        compression=compression,
        n_shards=writer_shards,
    )
    run_simulation(
        config,
        input_path,
        writer,
        indices=indices,
        engine=engine,
        seed=seed,
        show_progress=show_progress,
        start_event=plan.start,
        stop_event=plan.stop,
        device=device,
    )
    return (plan.start, plan.stop)
