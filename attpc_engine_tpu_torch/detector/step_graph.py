"""The default detector step as one CUDA graph a budget key.

``DetectorSimulator.simulate_batch`` hands its default step (on a CUDA
device, no noise given, no raw cloud pooled, ``merge="sorts"`` with
``lookup="two_stage"``) to the simulator's ``StepGraphs``, keyed by the
device, the batch's events and its point, uniq, out and steps budgets:

- the first call at a key runs the step eagerly (counter ``step.graph`` at
  site ``eager``) and drops the graph of any other key, so that a card
  holds one graph's memory pool;
- the second call in a row at the key captures the step, from the inputs
  on the device through ``meta_i32``, into a CUDA graph and runs it once
  (``capture``);
- every later call at the key copies the batch's inputs into the graph's
  static inputs and replays it (``replay``): one launch for the step's
  ~100 kernels and PyTorch passes, and no host sync in between, as the
  transport windows are gated on the card (``transport.integrate_tracks``)
  and the Fano kernel reads the batch's seed and first event id from the
  inputs (``fano_cuda.fano_words``).

A key seen once (a short last batch, a retry's doubled budget) never pays
for a capture. A captured step's Python runs once, under a
``profiling.Tape``: what it counts (``fano.draws``) is counted again at
every run of the graph, and its stages (``step.transport`` ...
``step.convert``) are timed by event-record nodes of the graph at every
run. The kernels' ``launches`` counters of the wrappers (``transport_cuda``,
``fano_cuda``, ``deposit_cuda``, ``sort_cuda``, ``compact_cuda``,
``merge_cuda``) count a graph's launches once for each run too.

The outputs of a replay are the graph's static tensors: the next replay at
the key overwrites them once the stream reaches it, so a caller reads them,
or queues on the current stream the work that reads them, before its next
call (``driver.py`` queues copies of what it pulls behind each dispatch,
as it dispatches the next batch before it pulls this one).

The capture runs on a side stream of the card in
``capture_error_mode="thread_local"``, so that the host work of other
threads (the writer thread's waits, other cards' threads) does not break
it. ``backend`` stands in for CUDA where tests drive the key's life on the
CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils import profiling
from . import (
    compact_cuda,
    deposit_cuda,
    fano_cuda,
    merge_cuda,
    sort_cuda,
    transport_cuda,
)

__all__ = ["StepGraphs", "CudaBackend"]

# the wrappers whose module-level ``launches*`` counters a graph's runs add to
_COUNTED = (transport_cuda, fano_cuda, deposit_cuda, sort_cuda, compact_cuda,
            merge_cuda)


def _launch_counts() -> dict:
    return {(m, name): value for m in _COUNTED
            for name, value in vars(m).items()
            if name.startswith("launches") and isinstance(value, int)}


class CudaBackend:
    """Capture and replay on one card: the capture on a side stream of the
    card (made on the first capture), after the work queued on the current
    stream, with timing events the graph records at each run."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream: torch.cuda.Stream | None = None

    def capture(self, step, inputs: torch.Tensor):
        """(graph, outputs) of ``step(inputs)`` captured, not run."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        here = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(here)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = step(inputs)
            finally:
                graph.capture_end()
        here.wait_stream(self.stream)
        return graph, outputs

    @staticmethod
    def replay(graph) -> None:
        """Launch ``graph`` on the current stream."""
        graph.replay()

    @staticmethod
    def event() -> torch.cuda.Event:
        """A timing event that a graph captured after it records at each
        run."""
        return torch.cuda.Event(enable_timing=True, external=True)


@dataclass(eq=False)
class _Graph:
    """A captured step: its key, graph, static inputs and outputs, tape,
    and the kernel launches a run makes (by wrapper counter)."""

    key: tuple
    graph: object
    inputs: torch.Tensor
    outputs: dict
    tape: profiling.Tape
    launches: dict


class StepGraphs:
    """The default step's graph of one simulator, for one key at a time
    (the module's docstring). ``backend``: ``CudaBackend`` of ``device``
    unless given."""

    def __init__(self, device: torch.device, backend=None):
        self.device = device
        self.backend = backend if backend is not None else CudaBackend(device)
        self.last: tuple | None = None  # the key of the previous call
        self.held: _Graph | None = None

    def forget(self) -> None:
        """Drop the held graph and the last key: the tensors a graph reads
        outside its inputs (the simulator's tables) are about to change."""
        self.last = self.held = None

    def inputs(self, key: tuple, host: torch.Tensor) -> torch.Tensor:
        """The batch's inputs ``host`` on the device for a call at ``key``:
        copied into the static inputs of the graph held at the key, else
        into a new tensor (which a capture makes the graph's)."""
        held = self.held
        if held is not None and held.key == key:
            return held.inputs.copy_(host, non_blocking=True)
        return host.to(self.device, non_blocking=True)

    def run(self, key: tuple, inputs: torch.Tensor, step) -> dict:
        """``step(inputs)``'s outputs at ``key``, with ``inputs`` from
        ``self.inputs(key, ...)``: run eagerly, captured and run, or
        replayed (the module's docstring). A replay's outputs are the
        graph's static tensors, in a new dict."""
        held = self.held
        if held is not None and held.key == key:
            self.backend.replay(held.graph)
            for (module, name), n in held.launches.items():
                setattr(module, name, getattr(module, name) + n)
            held.tape.play()
            profiling.count("step.graph", "replay")
            return dict(held.outputs)
        self.held = None  # another key's graph and its pool go
        if self.last != key:
            self.last = key
            profiling.count("step.graph", "eager")
            return step(inputs)
        before = _launch_counts()
        tape = profiling.Tape(self.backend.event)
        with profiling.taping(tape):
            graph, outputs = self.backend.capture(step, inputs)
        launches = {k: v - before.get(k, 0)
                    for k, v in _launch_counts().items()
                    if v != before.get(k, 0)}
        self.held = _Graph(key, graph, inputs, outputs, tape, launches)
        # the capture counted the launches once: this run's
        self.backend.replay(graph)
        tape.play()
        profiling.count("step.graph", "capture")
        return dict(outputs)
