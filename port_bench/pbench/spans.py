"""The port's own spans and counters, for the per-layer metrics of the
step's stages, the device's idle time and the driver's syncs and
page-locked memory.

They come from the recorder of the window's ``run_reader`` call
(``attpc_engine_tpu_torch.utils.profiling.last_run()``; the window's call
is the last one before the readers run), which keeps them over the
batches the profiler recorded. A port that keeps no recorder gives None,
and its readers report nothing.

The spans' times are Unix nanoseconds on the profiler's clock. Kineto
writes a trace's times in microseconds from a base, the Unix seconds
rounded down to a multiple of 7,889,238 (a quarter of a year): ts_us =
unix_ns / 1e3 - base_us (torch's ``torch/profiler/_cupti_monitor_trace.py``,
``_default_base_ns``).
"""

from __future__ import annotations

from .trace import clip, union

TRIMESTER_NS = 7_889_238 * 10**9
STAGES = ("step.transport", "step.fano", "step.deposit", "step.merge",
          "step.convert")
WRITER_SITES = ("copy-finish",)  # the syncs of the driver's writer thread


def base_ns(unix_ns: int) -> int:
    """Kineto's trace base of a Unix time, in nanoseconds."""
    return unix_ns // TRIMESTER_NS * TRIMESTER_NS


def trace_us(unix_ns: int, base: int) -> float:
    """A Unix time on the trace's time base, in microseconds."""
    return (unix_ns - base) * 1e-3


def trace_base(spans, trace) -> int:
    """The base of ``trace``: that of the first span's start, or the one
    before it where the profiler started before a boundary that the spans
    are past (the one that puts the first span nearer the trace's start)."""
    first = min(s.start_ns for s in spans)
    lo, _ = trace.span()
    b = base_ns(first)
    return min((b, b - TRIMESTER_NS),
               key=lambda c: abs(trace_us(first, c) - lo))


def recorder(run):
    """``run.recorder`` where the run holds one, else the port's recorder
    of its last ``run_reader`` call; None where the port keeps none."""
    if hasattr(run, "recorder"):
        return run.recorder
    try:
        from attpc_engine_tpu_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_run", None)
    return last() if last is not None else None


def traced(run):
    """The recorder, where it recorded step spans over the traced batches;
    None where there is nothing to read. Raises where the trace holds
    kernels but the recorder no step span: the window would no longer go
    through the spans."""
    rec, t = recorder(run), run.trace
    if rec is None or t is None:
        return None
    if not any(s.name.startswith("step.") for s in rec.spans):
        if t.kernels:
            raise RuntimeError("the trace holds kernels but the port "
                               "recorded no step span: the window no "
                               "longer goes through run_reader's and "
                               "simulate_batch's spans")
        return None
    return rec if rec.traced["batches"] else None


def stage_ms_per_batch(run, stage: str):
    """The stream's milliseconds between the stage's two CUDA events,
    summed over the traced batches, a batch."""
    rec = traced(run)
    if rec is None:
        return None
    times = [s.device_s for s in rec.spans
             if s.name == stage and s.device_s is not None]
    if not times:
        return None
    return 1e3 * sum(times) / rec.traced["batches"]


def idle_split_us(trace, intervals) -> tuple[float, float]:
    """The trace's device idle time inside and outside ``intervals``
    (trace microseconds), in microseconds."""
    gaps = trace.gaps()
    inside = sum(b - a for lo, hi in union(intervals)
                 for a, b in clip(gaps, lo, hi))
    return inside, sum(b - a for a, b in gaps) - inside


def idle_ms_per_batch(run, inside: bool):
    """The device's idle milliseconds a traced batch inside, or outside,
    the main thread's ``dispatch`` spans."""
    rec, t = traced(run), run.trace
    if rec is None or not t.device or not t.batches:
        return None
    steps = [s for s in rec.spans if s.name == "dispatch"]
    if not steps:
        return None
    base = trace_base(rec.spans, t)
    split = idle_split_us(t, [(trace_us(s.start_ns, base),
                               trace_us(s.end_ns, base)) for s in steps])
    return 1e-3 * split[0 if inside else 1] / t.batches
