"""The readers of the port's spans and counters (``pbench/spans.py`` and
the nine metrics that read it) on a trace and a recorder made by hand:
the device's idle time split at the ``dispatch`` spans, the stages' CUDA
event times, the counters a batch, nothing where there is no recorder,
an error where the trace holds kernels but the recorder no step, and
Kineto's time base on both sides of a trimester boundary."""

from types import SimpleNamespace

import pytest

from pbench import cells, spans
from pbench.trace import Trace

STAGE_METRICS = [f"{s}_ms_per_batch" for s in spans.STAGES]
METRICS = STAGE_METRICS + ["device.idle_in_step_ms_per_batch",
                           "device.idle_between_steps_ms_per_batch",
                           "driver.syncs_per_batch",
                           "driver.pinned_mb_per_batch"]
T = spans.TRIMESTER_NS
BASE = 227 * T  # a trimester boundary in 2026


def chrome(events):
    return {"traceEvents": [
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        for cat, name, ts, dur in events]}


def span(name, start_us, end_us, device_s=None, base=BASE):
    """A span at trace microseconds on ``base``."""
    return SimpleNamespace(name=name, start_ns=base + int(start_us * 1e3),
                           end_ns=base + int(end_us * 1e3),
                           device_s=device_s)


def recorder(span_list, batches=2, syncs=None, pinned_bytes=0):
    return SimpleNamespace(spans=span_list, traced={
        "syncs": syncs or {}, "pinned_allocs": 1 if pinned_bytes else 0,
        "pinned_bytes": pinned_bytes, "retries": {}, "batches": batches})


def two_batches():
    """Two batches: dispatch [0, 100) and [200, 300) us on the host; the
    card busy [10, 40), [60, 90), [150, 170), [210, 290) of the traced
    window [0, 320)."""
    data = chrome([
        ("cpu_op", "aten::empty", 0, 5),
        ("kernel", "rk4_window_kernel(float*)", 10, 30),
        ("kernel", "radix_cluster_kernel(long long const*)", 60, 30),
        ("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 150, 20),
        ("kernel", "radix_cluster_kernel(long long const*)", 210, 80),
        ("cuda_runtime", "cudaStreamSynchronize", 300, 20),
    ])
    trace = Trace.from_chrome(data, batches=2, dispatches=[])
    steps = []
    for b, lo in ((0, 0), (4, 200)):
        steps += [span("step.transport", lo + 5, lo + 40, 0.030e-3),
                  span("step.fano", lo + 40, lo + 60, 0.010e-3),
                  span("step.deposit", lo + 60, lo + 70, 0.004e-3),
                  span("step.merge", lo + 70, lo + 90, 0.020e-3),
                  span("step.convert", lo + 90, lo + 99, 0.006e-3),
                  span("dispatch", lo, lo + 100)]
    steps += [span("read", 100, 110), span("pull-meta", 110, 190)]
    return trace, steps


def read(name, run):
    return cells.metric_reader(name)(run)


def test_idle_splits_at_the_dispatch_spans():
    trace, steps = two_batches()
    run = SimpleNamespace(trace=trace, batches=2,
                          recorder=recorder(steps, syncs={
                              "transport.window": 8, "pull-meta": 2,
                              "copy-finish": 4}, pinned_bytes=3_000_000))
    inside = read("device.idle_in_step_ms_per_batch", run)
    outside = read("device.idle_between_steps_ms_per_batch", run)
    # gaps [0, 10), [40, 60), [90, 150), [170, 210), [290, 320); dispatch
    # [0, 100) and [200, 300) hold 10 + 20 + 10 + 10 + 10 us of them
    assert inside == pytest.approx(1e-3 * 60 / 2)
    assert outside == pytest.approx(1e-3 * 100 / 2)
    idle = (1 - trace.busy_s() / trace.window_s()) * trace.window_s()
    assert (inside + outside) * 2e-3 == pytest.approx(idle, rel=0.01)
    assert read("driver.syncs_per_batch", run) == pytest.approx(5.0)
    assert read("driver.pinned_mb_per_batch", run) == pytest.approx(1.5)


def test_stage_ms_from_the_events_times():
    trace, steps = two_batches()
    run = SimpleNamespace(trace=trace, batches=2, recorder=recorder(steps))
    got = {m: read(m, run) for m in STAGE_METRICS}
    assert got == pytest.approx({
        "step.transport_ms_per_batch": 0.030,
        "step.fano_ms_per_batch": 0.010,
        "step.deposit_ms_per_batch": 0.004,
        "step.merge_ms_per_batch": 0.020,
        "step.convert_ms_per_batch": 0.006})


@pytest.mark.parametrize("name", METRICS)
def test_nothing_without_a_recorder_or_a_trace(name):
    trace, steps = two_batches()
    assert read(name, SimpleNamespace(trace=trace, batches=2,
                                      recorder=None)) is None
    assert read(name, SimpleNamespace(trace=None, batches=2,
                                      recorder=recorder(steps))) is None
    # no profiled batch, no kernel: nothing to read either
    quiet = Trace.from_chrome(chrome([("cpu_op", "aten::empty", 0, 5)]),
                              batches=1, dispatches=[])
    assert read(name, SimpleNamespace(trace=quiet, batches=1,
                                      recorder=recorder([]))) is None


@pytest.mark.parametrize("name", METRICS)
def test_kernels_but_no_step_span_raises(name):
    """Where the window stops going through the port's spans the readers
    say so rather than going silent."""
    trace, steps = two_batches()
    no_step = [s for s in steps if not s.name.startswith("step.")]
    run = SimpleNamespace(trace=trace, batches=2, recorder=recorder(no_step))
    with pytest.raises(RuntimeError, match="no step span"):
        read(name, run)


def test_a_port_without_a_recorder_reads_nothing(monkeypatch):
    """A port whose profiling module has no ``last_run`` (the parent of
    the spans) gives None, and each reader nothing."""
    from attpc_engine_tpu_torch.utils import profiling

    trace, _ = two_batches()
    monkeypatch.delattr(profiling, "last_run")
    run = SimpleNamespace(trace=trace, batches=2)
    assert spans.recorder(run) is None
    for name in METRICS:
        assert read(name, run) is None


def test_kineto_time_base_on_both_sides_of_a_trimester_boundary():
    assert spans.base_ns(BASE + 10**6) == BASE
    assert spans.base_ns(BASE - 10**6) == BASE - T
    assert spans.base_ns(BASE) == BASE
    assert spans.trace_us(BASE + 1_234_567, BASE) == pytest.approx(1234.567)
    # the profiler starts 2 ms before the boundary, its trace on the base
    # before it; the spans cross the boundary and keep that base
    start_us = T * 1e-3 - 2000.0
    trace = Trace.from_chrome(chrome([
        ("cpu_op", "aten::empty", start_us, 1),
        ("kernel", "rk4_window_kernel(float*)", start_us + 1000, 4000),
    ]), batches=1, dispatches=[])
    before = span("dispatch", -1500.0, 3000.0)  # on BASE: 1.5 ms before it
    stage = span("step.transport", 500.0, 2500.0, 0.002)
    assert spans.trace_base([before, stage], trace) == BASE - T
    assert spans.trace_us(stage.start_ns, BASE - T) == pytest.approx(
        T * 1e-3 + 500.0)
    # a trace that starts after the boundary takes the boundary's base
    late = Trace.from_chrome(chrome([("cpu_op", "aten::empty", 100.0, 1)]),
                             batches=1, dispatches=[])
    assert spans.trace_base([stage], late) == BASE
    # the card idles [start, start + 1000) us, within dispatch from 500
    run = SimpleNamespace(trace=trace, batches=1,
                          recorder=recorder([before, stage], batches=1))
    assert read("device.idle_in_step_ms_per_batch", run) == pytest.approx(
        0.5)
    assert read("device.idle_between_steps_ms_per_batch", run) == (
        pytest.approx(0.5))
