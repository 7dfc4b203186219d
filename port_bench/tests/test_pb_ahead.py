"""The reader of the port's ``driver.ahead`` counter,
``metrics/driver.ahead_share.py``, on recorders made by hand: the share of
the traced batches dispatched with the batch before them in flight, and
nothing where the port keeps no such counter (a port from before it) or
nothing was traced."""

from types import SimpleNamespace

import pytest

from pbench import cells
from pbench.trace import Trace


def trace(kernels: bool = True) -> Trace:
    events = [("cpu_op", "aten::empty", 0, 5)]
    if kernels:
        events.append(("kernel", "rk4_window_kernel(float*)", 10, 30))
    return Trace.from_chrome({"traceEvents": [
        {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        for cat, name, ts, dur in events]}, batches=2, dispatches=[])


def recorder(ahead=None, batches: int = 24, step: bool = True):
    traced = {"syncs": {"pull-meta": batches}, "pinned_allocs": 0,
              "pinned_bytes": 0, "retries": {}, "batches": batches}
    if ahead is not None:
        traced["driver.ahead"] = ahead
    spans = [SimpleNamespace(name="step.transport" if step else "dispatch",
                             start_ns=0, end_ns=1, device_s=None)]
    return SimpleNamespace(spans=spans, traced=traced)


def read(run):
    return cells.metric_reader("driver.ahead_share")(run)


@pytest.mark.parametrize("ahead,share", [
    ({"queued": 24}, 1.0),
    ({"queued": 23, "serial": 1}, 23 / 24),
    ({"serial": 2, "queued": 4}, 4 / 6),
    ({"serial": 3}, 0.0),
])
def test_the_share_of_batches_queued_behind_one_in_flight(ahead, share):
    run = SimpleNamespace(trace=trace(), batches=26,
                          recorder=recorder(ahead))
    assert read(run) == pytest.approx(share)


def test_nothing_from_a_port_without_the_counter():
    """A port that counts nothing at ``driver.ahead`` (one from before
    it) gives nothing, and does not raise."""
    assert read(SimpleNamespace(trace=trace(), batches=26,
                                recorder=recorder())) is None
    assert read(SimpleNamespace(trace=trace(), batches=26,
                                recorder=recorder({}))) is None


def test_nothing_without_a_recorder_a_trace_or_a_traced_batch():
    ahead = {"queued": 24}
    assert read(SimpleNamespace(trace=trace(), batches=26,
                                recorder=None)) is None
    assert read(SimpleNamespace(trace=None, batches=26,
                                recorder=recorder(ahead))) is None
    assert read(SimpleNamespace(trace=trace(), batches=26,
                                recorder=recorder(ahead, batches=0))) is None
    with pytest.raises(RuntimeError, match="no step span"):
        read(SimpleNamespace(trace=trace(), batches=26,
                             recorder=recorder(ahead, step=False)))
