"""Milliseconds a traced batch in which the card was idle while the main
thread was inside a ``dispatch`` span (``DetectorSimulator.simulate_batch``:
launches, the transport's window checks and the host's own work in the
step): the trace's idle gaps clipped to the spans, put on the trace's time
base by Kineto's rule (``pbench/spans.py``)."""

from pbench import spans


def read(run):
    return spans.idle_ms_per_batch(run, inside=True)
