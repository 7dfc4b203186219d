"""Milliseconds a traced batch in which the card was idle while the main
thread was outside every ``dispatch`` span (the batch's read, its metadata
pull, the assembly's launch, the copies' start, the driver's own Python):
the trace's idle gaps less those inside the spans (``pbench/spans.py``)."""

from pbench import spans


def read(run):
    return spans.idle_ms_per_batch(run, inside=False)
