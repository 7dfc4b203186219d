"""The share of the traced batches dispatched while the batch before them
was still in flight: the port's ``driver.ahead`` counter, ``queued`` over
``queued`` and ``serial``, while the profiler recorded. Nothing where the
port keeps no such counter."""

from pbench import spans


def read(run):
    rec = spans.traced(run)
    if rec is None:
        return None
    ahead = rec.traced.get("driver.ahead")
    if not ahead:
        return None
    return ahead.get("queued", 0) / sum(ahead.values())
