"""Megabytes of page-locked host memory that the driver's host copies
(``_HostCopies.start``) allocated afresh a traced batch: the port's
``pinned_bytes`` counter while the profiler recorded, over the batches it
recorded."""

from pbench import spans


def read(run):
    rec = spans.traced(run)
    if rec is None:
        return None
    return 1e-6 * rec.traced["pinned_bytes"] / rec.traced["batches"]
