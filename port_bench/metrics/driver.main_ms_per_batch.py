"""Milliseconds a batch on the driver's main thread (``run_reader``'s
``read``, ``dispatch``, ``pull-meta``, ``assemble-device`` and
``pull-start`` phases), less the tracer's own time in ``read``."""


def read(run):
    if not run.batches:
        return None
    return 1e3 * sum(run.phase_seconds.get(k, 0.0)
                     for k in run.main_phases) / run.batches
