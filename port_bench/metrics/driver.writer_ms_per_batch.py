"""Milliseconds a batch on the driver's writer thread (``pull-spyral``:
the wait for the rows' copy; ``h5py-write``: the sink's own work)."""


def read(run):
    if not run.batches:
        return None
    return 1e3 * sum(run.phase_seconds.get(k, 0.0)
                     for k in run.writer_phases) / run.batches
