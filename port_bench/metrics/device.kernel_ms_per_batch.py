"""Summed device time of every kernel of the traced batches, in ms a
batch."""


def read(run):
    t = run.trace
    if t is None or not t.batches or not t.kernels:
        return None
    return 1e-3 * t.kernel_us() / t.batches
