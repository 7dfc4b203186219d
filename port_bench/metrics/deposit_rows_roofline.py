"""The deposit-rows kernel (``csrc/deposit_rows.cu``) against its byte
bound, in percent: ``rows_bytes`` of each traced step's events and point
budget over 3.35 TB/s, divided by the kernel's device time in the
trace."""


def read(run):
    t = run.trace
    us = t.kernel_us(run.kernel_names["deposit_rows"]) if t is not None else 0.0
    if us <= 0:
        return None
    if not t.dispatches:
        raise RuntimeError("the trace holds the kernel but no step was "
                           "recorded: the window no longer goes through "
                           "DetectorSimulator.simulate_batch")
    n_bytes = sum(run.roofline.rows_bytes(e, pb) for e, pb, _ in t.dispatches)
    return 100.0 * run.roofline.bound_s(n_bytes) / (us * 1e-6)
