"""The run-end compaction (``csrc/compact_runs.cu``: its totals, carry and
write kernels) against its byte bound, in percent: the sorted merge rows of
each traced step read once and its cap slots written (``pbench/roofline.py``
``dispatch_compact_bytes``, at the budgets of each step), over 3.35 TB/s,
divided by the device time of its three kernels in the trace."""


def read(run):
    t = run.trace
    us = t.kernel_us(run.kernel_names["compact_runs"]) if t is not None else 0.0
    if us <= 0:
        return None
    if not t.dispatches:
        raise RuntimeError("the trace holds the kernel but no step was "
                           "recorded: the window no longer goes through "
                           "DetectorSimulator.simulate_batch")
    n_bytes = sum(run.roofline.dispatch_compact_bytes(*d) for d in t.dispatches)
    return 100.0 * run.roofline.bound_s(n_bytes) / (us * 1e-6)
