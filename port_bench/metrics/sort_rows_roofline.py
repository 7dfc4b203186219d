"""K3 (``csrc/sort_cluster.cu``, and ``csrc/merge_rows.cu`` on its wide
route) against its byte bound, in percent: each lane of each row the
traced steps handed it (the merge sort and the convert sort a step, at
the budgets of each step) read once and written once, over 3.35 TB/s,
divided by the device time of its kernels in the trace."""


def read(run):
    t = run.trace
    us = t.kernel_us(run.kernel_names["sort_rows"]) if t is not None else 0.0
    if us <= 0:
        return None
    if not t.dispatches:
        raise RuntimeError("the trace holds the kernel but no step was "
                           "recorded: the window no longer goes through "
                           "DetectorSimulator.simulate_batch")
    n_bytes = sum(run.roofline.dispatch_sort_bytes(*d) for d in t.dispatches)
    return 100.0 * run.roofline.bound_s(n_bytes) / (us * 1e-6)
