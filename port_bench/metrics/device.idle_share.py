"""The share of the traced window in which no kernel, copy or set ran on
the card: 1 - (the union of the device intervals) / the window."""


def read(run):
    t = run.trace
    if t is None or t.window_s() <= 0 or not t.device:
        return None
    return 1.0 - t.busy_s() / t.window_s()
