"""Seconds of set-up from the kinematics' end to the window's start: the
warm-up ``run_reader`` call over the cell's ``warmup_batches`` (the port
loads its kernel library in its first launch there) and the window's
sink made ready."""


def read(run):
    return run.setup_seconds.get("warmup")
