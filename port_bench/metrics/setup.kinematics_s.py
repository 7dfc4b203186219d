"""Seconds of set-up in the window's kinematics (``pbench/inputs.py``
``Events``): the frozen pipeline sampled on the card and copied to
host arrays."""


def read(run):
    return run.setup_seconds.get("kinematics")
