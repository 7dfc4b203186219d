"""Seconds of set-up in the detector's ``Config`` and ``EngineParams``
(``pbench/runner.py`` ``port_config``): the port's detector modules
imported, the gas target's stopping tables and the pad plane's data read
(the step's device tables are built inside the warm-up)."""


def read(run):
    return run.setup_seconds.get("config")
