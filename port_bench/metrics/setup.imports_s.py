"""Seconds of set-up from the process's start to the CUDA context made:
Python's imports (torch, the benchmark's modules), torch's count of the
cards and the context, made by a synchronise before anything else touches
the card."""


def read(run):
    return run.setup_seconds.get("imports")
