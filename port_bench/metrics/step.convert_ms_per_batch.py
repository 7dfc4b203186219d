"""Milliseconds a traced batch of the step's stage ``step.convert``: the
convert (``_finish``: threshold, key packing, the convert sort, the pool,
``meta_i32``). The stream's time between the stage span's two CUDA events, its
kernels and the idle between them, summed over the batches the profiler
recorded and divided by their count (``pbench/spans.py``)."""

from pbench import spans


def read(run):
    return spans.stage_ms_per_batch(run, "step.convert")
