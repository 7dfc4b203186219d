"""Milliseconds a traced batch of the step's stage ``step.merge``: the merge
of equal (pad, tb) keys (``_merge_rows``: one K3 sort, then the run-end
compaction with its charge prefix). The stream's time between the stage
span's two CUDA events, its kernels and the idle between them, summed over
the batches the profiler recorded and divided by their count
(``pbench/spans.py``)."""

from pbench import spans


def read(run):
    return spans.stage_ms_per_batch(run, "step.merge")
