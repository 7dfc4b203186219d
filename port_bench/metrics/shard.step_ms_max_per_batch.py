"""Milliseconds a traced batch of the slowest card's shard: each batch's
largest ``shard.step`` time on a card (its stream's time from before its
shard's dispatch to after its assembly, from a CUDA event pair, its waits
for a turn at the host included), averaged over the batches the profiler
recorded (``pbench/shards.py``)."""

from pbench import shards


def read(run):
    times = shards.step_times(run)
    if not times:
        return None
    return 1e3 * sum(max(t) for t in times) / len(times)
