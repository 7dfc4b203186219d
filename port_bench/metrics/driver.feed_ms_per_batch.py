"""Host milliseconds a traced batch that the card threads spend feeding
their cards: every card's ``shard.turn`` spans (each stretch of the
thread's host work between its waits on the card and for its turn at the
host: its launches, its pulls and the host's own work in the step),
summed over the cards and the batches the profiler recorded, over the
batches (``pbench/shards.py``)."""

from pbench import shards


def read(run):
    return shards.feed_ms_per_batch(run)
