"""How uneven the cards' work is: each traced batch's largest time of a
card in its turns (``shard.turn``: from each turn's start to the end of
the work launched in it, on the card's stream, so the card's waits for a
turn at the host are left out) over the mean of its cards', averaged over
the batches the profiler recorded; 1.0 is even (``pbench/shards.py``)."""

from pbench import shards


def read(run):
    by_batch = shards.busy(run)
    if not by_batch:
        return None
    ratios = [max(c.values()) * len(c) / sum(c.values())
              for c in by_batch.values()]
    return sum(ratios) / len(ratios)
