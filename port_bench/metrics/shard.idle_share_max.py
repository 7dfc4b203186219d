"""The most idle card's share of the traced batches' wall time outside
its turns' time on the card (``shard.turn``: from each turn's start to
the end of the work launched in it, on the card's stream; the gaps between
launches inside a turn count as busy): the wall runs from the first traced
``shard.step`` span's start to the last one's end on the host
(``pbench/shards.py``)."""

from pbench import shards


def read(run):
    shares = shards.idle_shares(run)
    return None if not shares else max(shares.values())
