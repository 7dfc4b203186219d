"""The card threads' spans of a run over several cards (``run_reader``
with more than one device), for the shard metrics.

Each card's thread ("card-<k>") records, for each batch:

- a ``shard.step`` span, timed on the card's stream by a CUDA event pair
  from before its shard's dispatch to after its assembly: the shard's
  whole time on the card, its waits for a turn at the host included;
- ``shard.turn`` spans, one for each stretch of the thread's host work
  between its waits on the card and for its turn at the host (the card
  threads take turns at one lock, which a thread gives up while it waits
  on its card). A turn's host time is host work only; its time on the
  card, from a CUDA event pair, runs from the turn's start to the end of
  the work launched in it, so it leaves out the card's idle time while its
  thread waits for a turn, and keeps the gaps between launches inside the
  turn.

They come from the recorder of the window's ``run_reader`` call
(``pbench/spans.py``), over the batches the profiler recorded. A run over
one card keeps none, and the readers report nothing.
"""

from __future__ import annotations

from . import spans


def recorder(run):
    """The recorder, where it holds card threads' spans of traced
    batches; else None."""
    rec = spans.recorder(run)
    if rec is None or not rec.traced.get("batches"):
        return None
    if not any(s.name == "shard.step" for s in rec.spans):
        return None
    return rec


def timed(run, name: str) -> list | None:
    """The traced spans ``name`` of the card threads, where every one is
    timed on its card; else None."""
    rec = recorder(run)
    if rec is None:
        return None
    out = [s for s in rec.spans if s.name == name]
    if not out or any(s.device_s is None for s in out):
        return None
    return out


def step_times(run) -> list | None:
    """Each traced batch's cards' ``shard.step`` seconds on the card."""
    out = timed(run, "shard.step")
    if out is None:
        return None
    by_batch: dict = {}
    for s in out:
        by_batch.setdefault(s.batch, []).append(s.device_s)
    return list(by_batch.values())


def busy(run) -> dict | None:
    """{batch: {card thread: seconds}}: each card's turns' time on the
    card in each traced batch."""
    out = timed(run, "shard.turn")
    if out is None:
        return None
    by_batch: dict = {}
    for s in out:
        cards = by_batch.setdefault(s.batch, {})
        cards[s.thread] = cards.get(s.thread, 0.0) + s.device_s
    return by_batch


def idle_shares(run) -> dict | None:
    """Each card's share of the traced batches' wall time (from the first
    ``shard.step`` span's start to the last one's end, on the host)
    outside its turns' time on the card, by card thread."""
    steps, by_batch = timed(run, "shard.step"), busy(run)
    if steps is None or by_batch is None:
        return None
    wall = 1e-9 * (max(s.end_ns for s in steps)
                   - min(s.start_ns for s in steps))
    total: dict = {}
    for cards in by_batch.values():
        for card, b in cards.items():
            total[card] = total.get(card, 0.0) + b
    return {card: 1.0 - b / wall for card, b in total.items()}


def feed_ms_per_batch(run) -> float | None:
    """The card threads' host milliseconds in their turns, all cards', a
    traced batch."""
    rec = recorder(run)
    if rec is None:
        return None
    ns = sum(s.end_ns - s.start_ns for s in rec.spans
             if s.name == "shard.turn")
    return 1e-6 * ns / rec.traced["batches"]
