"""The general sink: it holds copies (never the driver's lent buffers),
lets them go after ``hold_events``, keeps the sampled and the longest
events, and counts lost, repeated and malformed events."""

import gc
import weakref

import numpy as np

from pbench.sink import Sink

KEEP = {"hold_events": 6}
DISCARD = {"hold_events": 0}


def batch(first: int, counts):
    counts = np.asarray(counts)
    spyral = np.arange(8 * counts.sum(), dtype=np.float64).reshape(-1, 8)
    labels = np.arange(counts.sum(), dtype=np.int64)
    return spyral, labels, counts, np.arange(first, first + len(counts))


def test_keep_holds_copies_and_lets_them_go():
    sink = Sink(KEEP, 8, [1, 6])
    spyral, labels, counts, events = batch(0, [2, 3, 1, 4])
    lent = weakref.ref(spyral)
    sink.write_spyral_pool(spyral, labels, counts, events)
    del spyral, labels
    gc.collect()
    assert lent() is None  # the lent buffer is not kept
    assert sink.held_events == 4 and len(sink.held) == 1
    sink.write_spyral_pool(*batch(4, [1, 5, 0, 2]))
    assert sink.held_events == 0 and sink.held == []  # 8 >= 6: let go
    kept = sink.kept()
    assert set(kept) == {1, 6, 5}  # the sampled ones and the longest
    assert len(kept[1][0]) == 3 and len(kept[5][0]) == 5
    assert sink.events == 8 and sink.missing() == 0 and sink.malformed == 0


def test_discard_keeps_only_the_sample_and_counts_faults():
    sink = Sink(DISCARD, 6, [0])
    sink.write_spyral_pool(*batch(0, [2, 3]))
    assert sink.held == []
    sink.write_spyral_pool(*batch(1, [1, 1]))  # event 1 again, event 2
    spyral, labels, counts, events = batch(4, [2, 2])
    sink.write_spyral_pool(spyral[:3], labels[:3], counts, events)
    assert sink.malformed == 1
    # events 3, 4, 5 never came and event 1 came twice
    assert sink.missing() == 4
    assert list(sink.kept()) == [0, 1]

