"""The one general sink of the benchmark, shaped by a traffic file.

A ``write_spyral_pool`` writer for the port's ``run_reader``. Where the
traffic's ``hold_events`` is above 0 it keeps each batch's Spyral rows and
labels as host arrays of its own, copied out of the driver's lent
page-locked buffers (so that they go back to the driver's pool), and lets
them go once ``hold_events`` events have gathered: one output file of the
port's ``SpyralWriter`` (``max_events_per_file``), less the HDF5 write.
Where it is 0, the sink checks the shapes and counts and keeps nothing
else. Either way it keeps a copy of the rows of the sampled events, and of
the event with the most rows so far, for the comparison with the
reference, and counts every event it receives by its id."""

from __future__ import annotations

import numpy as np


class Sink:
    def __init__(self, traffic: dict, n_events: int, sample_ids):
        self.hold_events = int(traffic["hold_events"])
        self.sample_ids = np.asarray(sorted(sample_ids), dtype=np.int64)
        self.seen = np.zeros(n_events, dtype=np.int32)
        self.held: list = []
        self.held_events = 0
        self.sampled: dict = {}
        self.longest = (-1, None)  # (event id, (spyral, labels))
        self.rows = 0
        self.malformed = 0
        self.closed = False

    def write_spyral_pool(self, spyral, labels, counts, event_numbers,
                          raw_counts=None):
        counts = np.asarray(counts, dtype=np.int64)
        events = np.asarray(event_numbers, dtype=np.int64)
        total = int(counts.sum())
        if (spyral.shape != (total, 8) or labels.shape != (total,)
                or len(events) != len(counts)):
            self.malformed += 1
            return
        offsets = np.concatenate([[0], np.cumsum(counts)])
        inside = (events >= 0) & (events < len(self.seen))
        np.add.at(self.seen, events[inside], 1)
        self.malformed += int((~inside).sum())
        for i in np.nonzero(np.isin(events, self.sample_ids))[0]:
            lo, hi = offsets[i], offsets[i + 1]
            self.sampled[int(events[i])] = (spyral[lo:hi].copy(),
                                            labels[lo:hi].copy())
        if len(counts):
            j = int(np.argmax(counts))
            if self.longest[1] is None or counts[j] > len(self.longest[1][0]):
                lo, hi = offsets[j], offsets[j + 1]
                self.longest = (int(events[j]), (spyral[lo:hi].copy(),
                                                 labels[lo:hi].copy()))
        if self.hold_events > 0:
            self.held.append((spyral.copy(), labels.copy()))
            self.held_events += len(counts)
            if self.held_events >= self.hold_events:
                self.held, self.held_events = [], 0
        self.rows += total

    @property
    def events(self) -> int:
        return int((self.seen > 0).sum())

    def missing(self) -> int:
        """Events never received, plus events received more than once."""
        return int((self.seen == 0).sum() + np.clip(self.seen - 1, 0,
                                                    None).sum())

    def kept(self) -> dict:
        """{event id: (spyral, labels)} of the sampled and longest events."""
        out = dict(self.sampled)
        if self.longest[1] is not None:
            out[self.longest[0]] = self.longest[1]
        return out

    def close(self) -> None:
        self.held, self.held_events = [], 0
        self.closed = True
