"""Synthetic packed rows for the Spyral assembly's tests, with every edge
case the kernel and its plain version must take. Imports nothing of JAX:
tests/test_torch_assemble.py (against the JAX package on the CPU),
tests/test_torch_cuda.py and chip_smoke.py (the kernel on the card) share
it.

An event is a tuple (q, tb, pad, label) of arrays, packed as the detector
step packs its rows: the f32 bits of q, then tb << 22 | pad << 8 | label.
"""

import numpy as np


def pack(q, tb, pad, lab) -> np.ndarray:
    """[n, 2] int32 packed rows of one event."""
    meta = (np.asarray(tb, np.int64) << 22) | (np.asarray(pad, np.int64) << 8)
    meta |= np.asarray(lab, np.int64)
    return np.stack([np.asarray(q, np.float32).view(np.int32),
                     meta.astype(np.int32)], axis=1)


def pool(events) -> tuple[np.ndarray, np.ndarray]:
    """The events' rows pooled in event order, and their counts."""
    counts = np.array([len(e[0]) for e in events], dtype=np.int64)
    packed = (np.concatenate([pack(*e) for e in events]) if counts.sum()
              else np.zeros((0, 2), np.int32))
    return packed, counts


def descending_event(rng, n: int, pads: int = 10240):
    """``n`` rows in descending integer tb, as the convert sort gives
    them."""
    tb = np.sort(rng.integers(0, 512, n))[::-1]
    q = 10.0 ** rng.uniform(3.0, 8.0, n)
    return q, tb, rng.integers(0, pads, n), rng.integers(0, 6, n)


def edge_events(tables: dict, rng) -> list:
    """Events with every edge case (``tables`` as
    ``DetectorSimulator._native_tables()``): empty and one-row events,
    equal-tb runs longer than 32, integer tbs not descending, q = 0, q at
    both ends of the response table, tb 0 and 511, pads 0 and 10239, label
    255, and an event of 2,000 rows."""
    resp_asc, resp_max = tables["resp_asc"], tables["resp_max"]
    events = [descending_event(rng, 0), descending_event(rng, 1)]
    # equal-tb runs of 40, 33 and 100 rows among short runs
    tb = np.concatenate([np.full(40, 300), [299, 299, 298], np.full(33, 200),
                         [150], np.full(100, 100), [3, 3, 2]])
    n = len(tb)
    events.append((10.0 ** rng.uniform(3.0, 8.0, n), tb,
                   rng.integers(0, 10240, n), rng.integers(0, 6, n)))
    # integer tbs not descending: the full stable sort
    n = 300
    events.append((10.0 ** rng.uniform(3.0, 8.0, n),
                   rng.integers(0, 512, n), rng.integers(0, 10240, n),
                   rng.integers(0, 6, n)))
    # ascending runs of equal tbs, not descending either
    tb = np.repeat([5, 9, 9, 7, 511, 0], 7)
    n = len(tb)
    events.append((10.0 ** rng.uniform(3.0, 8.0, n), tb,
                   rng.integers(0, 10240, n), rng.integers(0, 6, n)))
    # q = 0, the smallest f32, both ends of the response table (thresholds
    # above its largest sample and below its smallest positive one),
    # thresholds on its samples, large q; tb 511 and 0
    pos = resp_asc[resp_asc > 0]
    q = np.array([0.0, 1e-45, 1e-30, 1.0, 4095.0 / resp_max,
                  4095.0 / resp_asc[-1], 4095.0 / pos[0], 4095.0 / pos[0] * 2,
                  4095.0 / resp_asc[300], 4095.0 / resp_asc[450], 3.0e38,
                  1.0e12, 5.0e5, 2.5e6])
    q = np.minimum(q, 3.0e38)  # finite in f32
    n = len(q)
    tb = np.sort(np.concatenate([[511, 511, 0, 0],
                                 rng.integers(0, 512, n - 4)]))[::-1]
    events.append((q, tb, np.concatenate([[0, 10239], rng.integers(
        0, 10240, n - 2)]), np.concatenate([[0, 255], rng.integers(
            0, 6, n - 2)])))
    events += [descending_event(rng, 1), descending_event(rng, 0),
               descending_event(rng, 2000)]
    return events


def forged_tie():
    """Two events whose forged wiggle rounds tb + w up to tb + 1 (w = 1 -
    2^-53, tb >= 1), tying a row of the next integer tb up with wiggle 0.
    Returns (packed, counts, wiggle, n rows an event); in event 0 the
    stable order starts with rows 0, 2, 1, 3 (row 1: tb 7, w 0; row 3: tb
    6 rounded up to 7.0). Pads are 100 + row."""
    below_one = np.nextafter(1.0, 0.0)
    tb = np.array([9, 7, 7, 6, 6, 6, 5, 5, 1, 1, 0])
    w = np.array([0.5, 0.0, below_one, below_one, 0.0, 0.25, 0.0,
                  below_one, below_one, 0.0, below_one])
    assert tb[3] + w[3] == tb[1] + w[1] == 7.0
    n = len(tb)
    q = np.linspace(1e4, 1e6, n)
    packed, counts = pool([(q, tb, np.arange(n) + 100, np.arange(n) % 5)] * 2)
    return packed, counts, np.concatenate([w, w[::-1]]), n
