"""The port's production Fano draws: a counter-based Philox4x32-10 in
torch integer arithmetic, Box-Muller to f32.

The JAX package's threefry draws cannot be reproduced, so the port's
stream is held to its own contract: Random123's known answers, standard
normal moments, and draws that depend only on (seed, global event id,
step, track) for a given chunk length, not on the batch grid or on the
window length (the JAX contract, deposition.py:85-141).
"""

import numpy as np
import pytest
import torch

from attpc_engine_tpu_torch.detector.deposition import (
    fano_noise,
    philox4x32,
)


def _words(*vals):
    return [torch.tensor([v], dtype=torch.int64) for v in vals]


@pytest.mark.parametrize("ctr,key,expect", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, expect):
    """Random123's philox4x32-10 known-answer vectors."""
    out = philox4x32(_words(*ctr), _words(*key))
    assert tuple(int(w) for w in out) == expect


def test_normal_moments_within_5_sigma():
    n = 100_000
    z = fano_noise(seed=12345, event_start=0, n_events=500, tracks=2,
                   n_steps=100, chunk_steps=100, device="cpu").double().reshape(-1)
    assert z.numel() == n
    assert torch.isfinite(z).all()
    assert abs(float(z.mean())) < 5 / np.sqrt(n)
    assert abs(float(z.var()) - 1.0) < 5 * np.sqrt(2.0 / n)


def test_draws_independent_of_batch_grid():
    """Events 0-7 in one batch or in batches of 3, 3 and 2 draw the same."""
    kw = dict(seed=7, tracks=2, n_steps=120, chunk_steps=50, device="cpu")
    one = fano_noise(event_start=0, n_events=8, **kw)
    parts = [fano_noise(event_start=s, n_events=n, **kw)
             for s, n in ((0, 3), (3, 3), (6, 2))]
    torch.testing.assert_close(torch.cat(parts, dim=1), one, rtol=0, atol=0)


def test_draws_independent_of_window_length():
    """A longer window only appends steps: the first chunks are equal."""
    kw = dict(seed=7, event_start=40, n_events=4, tracks=3, chunk_steps=50,
              device="cpu")
    short = fano_noise(n_steps=100, **kw)
    long = fano_noise(n_steps=250, **kw)
    torch.testing.assert_close(long[:100], short, rtol=0, atol=0)


def test_streams_differ_by_seed_and_event():
    kw = dict(event_start=0, n_events=2, tracks=1, n_steps=64, chunk_steps=64,
              device="cpu")
    a = fano_noise(seed=1, **kw)
    b = fano_noise(seed=2, **kw)
    assert not torch.equal(a, b)
    assert not torch.equal(a[:, 0], a[:, 1])
    big = fano_noise(seed=2**40 + 1, **kw)  # the seed's high word is used
    assert not torch.equal(a, big)
