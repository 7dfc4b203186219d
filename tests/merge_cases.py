"""Merge rows for the run-end compaction's tests, on the CPU and on the
card: ``merge_rows(w, rank_bits)`` gives int64 ``pack64(key, charge)``
rows [4, w] in no order (the merge sorts them first).

Row 0 is merge-like (keys over w // 3 cells, a quarter of the lanes dead,
so n_uniq is near w / 4 at large w); row 1 is dead lanes only; row 2 has
a few keys, so its runs are thousands of lanes long and cross every
4,096-lane tile boundary; row 3 has no dead lane and whole charges, so
equal (key, charge) elements occur. Charges are nonnegative f32 and 0.0
on dead lanes (``KEY_SENTINEL``), as the deposit writes them.
"""

import numpy as np
import torch

SENT = 2**31 - 1


def merge_rows(w: int, rank_bits: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng([w, rank_bits, seed])
    space = rng.integers(0, max(1, w // 3), (4, w))
    space[2] = rng.integers(0, 1 + w // 3000, w)
    key = (space << rank_bits) | rng.integers(0, 1 << rank_bits, (4, w))
    q = np.abs(rng.normal(100.0, 30.0, (4, w)))
    q[3] = np.floor(q[3] / 10.0)
    dead = rng.random((4, w)) < 0.25
    dead[1] = True
    dead[3] = False
    key = np.where(dead, SENT, key).astype(np.int32)
    q = np.where(dead, 0.0, q).astype(np.float32)
    return (torch.from_numpy(key).to(torch.int64) << 32) | (
        torch.from_numpy(q).view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
