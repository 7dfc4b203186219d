"""Merge rows for the run-end compaction's and the merge sort's tests, on
the CPU and on the card: ``merge_rows(w, rank_bits)`` gives int64
``pack64(key, charge)`` rows [4, w] in no order (the merge sorts them
first); ``live_rows(w, lanes, case)`` gives rows [len(lanes), w] whose
lanes at or past ``lanes[i]`` are the sentinel element, as the default
step's deposit writes them (``LIVE_CASES``, ``LIVE_EDGES``);
``live_plan(w)`` emulates the launches of K3's live route over rows of
width w, as ``attpc_sort_rows_live`` (csrc/sort_cluster.cu) and
``attpc_merge_rows_live`` (csrc/merge_rows.cu) make them.

Row 0 is merge-like (keys over w // 3 cells, a quarter of the lanes dead,
so n_uniq is near w / 4 at large w); row 1 is dead lanes only; row 2 has
a few keys, so its runs are thousands of lanes long and cross every
4,096-lane tile boundary; row 3 has no dead lane and whole charges, so
equal (key, charge) elements occur. Charges are nonnegative f32 and 0.0
on dead lanes (``KEY_SENTINEL``), as the deposit writes them.
"""

from typing import NamedTuple

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


# what fills each row's prefix in live_rows
LIVE_CASES = ("scattered", "no_sentinel", "all_sentinel", "equal_keys")
# prefixes at the live route's edges: empty, one lane, a cluster of 1, 4,
# 8 and 16 CTAs of 13,360 lanes and one lane either side, the whole row
CTA = 13_360
LIVE_EDGES = (0, 1, CTA - 1, CTA, CTA + 1, 4 * CTA - 1, 4 * CTA,
              4 * CTA + 1, 8 * CTA - 1, 8 * CTA, 8 * CTA + 1, 16 * CTA - 1,
              16 * CTA, 16 * CTA + 1)


def live_rows(w: int, lanes, case: str, seed: int = 0) -> torch.Tensor:
    """Rows [len(lanes), w]: row i's lanes [lanes[i], w) are the sentinel
    element pack64(SENT, 0.0); inside the prefix, by ``case``, a quarter of
    the lanes dead at random ("scattered"), none ("no_sentinel"), all
    ("all_sentinel"), or ten keys with charges of a few whole values, so
    equal keys with different charges and equal elements abound
    ("equal_keys")."""
    lanes = np.asarray(lanes, dtype=np.int64)
    e = len(lanes)
    rng = np.random.default_rng([w, e, seed, LIVE_CASES.index(case)])
    key = rng.integers(0, 2**23, (e, w))
    q = np.abs(rng.normal(100.0, 30.0, (e, w)))
    dead = rng.random((e, w)) < 0.25
    if case == "no_sentinel":
        dead[:] = False
    elif case == "all_sentinel":
        dead[:] = True
    elif case == "equal_keys":
        key = rng.integers(0, 10, (e, w)) << 1
        q = np.floor(q / 40.0)
    dead |= np.arange(w)[None, :] >= lanes[:, None]
    key = np.where(dead, SENT, key).astype(np.int32)
    q = np.where(dead, 0.0, q).astype(np.float32)
    return (torch.from_numpy(key).to(torch.int64) << 32) | (
        torch.from_numpy(q).view(torch.int32).to(torch.int64) & 0xFFFFFFFF)


# the widest prefix a cluster of the live route sorts whole: 8 CTAs
# (csrc/sort_live.cuh kLiveClusterLanes)
LIVE_CLUSTER_LANES = 8 * CTA


class LiveLaunch(NamedTuple):
    """One launch of the live route over rows of a width (``live_plan``):
    site "cluster-<n>" sorts the rows with ``lo`` < lanes <= ``hi`` on
    clusters of ``n_cta`` CTAs of ``chunk`` elements; site "wide" sorts the
    rows past ``LIVE_CLUSTER_LANES`` in one-CTA chunks of ``chunk`` lanes,
    then up to ``passes`` merge passes over each row's prefix."""

    site: str
    n_cta: int
    lo: int
    hi: int
    chunk: int
    passes: int


def live_merge_passes(lanes: int) -> int:
    """Merge passes of a wide row whose prefix holds ``lanes`` elements:
    ceil(log2(chunks of CTA lanes)) (csrc/sort_live.cuh)."""
    return (-(-int(lanes) // CTA) - 1).bit_length()


def live_plan(width: int) -> tuple:
    """The live route's launches over rows of ``width``, in order, as the
    host loop of ``attpc_sort_rows_live`` makes them: every cluster of
    1, 2, 4 and 8 CTAs a prefix of at most ``width`` lanes could need, then
    the wide route where a prefix can pass ``LIVE_CLUSTER_LANES``."""
    plan = []
    n = 1
    while n * CTA <= LIVE_CLUSTER_LANES:
        lo = 0 if n == 1 else n // 2 * CTA
        if lo >= width:
            break
        hi = n * CTA
        chunk = -(-min(int(width), hi) // n)
        plan.append(LiveLaunch(f"cluster-{n}", n, lo, hi,
                               max(2, chunk + (chunk & 1)), 0))
        n *= 2
    if width > LIVE_CLUSTER_LANES:
        plan.append(LiveLaunch("wide", 1, LIVE_CLUSTER_LANES, int(width), CTA,
                               live_merge_passes(width)))
    return tuple(plan)
