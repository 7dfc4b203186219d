# Copied from attpc_engine_tpu/ops/pairing.py; the port imports no jax, so it holds its own copy.
"""Szudzik pairing: bijective (tb, pad) <-> integer keys.

The reference uses Szudzik pairing as the hash-map key for its numba-Dict
charge accumulation (upstream attpc_engine/detector/pairing.py:6-55).
The TPU engine's merge path packs keys as ``pad * 512 + tb`` instead (dense,
sort-friendly), but the Szudzik functions are provided — vectorized — for
API parity and for users who build custom accumulation schemes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pair", "unpair", "pair_arrays", "unpair_arrays"]


def pair(tb: int, pad: int) -> int:
    """Szudzik-pair two non-negative integers (scalar form).

    Returns -1 if either input is negative (reference pairing.py:6-28).
    """
    if tb < 0 or pad < 0:
        return -1
    return tb * tb + tb + pad if tb >= pad else pad * pad + tb


def unpair(key: int) -> tuple[int, int]:
    """Inverse of :func:`pair`; returns (tb, pad)."""
    if key < 0:
        return (-1, -1)
    s = int(np.floor(np.sqrt(key)))
    if key - s * s < s:
        return (key - s * s, s)
    return (s, key - s * s - s)


def pair_arrays(tb: np.ndarray, pad: np.ndarray) -> np.ndarray:
    """Vectorized Szudzik pairing (int64), -1 where any input is negative."""
    tb = np.asarray(tb, dtype=np.int64)
    pad = np.asarray(pad, dtype=np.int64)
    out = np.where(tb >= pad, tb * tb + tb + pad, pad * pad + tb)
    return np.where((tb < 0) | (pad < 0), -1, out)


def unpair_arrays(key: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized inverse pairing -> (tb, pad), (-1, -1) for negative keys."""
    key = np.asarray(key, dtype=np.int64)
    s = np.floor(np.sqrt(key.astype(np.float64))).astype(np.int64)
    # guard float sqrt rounding at perfect squares
    s = np.where((s + 1) * (s + 1) <= key, s + 1, s)
    s = np.where(s * s > key, s - 1, s)
    low = key - s * s < s
    tb = np.where(low, key - s * s, s)
    pad = np.where(low, s, key - s * s - s)
    neg = key < 0
    return np.where(neg, -1, tb), np.where(neg, -1, pad)
