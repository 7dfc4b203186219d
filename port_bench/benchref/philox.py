# Frozen copy of attpc_engine_tpu_torch/detector/deposition.py's Philox4x32 (_mulhilo32,
# philox4x32, philox_normal); the benchmark's reference imports nothing of the port.
"""Philox4x32-10 (Salmon et al., SC'11) in int64 tensor arithmetic."""

from __future__ import annotations

import math

import torch

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo32(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product a * b, for a < 2^32 and
    b int64 holding values < 2^32, without overflowing int64."""
    t_lo = a * (b & 0xFFFF)
    t_hi = a * (b >> 16)
    s = (t_lo >> 16) + t_hi
    lo = ((s & 0xFFFF) << 16) | (t_lo & 0xFFFF)
    return s >> 16, lo


def philox4x32(counter: list[torch.Tensor], key: list[torch.Tensor],
               rounds: int = 10) -> list[torch.Tensor]:
    """Four counter words and two key words, each an int64 tensor of 32-bit
    values (broadcastable), give four words of random bits."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(rounds):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return [c0, c1, c2, c3]


def philox_normal(counter: list[torch.Tensor],
                  key: list[torch.Tensor]) -> torch.Tensor:
    """Four standard normals per counter (stacked on a new last axis), f32:
    Box-Muller on the Philox words, the first uniform in (0, 1]."""
    w = philox4x32(counter, key)
    two24 = 1.0 / 16777216.0
    out = []
    for a, b in ((w[0], w[1]), (w[2], w[3])):
        u1 = ((a >> 8) + 1).to(torch.float32) * two24
        u2 = (b >> 8).to(torch.float32) * two24
        r = torch.sqrt(-2.0 * torch.log(u1))
        theta = (2.0 * math.pi) * u2
        out += [r * torch.cos(theta), r * torch.sin(theta)]
    return torch.stack(out, dim=-1)
