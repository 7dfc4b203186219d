"""K3 wrapper: row-wise ascending sort of int64 [E, W].

Kernel: ``csrc/sort_rows.cu`` (``attpc_sort_rows_i64``). It replaces the
Pallas kernel ``attpc_engine_tpu/detector/sort_pallas.py`` ``_sort_kernel``
(sort_pairs_pallas, and sort_i64_pallas through it) at all three call sites
of the detector step: the two merge sorts of ``deposition._merge_runs``
(rows of point_budget * 100 = 102,400 at the flagship, padded to 131,072)
and the convert sort of ``DetectorSimulator._convert_to_spyral`` (rows of
uniq_budget = 12,288, padded to 16,384). What bounds it on the card is
bytes through device memory: a 1 MB merge row does not fit one block's
shared memory, so stages at distances >= 16,384 pass through device memory
and all others run in shared memory; see the source.

``sort_rows`` takes ``torch.sort`` (the plain version) for CPU tensors and
launches the kernel for CUDA tensors, raising where the kernel cannot take
them. ``launches`` counts kernel launches. ``pack64`` and ``unpack64`` make
and split the merge sorts' int64 (key, charge) elements.
"""

from __future__ import annotations

import torch

from .. import kernels

__all__ = [
    "sort_rows",
    "sort_rows_plain",
    "sort_rows_cuda",
    "pack64",
    "unpack64",
    "launches",
]

TILE = 16384  # elements one block sorts in shared memory (csrc kTile)
MAX_ROWS = 65535  # gridDim.y

launches = 0

_MASK32 = 0xFFFFFFFF


def pack64(key: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Nonnegative int32 key in the high word, the f32 value's bits in the
    low word (deposition.py:241-249): for nonnegative values int64 order is
    (key, value) order."""
    return (key.to(torch.int64) << 32) | (
        val.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    )


def unpack64(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int32 key, f32 value) of ``pack64`` elements."""
    lo = ((g & _MASK32) ^ 0x80000000) - 0x80000000  # signed low word
    return (g >> 32).to(torch.int32), lo.to(torch.int32).view(torch.float32)


def sort_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: each row of [E, W] ascending."""
    return torch.sort(x, dim=1).values


def sort_rows_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch K3 on a contiguous CUDA int64 [E, W]; returns a new tensor."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"expected [E, W], got shape {tuple(x.shape)}")
    kernels.require(x, "x", torch.int64)
    e, w = x.shape
    if e > MAX_ROWS:
        raise ValueError(f"{e} rows exceed the kernel's {MAX_ROWS}")
    total = 1 << max(1, (w - 1).bit_length())
    out = torch.empty_like(x)
    scratch = (
        torch.empty((e, total), dtype=torch.int64, device=x.device)
        if total > TILE else None
    )
    err = kernels.library().attpc_sort_rows_i64(
        kernels.ptr(x), kernels.ptr(out),
        None if scratch is None else kernels.ptr(scratch),
        e, w, total, kernels.stream(x),
    )
    kernels.check(err, "sort_rows_i64")
    launches += 1
    return out


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row of int64 [E, W] ascending: the K3 kernel for CUDA tensors,
    ``torch.sort`` for CPU tensors."""
    if x.is_cuda:
        return sort_rows_cuda(x)
    return sort_rows_plain(x)
