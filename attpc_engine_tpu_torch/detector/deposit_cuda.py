"""K2 wrapper: pad lookup and merge-key packing of the diffusion mesh.

Kernel: ``csrc/deposit.cu`` (``attpc_packed_key_lookup``). It replaces the
Pallas kernel ``attpc_engine_tpu/detector/deposit_pallas.py``
``_packed_kernel_2s`` (packed_key_lookup_2s_pallas) with the same contract.
What bounds it on the card is bytes: ~4.8 B moved per output key, 39.3 M
keys at the flagship batch; the 1.43 MB pad-id table is gathered at random
and stays in L2. One thread per key: one cached gather, one coalesced
store. The TPU's one-hot matrix products and bf16 table planes have no
place here.

``packed_key_lookup`` takes ``packed_key_lookup_plain`` for CPU tensors and
launches the kernel for CUDA tensors, raising where the kernel cannot take
them. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import kernels
from .parameters import PAD_ID_SENTINEL, PAD_TABLE_NX, PAD_TABLE_NY

__all__ = [
    "packed_key_lookup",
    "packed_key_lookup_plain",
    "packed_key_lookup_cuda",
    "launches",
]

launches = 0


def packed_key_lookup_plain(
    ix: torch.Tensor,
    iy: torch.Tensor,
    tbr: torch.Tensor,
    table: torch.Tensor,
    rank_bits: int,
    sentinel: int,
) -> torch.Tensor:
    """Plain PyTorch version of K2.

    ix, iy [P, 10] int32 mm-cell indices, invalid pixels already aliased by
    the caller onto the table's sentinel padding (clamped here into the
    table); tbr [P] int32 = (tb << rank_bits) | rank; table [560, 640] int32
    pad ids (PAD_ID_SENTINEL where vetoed). Returns [P, 10, 10] int32
    ((pad * 512 + tb) << rank_bits) | rank, or ``sentinel``.
    """
    ixc = torch.clamp(ix, 0, PAD_TABLE_NX - 1).long()
    iyc = torch.clamp(iy, 0, PAD_TABLE_NY - 1).long()
    flat = ixc[:, :, None] * PAD_TABLE_NY + iyc[:, None, :]
    pad = table.reshape(-1)[flat]
    key = pad * (512 << rank_bits) + tbr.to(torch.int32)[:, None, None]
    return torch.where(pad < PAD_ID_SENTINEL, key,
                       torch.full_like(key, sentinel))


def packed_key_lookup_cuda(ix, iy, tbr, table, rank_bits: int,
                           sentinel: int) -> torch.Tensor:
    """Launch K2 (arguments as ``packed_key_lookup_plain``)."""
    global launches
    p = ix.shape[0]
    for name, x, shape in (
        ("ix", ix, (p, 10)),
        ("iy", iy, (p, 10)),
        ("tbr", tbr, (p,)),
        ("table", table, (PAD_TABLE_NX, PAD_TABLE_NY)),
    ):
        kernels.require(x, name, torch.int32, shape)
    out = torch.empty((p, 10, 10), dtype=torch.int32, device=ix.device)
    ptr = kernels.ptr
    err = kernels.library().attpc_packed_key_lookup(
        ptr(ix), ptr(iy), ptr(tbr), ptr(table), ptr(out), p, rank_bits,
        sentinel, kernels.stream(ix),
    )
    kernels.check(err, "packed_key_lookup")
    launches += 1
    return out


def packed_key_lookup(ix, iy, tbr, table, rank_bits: int,
                      sentinel: int) -> torch.Tensor:
    """Merge keys of every mesh pixel: the K2 kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if ix.is_cuda:
        return packed_key_lookup_cuda(ix, iy, tbr, table, rank_bits, sentinel)
    return packed_key_lookup_plain(ix, iy, tbr, table, rank_bits, sentinel)
