"""K2, K6 and K7 wrappers: pad lookups over the diffusion mesh.

Kernels: ``csrc/deposit.cu``. ``attpc_packed_key_lookup`` (K2) replaces the
Pallas kernel ``attpc_engine_tpu/detector/deposit_pallas.py``
``_packed_kernel_2s`` (packed_key_lookup_2s_pallas), and
``attpc_packed_key_lookup_rows`` (K6) the kernel ``_packed_kernel``
(packed_key_lookup_pallas): one contract, the pad lookup and merge-key
packing, in two machine mappings, as on the TPU. ``attpc_pad_lookup`` (K7)
replaces ``_lookup_kernel`` (pad_lookup_pallas): pad ids only. What bounds
them on the card is bytes: ~4.8 B moved per output key, 39.3 M keys at the
flagship batch; the 1.43 MB pad-id table is gathered at random and stays
in L2. K2 runs one thread per key (one cached gather, one coalesced
store); K6 and K7 one thread per (point, x cell) row, ten gathers along one
table row and ten consecutive stores. The TPU kernels' one-hot matrix
products and bf16 table planes have no place here.

``packed_key_lookup``, ``packed_key_lookup_rows`` and ``pad_lookup`` take
their plain versions for CPU tensors and launch their kernels for CUDA
tensors, raising where a kernel cannot take them. ``launches``,
``launches_rows`` and ``launches_pad_lookup`` count the launches of K2, K6
and K7.
"""

from __future__ import annotations

import torch

from .. import kernels
from .parameters import PAD_ID_SENTINEL, PAD_TABLE_NX, PAD_TABLE_NY

__all__ = [
    "packed_key_lookup",
    "packed_key_lookup_plain",
    "packed_key_lookup_cuda",
    "packed_key_lookup_rows",
    "packed_key_lookup_rows_cuda",
    "pad_lookup",
    "pad_lookup_plain",
    "pad_lookup_cuda",
    "launches",
    "launches_rows",
    "launches_pad_lookup",
]

launches = 0  # K2
launches_rows = 0  # K6
launches_pad_lookup = 0  # K7


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


def _require_lookup(ix, iy, table, tbr=None) -> int:
    """Check the lookup kernels' arguments; return the point count P."""
    p = ix.shape[0]
    args = [("ix", ix, (p, 10)), ("iy", iy, (p, 10)),
            ("table", table, (PAD_TABLE_NX, PAD_TABLE_NY))]
    if tbr is not None:
        args.append(("tbr", tbr, (p,)))
    for name, x, shape in args:
        kernels.require(x, name, torch.int32, shape)
    return p


def _launch_packed(entry: str, ix, iy, tbr, table, rank_bits: int,
                   sentinel: int) -> torch.Tensor:
    p = _require_lookup(ix, iy, table, tbr)
    out = torch.empty((p, 10, 10), dtype=torch.int32, device=ix.device)
    ptr = kernels.ptr
    err = getattr(kernels.library(), entry)(
        ptr(ix), ptr(iy), ptr(tbr), ptr(table), ptr(out), p, rank_bits,
        sentinel, kernels.stream(ix),
    )
    kernels.check(err, entry)
    return out


def packed_key_lookup_cuda(ix, iy, tbr, table, rank_bits: int,
                           sentinel: int) -> torch.Tensor:
    """Launch K2 (arguments as ``packed_key_lookup_plain``)."""
    global launches
    out = _launch_packed("attpc_packed_key_lookup", ix, iy, tbr, table,
                         rank_bits, sentinel)
    launches += 1
    return out


def packed_key_lookup_rows_cuda(ix, iy, tbr, table, rank_bits: int,
                                sentinel: int) -> torch.Tensor:
    """Launch K6 (arguments as ``packed_key_lookup_plain``)."""
    global launches_rows
    out = _launch_packed("attpc_packed_key_lookup_rows", ix, iy, tbr, table,
                         rank_bits, sentinel)
    launches_rows += 1
    return out


def packed_key_lookup(ix, iy, tbr, table, rank_bits: int,
                      sentinel: int) -> torch.Tensor:
    """Merge keys of every mesh pixel: the K2 kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if ix.is_cuda:
        return packed_key_lookup_cuda(ix, iy, tbr, table, rank_bits, sentinel)
    return packed_key_lookup_plain(ix, iy, tbr, table, rank_bits, sentinel)


def packed_key_lookup_rows(ix, iy, tbr, table, rank_bits: int,
                           sentinel: int) -> torch.Tensor:
    """K2's contract in K6's mapping: the K6 kernel for CUDA tensors, the
    plain version (the same function as K2's) for CPU tensors."""
    if ix.is_cuda:
        return packed_key_lookup_rows_cuda(ix, iy, tbr, table, rank_bits,
                                           sentinel)
    return packed_key_lookup_plain(ix, iy, tbr, table, rank_bits, sentinel)


def pad_lookup_plain(ix: torch.Tensor, iy: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: ix, iy [P, 10] int32 mm-cell indices,
    clipped into the table ([0, 559] and [0, 639]), so out-of-plane pixels
    alias onto edge cells and masking them is the caller's job; table
    [560, 640] int32 pad ids. Returns [P, 10, 10] int32 pad ids,
    PAD_ID_SENTINEL where vetoed (deposit_pallas.pad_lookup_pallas)."""
    ixc = torch.clamp(ix, 0, PAD_TABLE_NX - 1).long()
    iyc = torch.clamp(iy, 0, PAD_TABLE_NY - 1).long()
    return table[ixc[:, :, None], iyc[:, None, :]]


def pad_lookup_cuda(ix, iy, table) -> torch.Tensor:
    """Launch K7 (arguments as ``pad_lookup_plain``)."""
    global launches_pad_lookup
    p = _require_lookup(ix, iy, table)
    out = torch.empty((p, 10, 10), dtype=torch.int32, device=ix.device)
    ptr = kernels.ptr
    err = kernels.library().attpc_pad_lookup(
        ptr(ix), ptr(iy), ptr(table), ptr(out), p, kernels.stream(ix))
    kernels.check(err, "attpc_pad_lookup")
    launches_pad_lookup += 1
    return out


def pad_lookup(ix, iy, table) -> torch.Tensor:
    """Pad ids of every mesh pixel: the K7 kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if ix.is_cuda:
        return pad_lookup_cuda(ix, iy, table)
    return pad_lookup_plain(ix, iy, table)
