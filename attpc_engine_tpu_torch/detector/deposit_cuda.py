"""K2, K6 and K7 wrappers: pad lookups over the diffusion mesh; the
deposit-rows kernel of the default step.

Kernels: ``csrc/deposit.cu``. ``attpc_packed_key_lookup`` (K2) replaces the
Pallas kernel ``attpc_engine_tpu/detector/deposit_pallas.py``
``_packed_kernel_2s`` (packed_key_lookup_2s_pallas), and
``attpc_packed_key_lookup_rows`` (K6) the kernel ``_packed_kernel``
(packed_key_lookup_pallas): one contract, the pad lookup and merge-key
packing, in two machine mappings, as on the TPU. ``attpc_pad_lookup`` (K7)
replaces ``_lookup_kernel`` (pad_lookup_pallas): pad ids only. What bounds
them on the card is bytes: ~4.8 B moved per output key, 39.3 M keys at the
flagship batch; the 1.43 MB pad-id table is gathered one int32 a key and
stays in L2, whose sector traffic sets the pace on random cells (32
sectors a warp gather) but not on a step's points, whose neighbouring
pixels share cells. K2 and K7 are one kernel, K7 without the key: each
thread owns one quad of 4 consecutive keys, loads its point's indices
once through L1 (7 loads for 4 keys where one thread a key loaded 12),
gathers four pad ids and writes one 16-byte store, so that a warp writes
512 contiguous bytes and every sector once; the quads at y cells 8, 9 and
0, 1 straddle two x rows. The kernel keeps no shared memory, leaving L1
to the table. Their index arithmetic is 32-bit, so their wrappers refuse
P * 100 >= 2**31 (``require_int32_keys``). K6 runs one thread per (point,
x cell) row, ten gathers along one table row, and stages each warp's 320
keys in shared memory for one contiguous 1,280-byte run of 16-byte
stores. The TPU kernels' one-hot matrix products and bf16 table planes
have no place here.

``attpc_deposit_rows`` (``csrc/deposit_rows.cu``) is the default step's
(``merge="sorts"``, ``lookup="two_stage"``) deposit in one kernel: the
10x10 diffusion mesh of each point, K2's lookup and key,
the pixel charges and their mask, written as the int64 rows
``pack64(key, charge)`` that the first merge sort takes. It reads ~21 B a
point and writes 800 B, so bytes bound it too; the K2 kernel keeps the TPU
kernel's int32 contract for the configurations that feed K5. Its plain
version and the entry point that chooses between the two are
``deposition.deposit_rows_plain`` and ``deposition.deposit_rows``, beside
the mesh they share with the other configurations.

``packed_key_lookup``, ``packed_key_lookup_rows`` and ``pad_lookup`` take
their plain versions for CPU tensors and launch their kernels for CUDA
tensors, raising where a kernel cannot take them. ``launches``,
``launches_rows``, ``launches_pad_lookup`` and ``launches_deposit_rows``
count the launches of K2, K6, K7 and the rows kernel.
"""

from __future__ import annotations

import numpy as np
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
    "deposit_rows_cuda",
    "launches_deposit_rows",
    "MAX_POINTS",
    "require_int32_keys",
]

launches = 0  # K2
launches_rows = 0  # K6
launches_pad_lookup = 0  # K7
launches_deposit_rows = 0  # the deposit-rows kernel

# the most points whose P * 100 keys K2 and K7 index in int32
MAX_POINTS = (2**31 - 1) // 100


def require_int32_keys(p: int) -> None:
    """Raise unless the P * 100 keys of ``p`` points have int32 indices,
    as K2 and K7 compute them."""
    if p > MAX_POINTS:
        raise ValueError(f"{p} points: K2 and K7 index their P * 100 keys "
                         f"in int32, so P * 100 < 2**31 (at most "
                         f"{MAX_POINTS} points)")


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
    require_int32_keys(ix.shape[0])
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
    require_int32_keys(ix.shape[0])
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


def deposit_rows_cuda(px, py, ptbf, pne, tbr, taken, table,
                      grid_lo_mm: float, grid_n_mm: int, diffusion: float,
                      efield: float, drift_velocity: float, rank_bits: int,
                      mesh: np.ndarray, pdf: np.ndarray) -> torch.Tensor:
    """Launch the deposit-rows kernel: arguments as
    ``deposition.deposit_rows_plain``, then the mesh offsets [10] and the
    pixel weights [10, 10] that version uses, as f32 numpy arrays (they go
    to the kernel by value). Returns [E, pb * 100] int64 rows.

    The scalars go in as the plain version's f32 operands on the card:
    ``2.0 * diffusion * drift_velocity`` rounded once to f32, and the f32
    reciprocal of f32(efield), since ATen's CUDA true division by a CPU
    scalar multiplies by its reciprocal."""
    global launches_deposit_rows
    e, pb = px.shape
    for name, x, dtype in (("px", px, torch.float32), ("py", py, torch.float32),
                           ("ptbf", ptbf, torch.float32),
                           ("pne", pne, torch.float32),
                           ("tbr", tbr, torch.int32),
                           ("taken", taken, torch.bool)):
        kernels.require(x, name, dtype, (e, pb))
    kernels.require(table, "table", torch.int32, (PAD_TABLE_NX, PAD_TABLE_NY))
    mesh = np.ascontiguousarray(mesh, dtype=np.float32)
    pdf = np.ascontiguousarray(pdf, dtype=np.float32)
    if mesh.shape != (10,) or pdf.shape != (10, 10):
        raise ValueError(f"mesh {mesh.shape}, pdf {pdf.shape}: expected (10,)"
                         f" and (10, 10)")
    k = np.float32(2.0 * diffusion * drift_velocity)
    inv_e = np.float32(1.0) / np.float32(efield)
    out = torch.empty((e, pb * 100), dtype=torch.int64, device=px.device)
    ptr = kernels.ptr
    err = kernels.library().attpc_deposit_rows(
        ptr(px), ptr(py), ptr(ptbf), ptr(pne), ptr(tbr), ptr(taken),
        ptr(table), mesh.ctypes.data, pdf.ctypes.data, ptr(out), e * pb,
        float(k), float(inv_e), float(grid_lo_mm), int(grid_n_mm), rank_bits,
        kernels.stream(px))
    kernels.check(err, "attpc_deposit_rows")
    launches_deposit_rows += 1
    return out
