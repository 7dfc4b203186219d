"""Wrapper of the run-end compaction kernel: the sorts path's merge after
its first row sort.

The kernel (``csrc/compact_runs.cu``, ``attpc_compact_runs``) replaces no
separate TPU kernel: on the JAX package's sorts path it is the second call
of the Pallas sort (``sort_pallas._sort_kernel``) and the XLA passes around
it (run-end mask, charge prefix, n_uniq). It reads the rows K3 sorted and
writes the first ``cap`` run ends in row order with the inclusive f32
charge prefix at each, associated exactly as ``deposition._prefix_sum``,
so its bits are the sorts path's. What bounds it on the card is bytes:
one read of the sorted rows; this design reads them twice, in three
launches (tile totals, one row's carries, output) with no grid-wide sync.

Its plain version and the entry point that chooses between the two are
``deposition.compact_runs_plain`` and ``deposition.compact_runs``, beside
the prefix and the run-end mask they share with the rest of the merge.
``launches`` counts the calls of ``compact_runs_cuda``.
"""

from __future__ import annotations

import torch

from .. import kernels

__all__ = ["compact_runs_cuda", "launches", "TILE", "SEGMENT"]

TILE = 4096  # lanes of one CTA of the totals and write kernels: 16^3
SEGMENT = 256  # lanes of one level-2 element of the prefix: 16^2

launches = 0


def compact_runs_cuda(sorted_rows: torch.Tensor, cap: int, rank_bits: int):
    """Launch the kernel on rows that K3 sorted, int64 ``pack64(key,
    charge)`` [E, W]; cap in [0, W]. Returns (key2 [E, cap] int32, c2
    [E, cap] f32, n_uniq [E] int32), as ``deposition.compact_runs_plain``.
    It allocates its outputs and scratch of ~W / 60 floats a row."""
    global launches
    if sorted_rows.dim() != 2:
        raise ValueError(
            f"expected [E, W], got shape {tuple(sorted_rows.shape)}")
    kernels.require(sorted_rows, "sorted_rows", torch.int64)
    e, w = sorted_rows.shape
    if w < 1 or not 0 <= cap <= w:
        raise ValueError(f"cap {cap} outside [0, {w}] for rows of {w}")
    if not 0 <= rank_bits <= 30:
        raise ValueError(f"rank_bits {rank_bits} outside [0, 30]")
    lib = kernels.library()
    tiles = -(-w // TILE)
    stride = lib.attpc_compact_runs_prefix_stride(-(-w // SEGMENT))
    dev = sorted_rows.device
    key2 = torch.empty((e, cap), dtype=torch.int32, device=dev)
    c2 = torch.empty((e, cap), dtype=torch.float32, device=dev)
    n_uniq = torch.empty((e,), dtype=torch.int32, device=dev)
    seg_total = torch.empty((e, tiles * TILE // SEGMENT), dtype=torch.float32,
                            device=dev)
    seg_prefix = torch.empty((e, stride), dtype=torch.float32, device=dev)
    tile_ends = torch.empty((e, tiles), dtype=torch.int32, device=dev)
    ptr = kernels.ptr
    err = lib.attpc_compact_runs(
        ptr(sorted_rows), ptr(key2), ptr(c2), ptr(n_uniq), ptr(seg_total),
        ptr(seg_prefix), ptr(tile_ends), e, w, cap, rank_bits,
        kernels.stream(sorted_rows))
    kernels.check(err, "compact_runs")
    launches += 1
    return key2, c2, n_uniq
