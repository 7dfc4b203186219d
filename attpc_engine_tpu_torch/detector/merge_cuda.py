"""K5 wrapper: the whole per-event merge of equal (pad, tb) keys.

Kernels: K3 (``sort_cuda.sort_rows``, ``csrc/sort_cluster.cu``) for the first
sort, then ``csrc/merge_fused.cu`` (``attpc_merge_tail``) for the rest.
Together they replace the Pallas kernel
``attpc_engine_tpu/detector/sort_pallas.py`` ``_merge_kernel``
(merge_runs_fused_pallas) with the same contract: sort by (key, charge),
f32 charge prefix, run-end mask, n_uniq, compaction of the run ends to
``cap`` slots. What bounds it on the card is bytes: the sort's passes over
the 1 MB int64 rows (K3), then one block per row that reads the sorted row
twice and writes only the ``cap`` compacted slots. The TPU kernel's second
bitonic sort becomes an in-order compaction, which gives the same output
because the run ends are distinct and already ascending. The prefix
associates as the TPU kernel's (``_cumsum_flat``), so the sums are its
bits, not ``deposition._prefix_sum``'s (XLA's CPU cumsum); see the source.

``merge_runs_fused`` takes ``merge_runs_fused_plain`` for CPU tensors and
launches the kernels for CUDA tensors, raising where they cannot take
them. ``launches`` counts launches of the tail kernel (K3 counts its own).
``fits_fused`` is the JAX package's width rule (sort_pallas.fits_invmem):
wider rows keep the sorts path, chosen by shape before any launch.
"""

from __future__ import annotations

import torch

from .. import kernels
from .sort_cuda import pack64, sort_rows, sort_rows_plain, unpack64

__all__ = [
    "merge_runs_fused",
    "merge_runs_fused_plain",
    "merge_runs_fused_cuda",
    "merge_tail_plain",
    "merge_tail_cuda",
    "fits_fused",
    "KEY_SENTINEL",
    "launches",
]

KEY_SENTINEL = 2**31 - 1
LANES = 128
# rows padded beyond this take the sorts path (sort_pallas.MAX_INVMEM_TOTAL)
MAX_FUSED_TOTAL = 1 << 18
# the tail kernel's shared memory holds 4,096 segment totals (csrc)
MAX_TAIL_WIDTH = LANES * 4096

launches = 0


def fits_fused(width: int) -> bool:
    """True if a merge row of ``width`` lanes, padded to the next power of
    two, is within the fused path's width (as sort_pallas.fits_invmem)."""
    return 1 << (int(width) - 1).bit_length() <= MAX_FUSED_TOTAL


def _cumsum_flat(q: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix of q [E, W] f32 along the rows, associated as
    sort_pallas._cumsum_flat: the row padded with zeros to
    max(256, next_pow2(W)) lanes and viewed as [S, 128]; Hillis-Steele
    along the lanes, then an exclusive Hillis-Steele prefix of the
    segment totals added to every lane."""
    e, w = q.shape
    total = max(2 * LANES, 1 << (w - 1).bit_length())
    s = total // LANES
    c = torch.nn.functional.pad(q, (0, total - w)).reshape(e, s, LANES)
    lane = torch.arange(LANES, device=q.device)
    d = 1
    while d < LANES:
        c = c + torch.where(lane >= d, torch.roll(c, d, dims=2), 0.0)
        d *= 2
    sub = torch.arange(s, device=q.device)[:, None]
    x = torch.where(sub >= 1, torch.roll(c[:, :, LANES - 1:], 1, dims=1), 0.0)
    d = 1
    while d < s:
        x = x + torch.where(sub >= d, torch.roll(x, d, dims=1), 0.0)
        d *= 2
    return (c + x).reshape(e, total)[:, :w]


def merge_tail_plain(sorted_rows: torch.Tensor, cap: int, rank_bits: int):
    """Plain PyTorch version of the tail kernel: sorted pack64 rows [E, W]
    -> (key2 [E, cap] int32, c2 [E, cap] f32, n_uniq [E] int32)."""
    e, w = sorted_rows.shape
    h, q = unpack64(sorted_rows)
    c = _cumsum_flat(q)
    u = h >> rank_bits
    nxt = torch.cat(
        [u[:, 1:], torch.full_like(u[:, :1], KEY_SENTINEL >> rank_bits)],
        dim=1)
    last = (u != nxt) & (h != KEY_SENTINEL)
    n_uniq = last.sum(dim=1, dtype=torch.int32)
    # run ends in row order are the second sort's output order
    slot = torch.cumsum(last, dim=1) - 1
    row = torch.arange(e, device=h.device)[:, None]
    dest = torch.where(last & (slot < cap), row * cap + slot, e * cap)
    key2 = torch.full((e * cap + 1,), KEY_SENTINEL, dtype=torch.int32,
                      device=h.device)
    c2 = torch.zeros((e * cap + 1,), dtype=torch.float32, device=h.device)
    key2[dest.reshape(-1)] = h.reshape(-1)
    c2[dest.reshape(-1)] = c.reshape(-1)
    # the spare slot e * cap took every dropped lane
    return key2[:-1].reshape(e, cap), c2[:-1].reshape(e, cap), n_uniq


def merge_runs_fused_plain(packed: torch.Tensor, qv: torch.Tensor, cap: int,
                           rank_bits: int):
    """Plain PyTorch version of K5: ``torch.sort`` of the pack64 rows, then
    ``merge_tail_plain``. packed [E, W] int32 (KEY_SENTINEL for dead
    lanes), qv [E, W] f32 nonnegative (0 on dead lanes). Returns (key2
    [E, cap] ascending with sentinel padding, c2 [E, cap] inclusive prefix
    at the run ends, n_uniq [E] before capping); cap is clipped to W."""
    cap = min(cap, packed.shape[1])
    return merge_tail_plain(sort_rows_plain(pack64(packed, qv)), cap,
                            rank_bits)


def merge_tail_cuda(sorted_rows: torch.Tensor, cap: int, rank_bits: int):
    """Launch the tail kernel on sorted pack64 rows [E, W] (arguments and
    result as ``merge_tail_plain``)."""
    global launches
    if sorted_rows.dim() != 2:
        raise ValueError(
            f"expected [E, W], got shape {tuple(sorted_rows.shape)}")
    kernels.require(sorted_rows, "sorted_rows", torch.int64)
    e, w = sorted_rows.shape
    if w > MAX_TAIL_WIDTH:
        raise ValueError(f"rows of {w} exceed the tail kernel's "
                         f"{MAX_TAIL_WIDTH}")
    if not 0 <= cap <= w:
        raise ValueError(f"cap {cap} outside [0, {w}]")
    dev = sorted_rows.device
    key2 = torch.empty((e, cap), dtype=torch.int32, device=dev)
    c2 = torch.empty((e, cap), dtype=torch.float32, device=dev)
    n_uniq = torch.empty((e,), dtype=torch.int32, device=dev)
    ptr = kernels.ptr
    err = kernels.library().attpc_merge_tail(
        ptr(sorted_rows), ptr(key2), ptr(c2), ptr(n_uniq), e, w, cap,
        rank_bits, kernels.stream(sorted_rows),
    )
    kernels.check(err, "merge_tail")
    launches += 1
    return key2, c2, n_uniq


def merge_runs_fused_cuda(packed: torch.Tensor, qv: torch.Tensor, cap: int,
                          rank_bits: int):
    """Launch K5 (K3, then the tail kernel); arguments as
    ``merge_runs_fused_plain``."""
    if packed.dim() != 2:
        raise ValueError(f"expected [E, W], got shape {tuple(packed.shape)}")
    kernels.require(packed, "packed", torch.int32)
    kernels.require(qv, "qv", torch.float32, tuple(packed.shape))
    cap = min(cap, packed.shape[1])
    return merge_tail_cuda(sort_rows(pack64(packed, qv)), cap, rank_bits)


def merge_runs_fused(packed: torch.Tensor, qv: torch.Tensor, cap: int,
                     rank_bits: int):
    """The fused merge: K5 for CUDA tensors, the plain version for CPU
    tensors."""
    if packed.is_cuda:
        return merge_runs_fused_cuda(packed, qv, cap, rank_bits)
    return merge_runs_fused_plain(packed, qv, cap, rank_bits)
