"""K5 wrapper: the whole per-event merge of equal (pad, tb) keys.

K5 replaces the Pallas kernel ``attpc_engine_tpu/detector/sort_pallas.py``
``_merge_kernel`` (merge_runs_fused_pallas) with the same contract: sort by
(key, charge), f32 charge prefix, run-end mask, n_uniq, compaction of the
run ends to ``cap`` slots. What bounds it on the card is bytes: the keys and
charges read once, the ``cap`` slots written once. It has two routes,
chosen by ``route`` from the width alone before any launch:

- **cluster** (``csrc/merge_cluster.cu``, ``attpc_merge_cluster``): rows of
  at most 16 * ``sort_cuda.CTA_CAPACITY`` = 213,760 lanes (the flagship's
  102,400 and its first overflow doubling, 204,800). One launch: a
  thread-block cluster of the n_cta that ``sort_cuda`` gives the width
  loads the row's live lanes (dead lanes, at ``KEY_SENTINEL``, are counted
  and dropped), radix-sorts them in shared and distributed shared memory
  and runs the prefix, the run ends and the compaction on chip.
- **two_launch** (``pack64``, K3 ``sort_cuda.sort_rows``, then
  ``csrc/merge_fused.cu`` ``attpc_merge_tail``): wider rows up to
  ``fits_fused``'s 2^18 lanes. The tail kernel takes one block a row, reads
  the sorted row twice and writes the ``cap`` slots.

The TPU kernel's second bitonic sort becomes an in-order compaction, which
gives the same output because the run ends are distinct and already
ascending. The prefix associates as the TPU kernel's (``_cumsum_flat``),
so the sums are its bits, not ``deposition._prefix_sum``'s (XLA's CPU
cumsum); see the sources.

``merge_runs_fused`` takes ``merge_runs_fused_plain`` for CPU tensors and
launches the kernels for CUDA tensors, raising where they cannot take
them. ``launches_cluster`` counts launches of the cluster kernel,
``launches_two_launch`` launches of the tail kernel (K3 counts its own),
``launches`` their sum. ``fits_fused`` is the JAX package's width rule
(sort_pallas.fits_invmem): wider rows keep the sorts path, chosen by shape
before any launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels
from . import sort_cuda
from .sort_cuda import pack64, sort_rows, sort_rows_plain, unpack64

__all__ = [
    "merge_runs_fused",
    "merge_runs_fused_plain",
    "merge_runs_fused_cuda",
    "merge_runs_two_launch",
    "merge_tail_plain",
    "merge_tail_cuda",
    "fits_fused",
    "route",
    "MergeRoute",
    "KEY_SENTINEL",
    "launches",
    "launches_cluster",
    "launches_two_launch",
]

KEY_SENTINEL = 2**31 - 1
LANES = 128
# rows padded beyond this take the sorts path (sort_pallas.MAX_INVMEM_TOTAL)
MAX_FUSED_TOTAL = 1 << 18
# the tail kernel's shared memory holds 4,096 segment totals (csrc)
MAX_TAIL_WIDTH = LANES * 4096
# the cluster kernel (csrc/merge_cluster.cu): rows a 16-CTA cluster holds
MAX_CLUSTER_WIDTH = sort_cuda.CLUSTER_SIZES[-1] * sort_cuda.CTA_CAPACITY
# its CTAs: 28 warps, two 8-byte buffers of `chunk` elements and the fixed
# tables (per-warp 16-bit digit counts, digit totals and offsets, 256 B)
CLUSTER_THREADS = 896
CLUSTER_FIXED_BYTES = (CLUSTER_THREADS // 32) * sort_cuda.DIGITS * 2 + (
    2 * sort_cuda.DIGITS * 4 + 256)

launches = 0
launches_cluster = 0
launches_two_launch = 0

_schedulable: dict[int, int] = {}


class MergeRoute(NamedTuple):
    """How K5 merges rows of one width. "cluster": one cluster of ``n_cta``
    CTAs a row, each loading ceil(width / n_cta) lanes into buffers of
    ``chunk`` elements (a multiple of 128). "two_launch": pack64, K3 and
    the tail kernel (``n_cta`` and ``chunk`` 0)."""

    name: str
    n_cta: int
    chunk: int

    @property
    def shared_bytes(self) -> int:
        """Dynamic shared memory of one CTA of the cluster kernel."""
        return 16 * self.chunk + CLUSTER_FIXED_BYTES


def route(width: int) -> MergeRoute:
    """The route for merge rows of ``width`` lanes: the cluster kernel on
    the cluster ``sort_cuda`` gives the width where 16 CTAs hold it, else
    the two-launch route; raises past ``fits_fused``."""
    w = int(width)
    if w < 1 or not fits_fused(w):
        raise ValueError(f"merge rows of {w} lanes are outside the fused "
                         f"path's width (fits_fused)")
    if w > MAX_CLUSTER_WIDTH:
        return MergeRoute("two_launch", 0, 0)
    n_cta = sort_cuda.route(w).n_cta
    load = -(-w // n_cta)
    return MergeRoute("cluster", n_cta, -(-load // LANES) * LANES)


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
    global launches, launches_two_launch
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
    launches_two_launch += 1
    launches += 1
    return key2, c2, n_uniq


def _require_merge(packed: torch.Tensor, qv: torch.Tensor) -> None:
    if packed.dim() != 2:
        raise ValueError(f"expected [E, W], got shape {tuple(packed.shape)}")
    kernels.require(packed, "packed", torch.int32)
    kernels.require(qv, "qv", torch.float32, tuple(packed.shape))


def _require_schedulable(r: MergeRoute) -> None:
    """Raise unless the card can run one cluster of ``r.n_cta`` CTAs of the
    largest chunk; asked once per cluster size."""
    if r.n_cta not in _schedulable:
        n = ctypes.c_int(0)
        chunk = -(-sort_cuda.CTA_CAPACITY // LANES) * LANES
        err = kernels.library().attpc_merge_cluster_occupancy(
            r.n_cta, chunk, ctypes.byref(n))
        kernels.check(err, "merge_cluster occupancy")
        _schedulable[r.n_cta] = n.value
    if _schedulable[r.n_cta] < 1:
        raise RuntimeError(f"the card cannot schedule a cluster of "
                           f"{r.n_cta} CTAs with {r.shared_bytes} B of "
                           f"shared memory each")


def merge_runs_two_launch(packed: torch.Tensor, qv: torch.Tensor, cap: int,
                          rank_bits: int):
    """K5's two-launch route on rows of any width up to ``MAX_TAIL_WIDTH``:
    pack64, K3, then the tail kernel; arguments as
    ``merge_runs_fused_plain``."""
    _require_merge(packed, qv)
    cap = min(cap, packed.shape[1])
    return merge_tail_cuda(sort_rows(pack64(packed, qv)), cap, rank_bits)


def merge_runs_fused_cuda(packed: torch.Tensor, qv: torch.Tensor, cap: int,
                          rank_bits: int):
    """Launch K5 on the route ``route`` gives the width; arguments as
    ``merge_runs_fused_plain``."""
    global launches, launches_cluster
    _require_merge(packed, qv)
    e, w = packed.shape
    cap = min(cap, w)
    r = route(w)
    if r.name == "two_launch":
        return merge_runs_two_launch(packed, qv, cap, rank_bits)
    _require_schedulable(r)
    dev = packed.device
    key2 = torch.empty((e, cap), dtype=torch.int32, device=dev)
    c2 = torch.empty((e, cap), dtype=torch.float32, device=dev)
    n_uniq = torch.empty((e,), dtype=torch.int32, device=dev)
    n_seg_full = max(2 * LANES, 1 << (w - 1).bit_length()) // LANES
    ptr = kernels.ptr
    err = kernels.library().attpc_merge_cluster(
        ptr(packed), ptr(qv), ptr(key2), ptr(c2), ptr(n_uniq), e, w,
        r.n_cta, r.chunk, n_seg_full, cap, rank_bits, kernels.stream(packed))
    kernels.check(err, "merge_cluster")
    launches_cluster += 1
    launches += 1
    return key2, c2, n_uniq


def merge_runs_fused(packed: torch.Tensor, qv: torch.Tensor, cap: int,
                     rank_bits: int):
    """The fused merge: K5 for CUDA tensors, the plain version for CPU
    tensors."""
    if packed.is_cuda:
        return merge_runs_fused_cuda(packed, qv, cap, rank_bits)
    return merge_runs_fused_plain(packed, qv, cap, rank_bits)
