"""K3 wrapper: row-wise ascending sort of int64 [E, W].

K3 replaces the Pallas kernel ``attpc_engine_tpu/detector/sort_pallas.py``
``_sort_kernel`` (sort_pairs_pallas, and sort_i64_pallas through it) at all
three call sites of the detector step: the two merge sorts of
``deposition.deposit_and_merge`` (rows of point_budget * 100 = 102,400 at
the flagship), the first sort of K5 (``merge_cuda``) and the convert sort
of ``DetectorSimulator._convert_to_spyral`` (rows of uniq_budget = 12,288).
What bounds it on the card is bytes through device memory: each row read
once and written once. It has two routes, chosen by ``route`` from the
width alone before any launch:

- **cluster** (``csrc/sort_cluster.cu``, ``attpc_sort_rows_cluster``): rows
  of at most 16 * ``CTA_CAPACITY`` = 213,760 elements. A thread-block
  cluster of the smallest n_cta in (1, 2, 4, 8, 16) whose shared memory
  holds the row sorts it with an LSD radix sort (eight passes of 8-bit
  digits) in shared and distributed shared memory: one load and one store
  of each row, no scratch. The flagship's merge rows take 8 CTAs, the
  convert rows 1, the first budget doubling of ``run_simulation``'s
  overflow retry (204,800) 16.
- **wide** (``csrc/sort_rows.cu``, ``attpc_sort_rows_i64``): wider rows,
  which further doublings of the overflow retry make, keep the bitonic
  network: rows padded to a power of two, 16,384-element tiles in shared
  memory and passes through a device-memory scratch for larger distances.

This is a width rule, not a fallback: a cluster launch that fails raises.
``sort_rows`` takes ``torch.sort`` (the plain version) for CPU tensors and
launches the kernel for CUDA tensors, raising where the kernel cannot take
them. ``launches_cluster`` and ``launches_wide`` count the launches of
each route and ``launches`` their sum. ``pack64`` and ``unpack64`` make and
split the merge sorts' int64 (key, charge) elements.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import kernels

__all__ = [
    "sort_rows",
    "sort_rows_plain",
    "sort_rows_cuda",
    "route",
    "Route",
    "pack64",
    "unpack64",
    "launches",
    "launches_cluster",
    "launches_wide",
]

# cluster route (csrc/sort_cluster.cu): shared memory of one CTA
SHARED_BYTES = 232_448  # a block's dynamic shared memory on the H100
CTA_THREADS = 1024
DIGITS = 256
# per-warp 16-bit digit counts, digit totals and offsets, scan sums, flag
FIXED_BYTES = (CTA_THREADS // 32) * DIGITS * 2 + 2 * DIGITS * 4 + 128
CTA_CAPACITY = 13_360  # elements per CTA: two 8-byte buffers of them
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MAX_ROWS = 65535  # the wide route's gridDim.y

launches = 0
launches_cluster = 0
launches_wide = 0

_MASK32 = 0xFFFFFFFF
_schedulable: dict[int, int] = {}


class Route(NamedTuple):
    """How K3 sorts rows of one width: ``name`` "cluster" with ``n_cta``
    CTAs of ``chunk`` elements each, or "wide" (n_cta and chunk 0)."""

    name: str
    n_cta: int
    chunk: int

    @property
    def shared_bytes(self) -> int:
        """Dynamic shared memory of one CTA on the cluster route."""
        return 16 * self.chunk + FIXED_BYTES if self.n_cta else 0


def route(width: int) -> Route:
    """The route for rows of ``width``: the smallest cluster whose CTAs
    hold the row, each an even chunk of ceil(width / n_cta), else wide."""
    for n in CLUSTER_SIZES:
        if n * CTA_CAPACITY >= width:
            chunk = max(2, -(-int(width) // n))
            return Route("cluster", n, chunk + (chunk & 1))
    return Route("wide", 0, 0)


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


def _require_schedulable(r: Route) -> None:
    """Raise unless the card can run one cluster of ``r.n_cta`` CTAs at
    full capacity; asked once per cluster size."""
    if r.n_cta not in _schedulable:
        n = ctypes.c_int(0)
        err = kernels.library().attpc_sort_rows_cluster_occupancy(
            r.n_cta, CTA_CAPACITY, ctypes.byref(n))
        kernels.check(err, "sort_rows_cluster occupancy")
        _schedulable[r.n_cta] = n.value
    if _schedulable[r.n_cta] < 1:
        raise RuntimeError(f"the card cannot schedule a cluster of "
                           f"{r.n_cta} CTAs with {r.shared_bytes} B of "
                           f"shared memory each")


def sort_rows_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch K3 on a contiguous CUDA int64 [E, W]; returns a new tensor.
    Rows of at most 16 * CTA_CAPACITY elements take the cluster route,
    wider ones the wide route (``route``)."""
    global launches, launches_cluster, launches_wide
    if x.dim() != 2:
        raise ValueError(f"expected [E, W], got shape {tuple(x.shape)}")
    kernels.require(x, "x", torch.int64)
    e, w = x.shape
    r = route(w)
    out = torch.empty_like(x)
    if r.name == "cluster":
        _require_schedulable(r)
        err = kernels.library().attpc_sort_rows_cluster(
            kernels.ptr(x), kernels.ptr(out), e, w, r.n_cta, r.chunk,
            kernels.stream(x))
        kernels.check(err, "sort_rows_cluster")
        launches_cluster += 1
    else:
        if e > MAX_ROWS:
            raise ValueError(f"{e} rows exceed the wide route's {MAX_ROWS}")
        total = 1 << (w - 1).bit_length()
        scratch = torch.empty((e, total), dtype=torch.int64, device=x.device)
        err = kernels.library().attpc_sort_rows_i64(
            kernels.ptr(x), kernels.ptr(out), kernels.ptr(scratch), e, w,
            total, kernels.stream(x))
        kernels.check(err, "sort_rows_i64")
        launches_wide += 1
    launches += 1
    return out


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row of int64 [E, W] ascending: the K3 kernel for CUDA tensors,
    ``torch.sort`` for CPU tensors."""
    if x.is_cuda:
        return sort_rows_cuda(x)
    return sort_rows_plain(x)
