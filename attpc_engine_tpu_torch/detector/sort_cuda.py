"""K3 wrapper: row-wise ascending sort of int64 [E, W].

K3 replaces the Pallas kernel ``attpc_engine_tpu/detector/sort_pallas.py``
``_sort_kernel`` (sort_pairs_pallas, and sort_i64_pallas through it) at all
three call sites of the detector step: the merge sort of
``deposition.deposit_and_merge`` (rows of point_budget * 100 = 102,400 at
the flagship; the run-end compaction, ``compact_cuda``, takes the place of
the TPU kernel's second merge sort), the first sort of K5 (``merge_cuda``)
and the convert sort of ``DetectorSimulator._convert_to_spyral`` (rows of
uniq_budget = 12,288).
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
- **wide** (``csrc/sort_cluster.cu`` then ``csrc/merge_rows.cu``): wider
  rows, which further doublings of the overflow retry make (both merge
  sorts at point budget 4,096 and more). Each row is cut into ``chunks``
  (the smallest power of two >= 2 that leaves chunks of at most
  ``WIDE_CHUNK`` elements), the cluster kernel sorts every chunk as a row
  of its own (phase A), and log2(chunks) merge-path passes join them
  (phase B): each row goes through device memory 1 + log2(chunks) times.
  It allocates its output, one [E, W] scratch and a small split table.

This is a width rule, not a fallback: a launch that fails raises.
``sort_rows`` takes ``torch.sort`` (the plain version) for CPU tensors and
launches the kernels for CUDA tensors, raising where they cannot take
them.

The default step's merge sort takes a third route, ``sort_rows_live``
(the **live** route, ``attpc_sort_rows_live`` and ``attpc_merge_rows_live``):
given each row's prefix ``lanes`` = min(n_points, point_budget) * 100,
past which every lane is the sentinel element ``pack64(KEY_SENTINEL,
0.0)``, it sorts each row in place over its prefix alone, keeping only the
lanes that are not the sentinel, so that its work follows the live lanes
and not the width; the rows are the same bits as ``sort_rows``'s. Each row
takes, on the card, the smallest cluster of at most 8 CTAs whose CTAs
hold its prefix, or else the wide route over the prefix (``live_sites``
counts the rows by route; the kernels' head comments give the design).
Its plain version, for CPU tensors, is ``torch.sort`` of the whole row.

``launches_cluster``, ``launches_wide`` and ``launches_live`` count the
calls that take each route and ``launches`` their sum. ``pack64`` and
``unpack64`` make and split the merge sorts' int64 (key, charge) elements.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels

__all__ = [
    "sort_rows",
    "sort_rows_plain",
    "sort_rows_cuda",
    "sort_rows_live",
    "sort_rows_live_cuda",
    "route",
    "live_sites",
    "wide_plan",
    "sort_wide",
    "Route",
    "pack64",
    "unpack64",
    "launches",
    "launches_cluster",
    "launches_wide",
    "launches_live",
]

# cluster route (csrc/sort_cluster.cu): shared memory of one CTA
SHARED_BYTES = 232_448  # a block's dynamic shared memory on the H100
CTA_THREADS = 1024
DIGITS = 256
# per-warp 16-bit digit counts, digit totals and offsets, scan sums, flag
FIXED_BYTES = (CTA_THREADS // 32) * DIGITS * 2 + 2 * DIGITS * 4 + 128
CTA_CAPACITY = 13_360  # elements per CTA: two 8-byte buffers of them
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# wide route: rows are cut into chunks of at most this many elements, one
# CTA's: of 2-64 chunks, the one-CTA chunks sorted [384, 409600] and
# [384, 819200] fastest on an NVIDIA H100 80GB HBM3, 700.00 W, and
# half-CTA chunks slower (tools/profile_torch_step.py --wide-phases;
# the table is in PERF.md)
WIDE_CHUNK = CTA_CAPACITY
# live route: prefixes up to 8 CTAs' worth take a cluster, wider ones the
# wide route over the prefix, in chunks of CTA_CAPACITY (csrc/sort_live.cuh
# gives the measurement behind 8)
LIVE_CLUSTER_LANES = 8 * CTA_CAPACITY
LIVE_CLUSTER_SIZES = tuple(n for n in CLUSTER_SIZES
                           if n * CTA_CAPACITY <= LIVE_CLUSTER_LANES)

launches = 0
launches_cluster = 0
launches_wide = 0
launches_live = 0

_MASK32 = 0xFFFFFFFF
_schedulable: dict[int, int] = {}


class Route(NamedTuple):
    """How K3 sorts rows of one width. "cluster": one cluster of ``n_cta``
    CTAs of ``chunk`` elements each per row (``chunks`` 1, ``chunk_w`` the
    width). "wide": each row cut into ``chunks`` chunks of ``chunk_w``
    elements (the last may be shorter), each sorted by a cluster of
    ``n_cta`` CTAs of ``chunk``, then ``passes`` merge passes."""

    name: str
    n_cta: int
    chunk: int
    chunks: int
    chunk_w: int

    @property
    def shared_bytes(self) -> int:
        """Dynamic shared memory of one CTA of the cluster kernel."""
        return 16 * self.chunk + FIXED_BYTES

    @property
    def passes(self) -> int:
        """Merge passes after the chunk sort: log2(chunks)."""
        return self.chunks.bit_length() - 1


def _cluster(width: int) -> Route | None:
    """The smallest cluster whose CTAs hold a row of ``width``, each an
    even chunk of ceil(width / n_cta); None if 16 CTAs do not."""
    for n in CLUSTER_SIZES:
        if n * CTA_CAPACITY >= width:
            chunk = max(2, -(-int(width) // n))
            return Route("cluster", n, chunk + (chunk & 1), 1, int(width))
    return None


def wide_plan(width: int, chunks: int) -> Route:
    """The wide route for rows of ``width`` cut into ``chunks`` (a power of
    two >= 2) chunks of ceil(width / chunks), each on the cluster that
    ``route`` gives a row of that width."""
    if chunks < 2 or chunks & (chunks - 1):
        raise ValueError(f"chunks={chunks}: expected a power of two >= 2")
    chunk_w = -(-int(width) // chunks)
    inner = _cluster(chunk_w)
    if inner is None or (chunks - 1) * chunk_w >= width:
        raise ValueError(f"rows of {width} cannot be cut into {chunks} "
                         f"chunks that the cluster kernel sorts")
    return Route("wide", inner.n_cta, inner.chunk, chunks, chunk_w)


def route(width: int) -> Route:
    """The route for rows of ``width``: the cluster route where 16 CTAs
    hold the row, else the wide route with the fewest chunks (at least
    two) of at most ``WIDE_CHUNK`` elements."""
    r = _cluster(width)
    if r is not None:
        return r
    chunks = 2
    while -(-int(width) // chunks) > WIDE_CHUNK:
        chunks *= 2
    return wide_plan(width, chunks)


def live_sites(lanes) -> dict[str, int]:
    """Rows by the live route's site of their prefixes (any int array),
    the sites with at least one row: "cluster-<n>" for the smallest cluster
    of ``LIVE_CLUSTER_SIZES`` whose CTAs hold the prefix, "wide" past
    ``LIVE_CLUSTER_LANES``, "empty" for an empty prefix, which no launch
    sorts."""
    lanes = np.asarray(lanes, dtype=np.int64)
    edges = np.array([0] + [n * CTA_CAPACITY for n in LIVE_CLUSTER_SIZES])
    names = (["empty"] + [f"cluster-{n}" for n in LIVE_CLUSTER_SIZES]
             + ["wide"])
    counts = np.bincount(np.searchsorted(edges, lanes, side="left"),
                         minlength=len(names))
    return {name: int(c) for name, c in zip(names, counts) if c}


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


def _require_schedulable(n_cta: int) -> int:
    """Raise unless the card can run one cluster of ``n_cta`` CTAs at
    full capacity; asked once per cluster size. Returns how many such
    clusters the card holds at once."""
    if n_cta not in _schedulable:
        n = ctypes.c_int(0)
        err = kernels.library().attpc_sort_rows_cluster_occupancy(
            n_cta, CTA_CAPACITY, ctypes.byref(n))
        kernels.check(err, "sort_rows_cluster occupancy")
        _schedulable[n_cta] = n.value
    if _schedulable[n_cta] < 1:
        raise RuntimeError(f"the card cannot schedule a cluster of {n_cta} "
                           f"CTAs with {16 * CTA_CAPACITY + FIXED_BYTES} B "
                           f"of shared memory each")
    return _schedulable[n_cta]


def _sort_chunks(x: torch.Tensor, out: torch.Tensor, r: Route) -> None:
    """Each of the ``r.chunks`` chunks of every row of ``x`` sorted into the
    same place of ``out`` by the cluster kernel: the whole row on the
    cluster route, phase A on the wide route."""
    _require_schedulable(r.n_cta)
    e, w = x.shape
    last = w - (r.chunks - 1) * r.chunk_w
    err = kernels.library().attpc_sort_rows_cluster(
        kernels.ptr(x), kernels.ptr(out), e, r.chunk_w, r.n_cta, r.chunk, w,
        r.chunks, last, kernels.stream(x))
    kernels.check(err, "sort_rows_cluster")


def sort_wide(x: torch.Tensor, r: Route, mark=None) -> torch.Tensor:
    """The wide route's launches on a contiguous CUDA int64 [E, W] under
    plan ``r`` (``route`` or ``wide_plan``): the chunk sort into one of the
    output and one scratch, then ``r.passes`` merge passes from one into the
    other, the buffers chosen by the parity of the passes so that the last
    lands in the output. ``mark(label)``, if given, is called after each
    launch (``tools/profile_torch_step.py --wide-phases`` records a CUDA
    event there). Counts no launch: ``sort_rows_cuda`` does."""
    e, w = x.shape
    lib = kernels.library()
    out, scratch = torch.empty_like(x), torch.empty_like(x)
    bufs = (scratch, out) if r.passes % 2 else (out, scratch)
    _sort_chunks(x, bufs[0], r)
    if mark is not None:
        mark("chunk sort")
    n_splits = lib.attpc_merge_rows_splits(e, w, r.chunk_w)
    splits = torch.empty(n_splits, dtype=torch.int32, device=x.device)
    run = r.chunk_w
    for p in range(r.passes):
        err = lib.attpc_merge_rows_pass(
            kernels.ptr(bufs[p % 2]), kernels.ptr(bufs[(p + 1) % 2]),
            kernels.ptr(splits), n_splits, e, w, run, kernels.stream(x))
        kernels.check(err, "merge_rows_pass")
        if mark is not None:
            mark(f"merge pass {p + 1}")
        run *= 2
    return out


def sort_rows_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch K3 on a contiguous CUDA int64 [E, W]; returns a new tensor.
    Rows of at most 16 * CTA_CAPACITY elements take the cluster route,
    wider ones the wide route (``route``)."""
    global launches, launches_cluster, launches_wide
    if x.dim() != 2:
        raise ValueError(f"expected [E, W], got shape {tuple(x.shape)}")
    kernels.require(x, "x", torch.int64)
    r = route(x.shape[1])
    if r.name == "cluster":
        out = torch.empty_like(x)
        _sort_chunks(x, out, r)
        launches_cluster += 1
    else:
        out = sort_wide(x, r)
        launches_wide += 1
    launches += 1
    return out


def sort_rows_live_cuda(rows: torch.Tensor,
                        lanes: torch.Tensor) -> torch.Tensor:
    """The live route on a contiguous CUDA int64 [E, W] ``rows`` with
    int32 [E] ``lanes``: each row sorted in place over [0, lanes[i]), every
    lane at or past which must be the sentinel element (``sort_rows_live``).
    Allocates, where a prefix can pass ``LIVE_CLUSTER_LANES``, one scratch
    like ``rows``, the wide-row list and the split table. Returns
    ``rows``."""
    global launches, launches_live
    if rows.dim() != 2:
        raise ValueError(f"expected [E, W], got shape {tuple(rows.shape)}")
    kernels.require(rows, "rows", torch.int64)
    kernels.require(lanes, "lanes", torch.int32)
    e, w = rows.shape
    if tuple(lanes.shape) != (e,) or lanes.device != rows.device:
        raise ValueError(f"lanes: expected int32 [{e}] on {rows.device}")
    for n_cta in LIVE_CLUSTER_SIZES:
        _require_schedulable(n_cta)
    lib = kernels.library()
    stream = kernels.stream(rows)
    # the wide route's split table; none where no prefix can pass
    # LIVE_CLUSTER_LANES, and then neither a scratch nor a list
    n_splits = lib.attpc_merge_rows_live_splits(e, w)
    if not n_splits:
        err = lib.attpc_sort_rows_live(kernels.ptr(rows), None,
                                       kernels.ptr(lanes), None, e, w, 0,
                                       stream)
        kernels.check(err, "sort_rows_live")
    else:
        scratch = torch.empty_like(rows)
        listed = torch.empty(1 + e, dtype=torch.int32, device=rows.device)
        splits = torch.empty(n_splits, dtype=torch.int32, device=rows.device)
        buffers = [kernels.ptr(t) for t in (rows, scratch, lanes, listed)]
        err = lib.attpc_sort_rows_live(*buffers, e, w, _schedulable[1],
                                       stream)
        kernels.check(err, "sort_rows_live")
        err = lib.attpc_merge_rows_live(*buffers, kernels.ptr(splits),
                                        n_splits, e, w, stream)
        kernels.check(err, "merge_rows_live")
    launches_live += 1
    launches += 1
    return rows


def sort_rows_live(rows: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """Each row of int64 [E, W] ``rows`` ascending, given int32 [E]
    ``lanes``: every lane of row i at or past lanes[i] is the sentinel
    element ``pack64(KEY_SENTINEL, 0.0)``, and no lane is above it (the
    default step's merge rows, lanes = min(n_points, point_budget) * 100).
    The live route for CUDA tensors, which sorts ``rows`` in place and
    returns it; ``torch.sort`` of the whole row for CPU tensors, which
    returns a new tensor. Either way the caller reads only the result."""
    if rows.is_cuda:
        return sort_rows_live_cuda(rows, lanes)
    return sort_rows_plain(rows)


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row of int64 [E, W] ascending: the K3 kernel for CUDA tensors,
    ``torch.sort`` for CPU tensors."""
    if x.is_cuda:
        return sort_rows_cuda(x)
    return sort_rows_plain(x)
