"""The Spyral assembly on the card: TB wiggle, per-event z order and the
eight f64 columns in one kernel.

Kernel: ``csrc/assemble.cu`` (``attpc_assemble_spyral``), one CTA per
event. It replaces no TPU kernel: the JAX package assembles on the host
(``DetectorSimulator.assemble_spyral_ordered``, simulator.py:675, and the
C++ library ``native/spyral_io.cpp:110``), because the TPU's host link
could not carry the f64 rows; on the card the stage follows the step, and
only the finished rows go to the host. What bounds it is bytes: 8 B read
and 72 B written a row (see the source).

``assemble`` takes the plain PyTorch version (``assemble.assemble_plain``)
for CPU tensors and launches the kernel for CUDA tensors, raising where
the kernel cannot take them or fails: nothing falls back to the host.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .assemble import AssembleTables, assemble_plain

__all__ = ["assemble", "assemble_cuda", "launches", "MAX_RESPONSE"]

MAX_RESPONSE = 1024  # response samples the kernel holds in shared memory

launches = 0


def assemble_cuda(packed: torch.Tensor, counts: torch.Tensor,
                  event_ids: torch.Tensor, seed: int,
                  tables: AssembleTables,
                  wiggle: torch.Tensor | None = None):
    """Launch the assembly kernel (arguments and result as
    ``assemble_plain``; ``counts`` int32 and ``event_ids`` int64 on the
    card). Rows past ``packed``'s are never written: the caller passes
    ``sum(counts)`` rows."""
    global launches
    p = packed.shape[0]
    e = counts.shape[0]
    n_pads = tables.pad_cx.shape[0]
    n_resp = tables.resp_asc.shape[0]
    if not 1 <= n_resp <= MAX_RESPONSE:
        raise ValueError(f"{n_resp} response samples: the kernel takes 1 to "
                         f"{MAX_RESPONSE}")
    checks = [
        ("packed", packed, torch.int32, (p, 2)),
        ("counts", counts, torch.int32, (e,)),
        ("event_ids", event_ids, torch.int64, (e,)),
        ("pad_cx", tables.pad_cx, torch.float64, (n_pads,)),
        ("pad_cy", tables.pad_cy, torch.float64, (n_pads,)),
        ("pad_sizes", tables.pad_sizes, torch.float64, (n_pads,)),
        ("resp_asc", tables.resp_asc, torch.float64, (n_resp,)),
        ("resp_prefix", tables.resp_prefix, torch.float64, (n_resp + 1,)),
    ]
    if wiggle is not None:
        checks.append(("wiggle", wiggle, torch.float64, (p,)))
    for name, x, dtype, shape in checks:
        kernels.require(x, name, dtype, shape)
    dev = packed.device
    spyral = torch.empty((p, 8), dtype=torch.float64, device=dev)
    labels = torch.empty(p, dtype=torch.int64, device=dev)
    if p == 0 or e == 0:  # nothing to assemble: no launch
        return spyral, labels
    scratch = torch.empty(p, dtype=torch.float64, device=dev)
    lib = kernels.library()
    ptr = kernels.ptr
    err = lib.attpc_assemble_spyral(
        ptr(packed), p, ptr(counts), e, ptr(event_ids),
        ctypes.c_uint64(int(seed) & 0xFFFFFFFFFFFFFFFF),
        ptr(wiggle) if wiggle is not None else None,
        ptr(tables.pad_cx), ptr(tables.pad_cy), ptr(tables.pad_sizes), n_pads,
        ptr(tables.resp_asc), ptr(tables.resp_prefix), n_resp,
        tables.resp_max, tables.windows_edge, tables.micromegas_edge,
        tables.length, ptr(scratch), ptr(spyral), ptr(labels),
        kernels.stream(packed),
    )
    kernels.check(err, "assemble_spyral")
    launches += 1
    return spyral, labels


def assemble(packed: torch.Tensor, counts: torch.Tensor,
             event_ids: torch.Tensor, seed: int, tables: AssembleTables,
             wiggle: torch.Tensor | None = None):
    """The Spyral assembly of packed rows: the kernel for CUDA tensors, the
    plain version for CPU tensors (arguments and result as
    ``assemble_plain``)."""
    if packed.is_cuda:
        return assemble_cuda(packed, counts, event_ids, seed, tables, wiggle)
    return assemble_plain(packed, counts, event_ids, seed, tables, wiggle)
