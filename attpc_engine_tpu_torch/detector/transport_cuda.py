"""K1 wrapper: the RK4 transport window on the card.

Kernel: ``csrc/transport.cu`` (``attpc_rk4_window``). It replaces the
Pallas kernel ``attpc_engine_tpu/detector/transport_pallas.py`` ``_kernel``
(integrate_tracks_pallas, integrate_tracks_pallas_chunked). What bounds it
on the card is latency: one dependent chain of four right-hand sides per
step for each of only 768 tracks at the flagship batch. The kernel keeps a
track's state in registers for the whole window and the dE/dx table in
shared memory, and runs each step through branch-free copies of the
compiler's division and square-root fast paths, recomputing the rare step
whose operands leave their exact range; see the source for the rest.

Each window is gated on the card: it reads its gate word, which the
window before it wrote ("some lane of the batch was alive at this window's
start"), returns at once where it is 0, and ORs the next window's word
where a lane is alive at its end. ``transport.integrate_tracks`` launches
every window of the physics window with no host sync and keeps the words.

``rk4_window`` takes the plain PyTorch version
(``transport.rk4_window_plain``) for CPU tensors and launches the kernel
for CUDA tensors, raising where the kernel cannot take them. ``launches``
counts kernel launches, a gated window that returns at once included;
a launch inside a captured CUDA graph is counted once for each replay of
the graph (``step_graph``).
"""

from __future__ import annotations

import torch

from .. import kernels
from .transport import Rk4Constants, rk4_window_plain

__all__ = ["rk4_window", "rk4_window_cuda", "launch_rk4", "launches",
           "MAX_TABLE_BYTES"]

# dynamic shared memory one block may use on Hopper
MAX_TABLE_BYTES = 227 * 1024

launches = 0


def launch_rk4(lib, pos, gv, alive, s_idx, mass, q_m, dedx, out_pos,
               out_dke, out_alive, k: Rk4Constants, gate,
               force_ieee: bool = False) -> None:
    """Check the arguments and launch ``attpc_rk4_window`` of ``lib`` for
    one window (arguments as ``rk4_window_plain``, the gate words [2] int32
    on the card; ``force_ieee`` as ``rk4_window_cuda``)."""
    b = pos.shape[0]
    t = out_dke.shape[0]
    n_species, n_tab = dedx.shape
    if n_species * n_tab * 4 > MAX_TABLE_BYTES:
        raise ValueError(
            f"dE/dx table of {n_species * n_tab * 4} B exceeds the "
            f"{MAX_TABLE_BYTES} B of shared memory a block may use"
        )
    for name, x, dtype, shape in (
        ("pos", pos, torch.float32, (b, 3)),
        ("gv", gv, torch.float32, (b, 3)),
        ("alive", alive, torch.bool, (b,)),
        ("s_idx", s_idx, torch.int32, (b,)),
        ("mass", mass, torch.float32, (b,)),
        ("q_m", q_m, torch.float32, (b,)),
        ("dedx", dedx, torch.float32, (n_species, n_tab)),
        ("out_pos", out_pos, torch.float32, (t, b, 3)),
        ("out_dke", out_dke, torch.float32, (t, b)),
        ("out_alive", out_alive, torch.bool, (t, b)),
        ("gate", gate, torch.int32, (2,)),
    ):
        kernels.require(x, name, dtype, shape)
    p = kernels.ptr
    err = lib.attpc_rk4_window(
        p(pos), p(gv), p(alive), p(s_idx), p(mass), p(q_m), p(dedx),
        n_species, n_tab, p(out_pos), p(out_dke), p(out_alive), p(gate),
        b, t,
        k.dt, k.half_dt, k.dt6, k.dens, k.c, k.log_lo, k.dlog, k.clip_hi,
        k.ke_lim, k.z_bound, k.rho2_bound, k.tiny, k.b_neg, k.e_neg,
        k.mev2kg, int(force_ieee), kernels.stream(pos),
    )
    kernels.check(err, "rk4_window")


def rk4_window_cuda(pos, gv, alive, s_idx, mass, q_m, dedx, out_pos, out_dke,
                    out_alive, k: Rk4Constants, gate,
                    force_ieee: bool = False) -> None:
    """Launch K1 for one window (arguments as ``rk4_window_plain``). With
    ``force_ieee`` every step goes through the compiler's IEEE operators
    instead of their branch-free fast paths: the same bits, slower; the
    reference the kernel is held to on the card."""
    global launches
    launch_rk4(kernels.library(), pos, gv, alive, s_idx, mass, q_m, dedx,
               out_pos, out_dke, out_alive, k, gate, force_ieee)
    launches += 1


def rk4_window(pos, gv, alive, s_idx, mass, q_m, dedx, out_pos, out_dke,
               out_alive, k: Rk4Constants, gate) -> None:
    """One gated RK4 window: the K1 kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if pos.is_cuda:
        rk4_window_cuda(pos, gv, alive, s_idx, mass, q_m, dedx, out_pos,
                        out_dke, out_alive, k, gate)
    else:
        rk4_window_plain(pos, gv, alive, s_idx, mass, q_m, dedx, out_pos,
                         out_dke, out_alive, k, gate)
