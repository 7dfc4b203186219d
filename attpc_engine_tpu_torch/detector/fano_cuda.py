"""Wrapper of the Fano kernel: the step's Fano stage in one launch.

The kernel (``csrc/fano.cu``, ``attpc_fano_electrons``) replaces no TPU
kernel: the JAX package draws its Fano noise with ``jax.random`` in XLA
(``deposition.py:101-141``). It turns the step's |dKE| [T, E*K] f32 into
the electron counts [T, E*K] int32, drawing each counter's Philox4x32-10
words in 32-bit registers and applying Box-Muller and the Fano smearing
there. Its plain version is ``deposition.generate_electrons(dke,
deposition.fano_noise(...))``, some 345 int64 tensor passes a batch, and
it gives that version's bits on the card: it rounds each f32 operation on
its own, in the plain version's order, with IEEE ``logf``, ``sqrtf``,
``sinf`` and ``cosf``, and takes the scalars as the f32 values PyTorch
converts them to. What bounds it on the card is bytes: one read of dke and
one write of the counts. A counter whose four deposits are all 0 draws
nothing.

The seed and the batch's first global event id reach the kernel through
three words on the card (``fano_words``), read when it runs: a CUDA graph
of the step freezes a kernel's arguments, and ``DetectorSimulator.
simulate_batch`` refills the words before each replay, in the one copy of
the batch's inputs to the card.

``DetectorSimulator._core`` launches it on the card when no noise is given;
the recorder's counter ``fano.draws`` counts the draws of each step by
site, ``kernel`` or ``plain``, on every replay of a captured step too.
``launches`` counts the calls of ``fano_electrons_cuda``, and a launch
inside a captured CUDA graph once for each replay (``step_graph``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import kernels
from .deposition import FANO_STREAM

__all__ = ["fano_electrons_cuda", "fano_key", "fano_words", "launches",
           "WORDS"]

_MASK32 = 0xFFFFFFFF
WORDS = 3  # the kernel's words on the card

launches = 0


def fano_words(seed: int, event_start: int) -> np.ndarray:
    """The kernel's words of a batch, int32 [WORDS] on the host (uint32
    bits): the seed's low word, the low word of the batch's first global
    event id, the seed's high word."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed & _MASK32, int(event_start) & _MASK32, seed >> 32],
                    dtype=np.uint32).view(np.int32)


def fano_key(words: torch.Tensor) -> tuple[int, int]:
    """(seed, low word of the first event id) of ``fano_words``' words
    on the host: the key of ``deposition.fano_noise``'s draws, the same as
    the kernel's."""
    lo, ev0, hi = (v & _MASK32 for v in words.tolist())
    return lo | hi << 32, ev0


def fano_electrons_cuda(dke: torch.Tensor, words: torch.Tensor,
                        n_events: int, tracks: int, chunk_steps: int,
                        w_value: float, fano_factor: float) -> torch.Tensor:
    """Electron counts [n_steps, n_events * tracks] int32 of the deposits
    ``dke`` [n_steps, n_events * tracks] f32 on the card, equal to
    ``generate_electrons(dke, fano_noise(seed, event_start, n_events,
    tracks, n_steps, chunk_steps), w_value, fano_factor)``, where ``words``
    holds ``fano_words(seed, event_start)`` on dke's card when the kernel
    runs. Launched on the current stream of dke's card. The kernel refuses
    (and this raises) 2^31 or more counts or threads (one a counter)."""
    global launches
    if dke.dim() != 2:
        raise ValueError(f"expected dke [T, E*K], got {tuple(dke.shape)}")
    if n_events < 1 or tracks < 1 or chunk_steps < 1:
        raise ValueError(f"n_events {n_events}, tracks {tracks} and "
                         f"chunk_steps {chunk_steps} must be positive")
    n_steps = dke.shape[0]
    kernels.require(dke, "dke", torch.float32,
                    (n_steps, n_events * tracks))
    kernels.require(words, "words", torch.int32, (WORDS,))
    if words.device != dke.device:
        raise ValueError(f"words on {words.device}, dke on {dke.device}")
    out = torch.empty(dke.shape, dtype=torch.int32, device=dke.device)
    f32 = ctypes.c_float
    with torch.cuda.device(dke.device):
        err = kernels.library().attpc_fano_electrons(
            kernels.ptr(dke), kernels.ptr(out), kernels.ptr(words), n_steps,
            n_events, tracks, min(chunk_steps, n_steps),
            ctypes.c_uint32(FANO_STREAM), f32(1.0e6 / w_value),
            f32(fano_factor), f32(2.0 * math.pi), kernels.stream(dke))
    kernels.check(err, "fano_electrons")
    launches += 1
    return out
