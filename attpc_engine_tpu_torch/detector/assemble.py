"""The Spyral assembly of packed rows, plain PyTorch version.

The detector step hands each batch over as packed ``[P, 2]`` int32 rows
(``DetectorSimulator._convert_to_spyral``: f32 charge bits, then
tb << 22 | pad << 8 | label), event ``e``'s rows at ``[offs[e],
offs[e+1])`` in descending integer tb. The assembly turns them into the
Spyral point cloud: it draws each row's TB wiggle, puts each event's rows
in ascending z (descending wiggled tb, stably) and computes the eight f64
columns x, y, z, amplitude, integral, pad, tb, pad size. It is the same
function as the JAX package's host assembly
(``DetectorSimulator.assemble_spyral_ordered``, simulator.py:675-719) and
the C++ library's ``sio_assemble_batch`` (``native/spyral_io.cpp:110``),
bit for bit:

- the wiggle of row ``i`` of event ``ev`` is
  ``numpy.random.Generator(Philox(key=[seed, ev])).random(n)[i]``: lane
  ``i % 4`` of Philox4x64-10 block ``i // 4``, run on the 256-bit counter
  ``i // 4 + 1`` (numpy increments the counter before each block), the
  key taken verbatim, the double ``(u64 >> 11) * 2^-53``;
- the order is ``np.argsort(-(tb + wiggle), kind="stable")`` within each
  event;
- the columns are the reference writer's f64 arithmetic, each operation
  rounded on its own (no multiply-add), divisions true divisions.

``assemble_plain`` is the version the CPU runs and the kernel
(``assemble_cuda``, ``csrc/assemble.cu``) is held to on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .deposition import _mulhilo32

__all__ = ["AssembleTables", "assemble_plain", "philox4x64_uniform"]

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
# Philox4x64 multipliers and key increments (Random123, numpy's Philox)
_M64 = (0xD2E7470EE14C6C93, 0xCA5A826395121157)
_W64 = (0x9E3779B97F4A7C15, 0xBB67AE8584CAA73B)
ADC_MAX = 4095.0


def _mulhilo64(m: int, c: tuple) -> tuple[tuple, tuple]:
    """(hi, lo) 64-bit halves of the 128-bit product of the constant ``m``
    and the word ``c``; a word is (high, low) 32-bit limbs in int64
    tensors. The four 32 x 32 products come from ``_mulhilo32``, and every
    column sum stays below 2^35."""
    m_hi, m_lo = m >> 32, m & _MASK32
    c_hi, c_lo = c
    h00, l00 = _mulhilo32(m_lo, c_lo)
    h01, l01 = _mulhilo32(m_lo, c_hi)
    h10, l10 = _mulhilo32(m_hi, c_lo)
    h11, l11 = _mulhilo32(m_hi, c_hi)
    s1 = h00 + l01 + l10
    s2 = h01 + h10 + l11 + (s1 >> 32)
    w3 = (h11 + (s2 >> 32)) & _MASK32
    return (w3, s2 & _MASK32), (s1 & _MASK32, l00)


def _xor(a: tuple, b: tuple, c: tuple) -> tuple:
    return a[0] ^ b[0] ^ c[0], a[1] ^ b[1] ^ c[1]


def _add64(k: tuple, w: int) -> tuple:
    """The word ``k`` plus the constant ``w``, mod 2^64."""
    lo = k[1] + (w & _MASK32)
    return (k[0] + (w >> 32) + (lo >> 32)) & _MASK32, lo & _MASK32


def _philox4x64(ctr: list, key: list) -> list:
    """Philox4x64-10 on words of 32-bit limbs: four counter words and two
    key words in, four words of random bits out."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = _add64(k0, _W64[0]), _add64(k1, _W64[1])
        hi0, lo0 = _mulhilo64(_M64[0], c0)
        hi1, lo1 = _mulhilo64(_M64[1], c2)
        c0, c1, c2, c3 = _xor(hi1, c1, k0), lo1, _xor(hi0, c3, k1), lo0
    return [c0, c1, c2, c3]


def philox4x64_uniform(seed: int, events: torch.Tensor,
                       counts: torch.Tensor) -> torch.Tensor:
    """U[0, 1) f64 TB wiggle of per-event runs of rows, pooled in event
    order: run ``e`` (``counts[e]`` rows) is
    ``Generator(Philox(key=[seed & (2^64 - 1), events[e]])).random(
    counts[e])``, bit for bit. ``events`` and ``counts`` are int64
    tensors on one device; the result lies there."""
    dev = counts.device
    counts = counts.to(torch.int64)
    events = events.to(device=dev, dtype=torch.int64)
    n_blocks = (counts + 3) // 4
    total_blocks = int(n_blocks.sum())
    total = int(counts.sum())
    if total == 0:
        return torch.zeros(0, dtype=torch.float64, device=dev)
    block_start = torch.cumsum(n_blocks, 0) - n_blocks
    ev_of_block = torch.repeat_interleave(torch.arange(len(counts),
                                                       device=dev), n_blocks)
    blk = (torch.arange(total_blocks, device=dev) - block_start[ev_of_block])
    # the 256-bit counter is incremented before each block; blk + 1 stays
    # below 2^63, so it never carries into the second word
    ctr_word = blk + 1
    zero = torch.zeros_like(ctr_word)
    ctr = [(ctr_word >> 32, ctr_word & _MASK32), (zero, zero), (zero, zero),
           (zero, zero)]
    seed = int(seed) & _MASK64
    ev = events[ev_of_block]
    key = [(seed >> 32, seed & _MASK32), (ev >> 32, ev & _MASK32)]
    words = _philox4x64(ctr, key)
    # the top 53 bits of each word, lane-major within a block
    bits = torch.stack([(hi << 21) | (lo >> 11) for hi, lo in words], dim=1)
    u = bits.reshape(-1).to(torch.float64) * (1.0 / 9007199254740992.0)
    row_start = torch.cumsum(counts, 0) - counts
    ev_of_row = torch.repeat_interleave(torch.arange(len(counts),
                                                     device=dev), counts)
    i = torch.arange(total, device=dev) - row_start[ev_of_row]
    return u[4 * block_start[ev_of_row] + i]


@dataclass
class AssembleTables:
    """The assembly's lookup tables and constants on one device: pad
    centers and sizes [n_pads] f64, the GET response sorted ascending
    [n_resp] and its prefix sums [n_resp + 1] f64 (``DetectorSimulator.
    _native_tables``), the response's maximum and the drift geometry."""

    pad_cx: torch.Tensor
    pad_cy: torch.Tensor
    pad_sizes: torch.Tensor
    resp_asc: torch.Tensor
    resp_prefix: torch.Tensor
    resp_max: float
    windows_edge: float
    micromegas_edge: float
    length: float

    @classmethod
    def from_numpy(cls, tables: dict,
                   device: torch.device | str) -> "AssembleTables":
        """From ``DetectorSimulator._native_tables()``'s arrays."""
        def t(name):
            return torch.as_tensor(np.ascontiguousarray(tables[name],
                                                        dtype=np.float64),
                                   device=device)

        return cls(t("pad_cx"), t("pad_cy"), t("pad_sizes"), t("resp_asc"),
                   t("resp_prefix"), float(tables["resp_max"]),
                   float(tables["windows_edge"]),
                   float(tables["micromegas_edge"]), float(tables["length"]))


def assemble_plain(packed: torch.Tensor, counts: torch.Tensor,
                   event_ids: torch.Tensor, seed: int,
                   tables: AssembleTables,
                   wiggle: torch.Tensor | None = None):
    """Packed rows [P, 2] int32 of events with ``counts`` [E] rows each
    (P = sum(counts)) and global ids ``event_ids`` [E] -> (spyral [P, 8]
    f64, labels [P] int64), each event's rows in ascending z. ``seed``
    keys the wiggle (masked to 64 bits); ``wiggle`` [P] f64 replaces the
    Philox draws (the tests force ties with it). Every tensor lies on one
    device."""
    dev = packed.device
    f64 = torch.float64
    counts = counts.to(device=dev, dtype=torch.int64)
    p = packed.shape[0]
    if wiggle is None:
        wiggle = philox4x64_uniform(seed, event_ids, counts)
    q = packed[:, 0].contiguous().view(torch.float32).to(f64)
    meta = packed[:, 1].to(torch.int64)
    tbf = (meta >> 22).to(f64) + wiggle
    pad = (meta >> 8) & 0x3FFF
    lab = meta & 0xFF
    # stable sort on (event, -tbf): by -tbf first, then stably by event
    ev_of_row = torch.repeat_interleave(
        torch.arange(len(counts), device=dev), counts)
    order = torch.sort(-tbf, stable=True).indices
    order = order[torch.sort(ev_of_row[order], stable=True).indices]
    q, tbf, pad, lab = q[order], tbf[order], pad[order], lab[order]

    def full(x: float) -> torch.Tensor:
        # a tensor operand: ATen's CUDA division by a CPU scalar multiplies
        # by its reciprocal, and ``x / t`` is reciprocal(t) * x
        return torch.full((p,), x, dtype=f64, device=dev)

    amp = q * tables.resp_max
    amp = torch.where(ADC_MAX < amp, ADC_MAX, amp)
    thr = torch.div(full(ADC_MAX), torch.where(q < 1e-300, 1e-300, q))
    idx = torch.searchsorted(tables.resp_asc, thr, right=True)
    n_resp = tables.resp_asc.shape[0]
    integral = q * tables.resp_prefix[idx] + ADC_MAX * (n_resp - idx).to(f64)
    win, mm = tables.windows_edge, tables.micromegas_edge
    z = torch.div(win - tbf, full(win - mm)) * tables.length * 1000.0
    spyral = torch.stack([
        tables.pad_cx[pad], tables.pad_cy[pad], z, amp, integral,
        pad.to(f64), tbf, tables.pad_sizes[pad],
    ], dim=1)
    return spyral, lab
