"""Peaks of the card and the bytes each kernel must move, for the
roofline shares. The byte counts are copies of ``chip_smoke.py``'s
(``rows_bytes``) and of the K3 count its timing uses: each lane of each row
handed to the sort read once and written once, 8 B each."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
PAD_TABLE_BYTES = 560 * 640 * 4
MESH_PIXELS = 100


def bound_s(n_bytes: float) -> float:
    """The least seconds the card could take to move ``n_bytes``."""
    return n_bytes / HBM_BYTES_PER_S


def rows_bytes(e: int, pb: int) -> int:
    """The deposit-rows kernel: its inputs read once (px, py, ptbf, pne,
    tbr: 4 B, taken: 1 B a point slot), the int32 pad table, the [E, pb *
    100] int64 rows written."""
    return e * pb * (5 * 4 + 1) + PAD_TABLE_BYTES + e * pb * MESH_PIXELS * 8


def sort_bytes(e: int, w: int) -> int:
    """K3 on int64 rows [E, W]: each lane read once and written once."""
    return 16 * e * w


def dispatch_sort_bytes(e: int, point_budget: int, uniq_budget: int) -> int:
    """K3's bytes in one default detector step of E events: the two merge
    sorts of [E, point_budget * 100] and the convert sort of [E, min(uniq,
    point_budget * 100)]."""
    w = point_budget * MESH_PIXELS
    return 2 * sort_bytes(e, w) + sort_bytes(e, min(uniq_budget, w))
