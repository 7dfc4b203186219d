"""Peaks of the card and the bytes each kernel must move, for the
roofline shares. The byte counts are copies of ``chip_smoke.py``'s
(``rows_bytes``), of the K3 count its timing uses (each lane of each row
handed to the sort read once and written once, 8 B each) and of the
run-end compaction's (the sorted rows read once, the cap slots written)."""

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
    """K3's bytes in one default detector step of E events: the merge sort
    of [E, point_budget * 100] and the convert sort of [E, min(uniq,
    point_budget * 100)]."""
    w = point_budget * MESH_PIXELS
    return sort_bytes(e, w) + sort_bytes(e, min(uniq_budget, w))


def compact_bytes(e: int, w: int, cap: int) -> int:
    """The run-end compaction (``csrc/compact_runs.cu``) on sorted int64
    rows [E, W]: each lane read once (8 B), and the cap slots of its int32
    keys and f32 charge prefixes written (8 B a slot)."""
    return 8 * e * w + 8 * e * cap


def dispatch_compact_bytes(e: int, point_budget: int, uniq_budget: int) -> int:
    """The compaction's bytes in one default detector step of E events:
    the merge rows [E, point_budget * 100] into min(uniq, point_budget *
    100) slots an event."""
    w = point_budget * MESH_PIXELS
    return compact_bytes(e, w, min(uniq_budget, w))
