"""The comparison that decides ``correct``: the timed run's Spyral rows of
the sampled events against the reference's rows of the same events.

A row is keyed by its pad, its integer time bucket and its label; the
merge leaves one row per (pad, tb) in an event, so an event's keys are a
set. The numbers, each held to a limit of its own (``cells/<cell>.json``):

- ``missing_events``: events the window never delivered or delivered
  twice, and sampled events the sink did not keep. Exact: limit 0.
- ``rows_unmatched``: rows whose key is on one side only, over the
  reference's rows of all sampled events.
- ``event_unmatched_max``: the same share in the worst sampled event.
- ``charge_l1``: the summed absolute gap of the charge integral (column
  4) over the rows both sides hold, over the reference's sum there.
- ``amplitude_l1``: the same of the amplitude (column 3).
- ``event_charge_l1_max``, ``event_amplitude_l1_max``: the same two gaps
  in the worst sampled event, so that one event's or one batch slot's
  wrong charges show, which the pooled gaps dilute.
- ``assembly_bits``: in events whose keys agree, rows whose x, y, z, pad,
  wiggled tb, pad size or label differ in any bit: the TB wiggle, the z
  order and the columns. Exact: limit 0.
"""

from __future__ import annotations

import numpy as np

SAMPLE_EVENTS = 256  # events drawn from the seed for the comparison
EXACT_COLUMNS = [0, 1, 2, 5, 6, 7]
AMPLITUDE, CHARGE = 3, 4
EMPTY = (np.zeros((0, 8)), np.zeros(0, dtype=np.int64))


def row_keys(spyral: np.ndarray, labels: np.ndarray) -> np.ndarray:
    pad = spyral[:, 5].astype(np.int64)
    tb = np.floor(spyral[:, 6]).astype(np.int64)
    return (pad * 512 + tb) * 256 + np.asarray(labels, dtype=np.int64)


def compare(got: dict, ref: dict, missing: int = 0) -> dict:
    """Numbers of ``got`` against ``ref``, each {event id: (spyral [n, 8],
    labels [n])}, over the events of ``ref``; ``missing`` adds the events
    the window lost."""
    ref_rows = unmatched = bits = 0
    worst = 0.0
    gap = {AMPLITUDE: 0.0, CHARGE: 0.0}
    total = {AMPLITUDE: 0.0, CHARGE: 0.0}
    worst_gap = {AMPLITUDE: 0.0, CHARGE: 0.0}
    for ev, (rs, rl) in ref.items():
        if ev not in got:
            missing += 1
        gs, gl = got.get(ev, EMPTY)
        kg, kr = row_keys(gs, gl), row_keys(rs, rl)
        _, ig, ir = np.intersect1d(kg, kr, return_indices=True)
        u = len(kg) + len(kr) - 2 * len(ig)
        ref_rows += len(kr)
        unmatched += u
        worst = max(worst, u / max(len(kr), 1))
        for col in (AMPLITUDE, CHARGE):
            g = float(np.abs(gs[ig, col] - rs[ir, col]).sum())
            t = float(np.abs(rs[ir, col]).sum())
            gap[col] += g
            total[col] += t
            worst_gap[col] = max(worst_gap[col], share(g, t))
        if u == 0:
            a = np.ascontiguousarray(gs[:, EXACT_COLUMNS]).view(np.int64)
            b = np.ascontiguousarray(rs[:, EXACT_COLUMNS]).view(np.int64)
            bits += int(((a != b).any(axis=1)
                         | (np.asarray(gl) != np.asarray(rl))).sum())
    return {
        "missing_events": missing,
        "rows_unmatched": unmatched / max(ref_rows, 1),
        "event_unmatched_max": worst,
        "charge_l1": share(gap[CHARGE], total[CHARGE]),
        "amplitude_l1": share(gap[AMPLITUDE], total[AMPLITUDE]),
        "event_charge_l1_max": worst_gap[CHARGE],
        "event_amplitude_l1_max": worst_gap[AMPLITUDE],
        "assembly_bits": bits,
    }


def share(gap: float, total: float) -> float:
    """``gap`` over ``total``; a gap over nothing is infinite."""
    if total > 0:
        return gap / total
    return 0.0 if gap == 0 else float("inf")


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that ``limits`` names is within its limit, {name:
    {value, limit}} of those numbers). A number that is not there fails."""
    checks = {k: {"value": numbers.get(k, float("inf")), "limit": v}
              for k, v in limits.items() if isinstance(v, (int, float))}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
