"""Electron generation, diffusion mesh and (pad, tb) merge (port of
attpc_engine_tpu/detector/deposition.py).

The stage, per batch of events (see the JAX module's docstring for the
reasoning behind each step):

1. ``generate_electrons``: Fano-smeared electron counts per deposit point.
   The noise is an explicit input; production draws it from
   ``fano_noise``, a counter-based Philox4x32-10 stream keyed by
   (seed, global event id) and counted by (window chunk, index), so an
   event's draws do not depend on the batch it rides in or on the window
   length. Tests feed the JAX draws instead.
2. per-event compaction of the valid deposit points into windows of
   ``point_budget`` slots, with the overflow counted,
3. the 10x10 diffusion mesh around each point: pixel coordinates, pixel
   charges, and the merge key ((pad * 512 + tb) << rank_bits) | rank of
   every pixel from the pad-id table. The default configuration
   (``merge="sorts"``, ``lookup="two_stage"``) does all of it in one kernel
   (``deposit_rows``: ``deposit_cuda.deposit_rows_cuda`` on the card),
   which writes the int64 rows the merge sort takes; the others
   build the mesh in PyTorch (``pixel_keys_charges``) and look the keys up
   with ``deposit_cuda.packed_key_lookup`` (K2, ``lookup="two_stage"``) or
   ``packed_key_lookup_rows`` (K6, ``"one_stage"``),
4. the per-event merge of equal (pad, tb) keys (``_merge_runs``; with
   ``merge="sorts"`` a row sort through ``sort_cuda.sort_rows``, K3, and
   the run-end compaction with its charge prefix, ``compact_runs``; the
   default configuration's rows take K3's live route,
   ``sort_cuda.sort_rows_live``, over each event's point prefix; with
   ``"fused"`` ``merge_cuda.merge_runs_fused``, K5), the last writer's
   label, and the overflow counters.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import require_device
from ..utils.profiling import stage
from .compact_cuda import compact_runs_cuda
from .deposit_cuda import (
    deposit_rows_cuda,
    packed_key_lookup,
    packed_key_lookup_plain,
    packed_key_lookup_rows,
)
from .merge_cuda import KEY_SENTINEL, fits_fused, merge_runs_fused
from .parameters import PAD_TABLE_NX, PAD_TABLE_NY
from .sort_cuda import pack64, sort_rows, sort_rows_live, unpack64

__all__ = [
    "philox4x32",
    "philox_normal",
    "fano_noise",
    "raw_wiggle",
    "compact_cloud",
    "generate_electrons",
    "deposit_and_merge",
    "deposit_rows",
    "deposit_rows_plain",
    "compact_runs",
    "compact_runs_plain",
    "pixel_keys_charges",
    "MESH_STEPS",
    "MESH_1D",
    "KEY_SENTINEL",
    "MERGES",
    "LOOKUPS",
    "rows_path",
]

MESH_STEPS = 10  # reference transporter.py:8
NUM_TB = 512
# merge="sorts" | "fused" and lookup="two_stage" | "one_stage": the JAX
# package's pallas_sort (True | "fused") and lookup_two_stage (True | False)
MERGES = ("sorts", "fused")
LOOKUPS = ("two_stage", "one_stage")


def rows_path(merge: str, lookup: str) -> bool:
    """Whether the step of ``merge`` and ``lookup`` takes the rows path:
    the deposit-rows kernel writes the int64 merge rows, and K3's live
    route (``sort_rows_live``) sorts each over its point prefix. The
    default configuration's path."""
    return merge == "sorts" and lookup == "two_stage"
# The mesh offsets in sigma units, -3 .. 3, as the JAX package's compiled
# detector program computes jnp.linspace(-3, 3, 10, dtype=float32) at run
# time (four values differ by one ulp from an eager jnp.linspace, and
# np.linspace and torch.linspace round others differently): a last-ulp
# difference moves pixels across mm cells.
MESH_1D = np.array(
    [-3.0, -2.3333334922790527, -1.6666667461395264, -0.9999998807907104,
     -0.3333333730697632, 0.33333349227905273, 1.0, 1.666666865348816,
     2.3333334922790527, 3.0],
    dtype=np.float32,
)

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
FANO_STREAM = 0  # Philox counter word 2 of the Fano noise
WIGGLE_STREAM = 1  # ... and of the raw-cloud TB wiggle; the kinematics
# draws take 2 and up (kinematics.pipeline.KINEMATICS_STREAM)


def _mulhilo32(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product a * b, for a < 2^32 and
    b int64 holding values < 2^32, without overflowing int64: b is split
    into 16-bit halves."""
    t_lo = a * (b & 0xFFFF)  # < 2^48
    t_hi = a * (b >> 16)  # < 2^48
    s = (t_lo >> 16) + t_hi  # == (a * b) >> 16
    lo = ((s & 0xFFFF) << 16) | (t_lo & 0xFFFF)
    return s >> 16, lo


def philox4x32(counter: list[torch.Tensor], key: list[torch.Tensor],
               rounds: int = 10) -> list[torch.Tensor]:
    """Philox4x32 (Salmon et al., SC'11) in int64 tensor arithmetic: four
    counter words and two key words, each an int64 tensor of 32-bit
    values (broadcastable), give four words of random bits."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(rounds):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return [c0, c1, c2, c3]


def philox_normal(counter: list[torch.Tensor],
                  key: list[torch.Tensor]) -> torch.Tensor:
    """Four standard normals per counter (stacked on a new last axis), f32:
    Box-Muller on the Philox words, two uniforms per pair of normals, the
    first uniform in (0, 1] so its log is finite."""
    w = philox4x32(counter, key)
    two24 = 1.0 / 16777216.0
    out = []
    for a, b in ((w[0], w[1]), (w[2], w[3])):
        u1 = ((a >> 8) + 1).to(torch.float32) * two24
        u2 = (b >> 8).to(torch.float32) * two24
        r = torch.sqrt(-2.0 * torch.log(u1))
        theta = (2.0 * math.pi) * u2
        out += [r * torch.cos(theta), r * torch.sin(theta)]
    return torch.stack(out, dim=-1)


def fano_noise(seed: int, event_start: int, n_events: int, tracks: int,
               n_steps: int, chunk_steps: int,
               device: torch.device | str = "cuda") -> torch.Tensor:
    """Standard normal Fano noise [n_steps, n_events * tracks] f32, made on
    ``device`` (the card unless the caller asks for the CPU).

    The draw of step t, track k of the event with global id g is normal
    number j = (t % chunk_steps) * tracks + k of the Philox stream with key
    (seed low word, g) and counter (j // 4, t // chunk_steps, FANO_STREAM,
    seed high word). It depends only on (seed, g, t, k) and chunk_steps:
    not on the batch grid, and a longer window only appends steps.
    """
    device = require_device(device)
    cs = min(chunk_steps, n_steps)
    n_chunks = -(-n_steps // cs)
    per_chunk = cs * tracks
    n_ctr = -(-per_chunk // 4)
    i64 = dict(dtype=torch.int64, device=device)
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    ev = (event_start + torch.arange(n_events, **i64)) & _MASK32
    chunk = torch.arange(n_chunks, **i64)
    ctr = torch.arange(n_ctr, **i64)
    shape = (n_events, n_chunks, n_ctr)
    counter = [
        ctr[None, None, :].expand(shape),
        chunk[None, :, None].expand(shape),
        torch.full(shape, FANO_STREAM, **i64),
        torch.full(shape, seed >> 32, **i64),
    ]
    key = [torch.full(shape, seed & _MASK32, **i64),
           ev[:, None, None].expand(shape)]
    z = philox_normal(counter, key).reshape(n_events, n_chunks, n_ctr * 4)
    z = z[:, :, :per_chunk].reshape(n_events, n_chunks * cs, tracks)
    z = z[:, :n_steps]  # [E, T, K]
    return z.permute(1, 0, 2).reshape(n_steps, n_events * tracks)


def raw_wiggle(seed: int, event_start: int, n_events: int, width: int,
               device: torch.device | str = "cuda") -> torch.Tensor:
    """U[0, 1) f32 TB wiggle [n_events, width] of the raw merged cloud,
    made on ``device``: column j of the event with global id g is uniform
    number j of the Philox stream with key (seed low word, g) and counter
    (j // 4, 0, WIGGLE_STREAM, seed high word), the top 24 bits of a word
    times 2^-24. It depends only on (seed, g, j), not on the batch grid or
    the merged window's width. The JAX package draws this wiggle from its
    own key (deposition.py:546-559); the port's values are its own."""
    device = require_device(device)
    i64 = dict(dtype=torch.int64, device=device)
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    n_ctr = -(-width // 4)
    shape = (n_events, n_ctr)
    ev = (event_start + torch.arange(n_events, **i64)) & _MASK32
    counter = [
        torch.arange(n_ctr, **i64)[None, :].expand(shape),
        torch.zeros(shape, **i64),
        torch.full(shape, WIGGLE_STREAM, **i64),
        torch.full(shape, seed >> 32, **i64),
    ]
    key = [torch.full(shape, seed & _MASK32, **i64),
           ev[:, None].expand(shape)]
    w = torch.stack(philox4x32(counter, key), dim=-1).reshape(n_events, -1)
    return (w[:, :width] >> 8).to(torch.float32) * (1.0 / 16777216.0)


def generate_electrons(dke: torch.Tensor, noise: torch.Tensor,
                       w_value: float, fano_factor: float) -> torch.Tensor:
    """Electrons per deposit point (reference solver.py:331-347):
    n = |dKE| * 1e6 / w, smeared by sigma = sqrt(fano * n) times the given
    standard normal ``noise`` [T, B], truncated toward zero to int32."""
    n_mean = dke * (1.0e6 / w_value)
    sigma = torch.sqrt(fano_factor * n_mean)
    return (n_mean + sigma * noise).to(torch.int32)


def _key_lookup(key_grid_flat: torch.Tensor, lo_mm: float, n_mm: int,
                x_m: torch.Tensor, y_m: torch.Tensor) -> torch.Tensor:
    """Pre-keyed pad lookup at (x, y) in meters (deposition.py:144-166):
    pad_id * NUM_TB from the 1-mm key grid, or KEY_SENTINEL where vetoed or
    off the plane. Positions are floored to whole mm (reference quirk,
    transporter.py:101-120)."""
    ix = torch.floor(x_m * 1000.0 - lo_mm).to(torch.int32)
    iy = torch.floor(y_m * 1000.0 - lo_mm).to(torch.int32)
    inb = (ix >= 0) & (ix < n_mm) & (iy >= 0) & (iy < n_mm)
    flat = (torch.clamp(ix, 0, n_mm - 1).long() * n_mm
            + torch.clamp(iy, 0, n_mm - 1).long())
    key = key_grid_flat[flat]
    return torch.where(inb, key, torch.full_like(key, KEY_SENTINEL))


def _run_last(keys: torch.Tensor) -> torch.Tensor:
    """Mask of the last element of each equal-key run along the last axis."""
    change = keys[..., 1:] != keys[..., :-1]
    ones = torch.ones(keys.shape[:-1] + (1,), dtype=torch.bool,
                      device=keys.device)
    return torch.cat([change, ones], dim=-1)


PREFIX_BLOCK = 16


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum along the rows of x [E, W], associated as
    XLA's CPU cumsum associates it: sequential within blocks of 16, the
    block totals prefixed the same way, recursively, and added to each
    block. The per-run charges are differences of this prefix, so a
    different association (torch.cumsum's) would move them by ulps of the
    event's running total; this one gives the JAX package's bits on any
    device (only f32 additions, no reordering)."""
    e, m = x.shape
    if m <= PREFIX_BLOCK:
        return _sequential_prefix(x)
    pad = (-m) % PREFIX_BLOCK
    blocks = torch.nn.functional.pad(x, (0, pad)).reshape(e, -1, PREFIX_BLOCK)
    inner = _sequential_prefix(blocks)
    outer = _prefix_sum(inner[:, :, -1].contiguous())
    excl = torch.cat([torch.zeros_like(outer[:, :1]), outer[:, :-1]], dim=1)
    return (inner + excl[:, :, None]).reshape(e, -1)[:, :m]


def _sequential_prefix(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right inclusive prefix along the last axis (short axes)."""
    out = x.clone()
    for j in range(1, x.shape[-1]):
        out[..., j] += out[..., j - 1]
    return out


def _merge_runs(packed: torch.Tensor, qv: torch.Tensor, cap: int,
                rank_bits: int, merge: str = "sorts"):
    """Merge per-row entries with equal (packed >> rank_bits) keys
    (deposition.py:176-299, the pack64 formulation).

    packed [E, W] int32, KEY_SENTINEL for dead lanes (whose qv is 0);
    qv [E, W] f32 nonnegative charges. Returns (key2 [E, cap] ascending with
    sentinel padding, sums [E, cap], valid2 [E, cap], n_uniq [E] — the
    unique count before capping).

    ``merge="sorts"``: ``_merge_rows`` of ``pack64(packed, qv)``.
    ``"fused"``: K5 (``merge_cuda.merge_runs_fused``), whose prefix
    associates as the Pallas fused kernel's, for rows within ``fits_fused``;
    wider rows keep the sorts path, as the JAX package's width rule does
    (deposition.py:221-229). The integers are the same on both paths; the
    sums may differ by ulps of the running prefix.
    """
    if merge not in MERGES:
        raise ValueError(f"merge={merge!r}: expected one of {MERGES}")
    if merge == "fused" and fits_fused(packed.shape[1]):
        key2, c2, n_uniq = merge_runs_fused(
            packed, qv, min(cap, packed.shape[1]), rank_bits)
        return _run_sums(key2, c2, n_uniq)
    return _merge_rows(pack64(packed, qv), cap, rank_bits)


def _merge_rows(rows: torch.Tensor, cap: int, rank_bits: int,
                lanes: torch.Tensor | None = None):
    """The sorts path of ``_merge_runs`` on rows already packed, int64
    ``pack64(packed, qv)`` [E, W]: a row sort (K3), then the run-end
    compaction (``compact_runs``). With int32 [E] ``lanes``, past which
    every lane of a row is the sentinel, the sort is K3's live route
    (``sort_rows_live``), which may sort ``rows`` in place. Returns as
    ``_merge_runs``."""
    cap = min(cap, rows.shape[1])
    srt = sort_rows(rows) if lanes is None else sort_rows_live(rows, lanes)
    return _run_sums(*compact_runs(srt, cap, rank_bits))


def compact_runs_plain(sorted_rows: torch.Tensor, cap: int, rank_bits: int):
    """Plain PyTorch version of the run-end compaction kernel. sorted_rows
    [E, W] int64 ``pack64(key, charge)`` rows in ascending order, cap <= W.
    Returns (key2 [E, cap] int32: the run ends' keys in row order, then
    KEY_SENTINEL; c2 [E, cap] f32: the inclusive charge prefix (associated
    as XLA's CPU cumsum) at each run end, then 0.0; n_uniq [E] int32, the
    run ends before capping)."""
    packed, qq = unpack64(sorted_rows)
    # the deposition-last writer of a run sorts last: rank rides in the
    # key's low bits
    last = _run_last(packed >> rank_bits)
    real_last = last & (packed != KEY_SENTINEL)
    n_uniq = real_last.sum(dim=1, dtype=torch.int32)

    # inclusive prefix of the sorted charges; dead lanes carry 0
    c = _prefix_sum(qq)

    # compact the run ends (c is nondecreasing and run ends are already
    # in key order, so the sort keeps the prefix order)
    k2_full, c2_full = unpack64(sort_rows(pack64(
        torch.where(real_last, packed, torch.full_like(packed, KEY_SENTINEL)),
        torch.where(real_last, c, torch.zeros_like(c)),
    )))
    return k2_full[:, :cap], c2_full[:, :cap], n_uniq


def compact_runs(sorted_rows: torch.Tensor, cap: int, rank_bits: int):
    """The run ends of sorted merge rows (arguments and result as
    ``compact_runs_plain``): the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if sorted_rows.is_cuda:
        return compact_runs_cuda(sorted_rows, cap, rank_bits)
    return compact_runs_plain(sorted_rows, cap, rank_bits)


def _run_sums(key2: torch.Tensor, c2: torch.Tensor, n_uniq: torch.Tensor):
    """(key2, sums, valid2, n_uniq) from the run ends' keys and inclusive
    prefix values c2 [E, cap]."""
    valid2 = key2 != KEY_SENTINEL
    prev = torch.cat([torch.zeros_like(c2[:, :1]), c2[:, :-1]], dim=1)
    # a prefix that is not strictly monotone in f32 may difference below 0
    sums = torch.where(valid2, torch.clamp(c2 - prev, min=0.0),
                       torch.zeros_like(c2))
    return key2, sums, valid2, n_uniq


def _pdf_area() -> torch.Tensor:
    """[10, 10] bivariate normal pdf times pixel area in sigma units,
    computed on the CPU in f32 so every device sees the same bits."""
    mesh = torch.from_numpy(MESH_1D)
    step = 6.0 / (MESH_STEPS - 1)
    off2 = mesh[:, None] * mesh[:, None] + mesh[None, :] * mesh[None, :]
    return (step * step / (2.0 * math.pi)) * torch.exp(-0.5 * off2)


# the pixel weights of the plain version and of the deposit-rows kernel
PDF_AREA = _pdf_area()


def pixel_keys_charges(lookup, px, py, ptbf, pne, tbr, taken, table,
                       grid_lo_mm: float, grid_n_mm: int, diffusion: float,
                       efield: float, drift_velocity: float, rank_bits: int):
    """Merge keys and charges of the 10x10 diffusion mesh of P deposit
    points in PyTorch passes around ``lookup`` (``packed_key_lookup``'s
    signature: K2, K6 or their plain version), as the JAX package's
    deposition.py:437-503 builds them. px, py (m), ptbf (float TB), pne
    (electrons) [P] f32, tbr [P] int32, taken [P] bool. Pixels off the grid
    or of an empty slot are aliased onto the pad table's sentinel padding.
    Returns keys [P, 10, 10] int32 (KEY_SENTINEL where vetoed, off the
    plane or empty) and charges [P, 10, 10] f32 (0 where the key is the
    sentinel)."""
    dev = px.device
    f32, i32 = torch.float32, torch.int32
    # sigma_t = sqrt(2 D dv t / E), t in (float) TBs (transporter.py:301)
    sigma = torch.sqrt(2.0 * diffusion * drift_velocity * ptbf / efield)
    has_diff = sigma > 0.0
    sigma_safe = torch.where(has_diff, sigma, torch.ones_like(sigma))
    mesh = torch.from_numpy(MESH_1D).to(dev)
    x10 = px[:, None] + sigma_safe[:, None] * mesh[None, :]
    y10 = py[:, None] + sigma_safe[:, None] * mesh[None, :]
    # sigma == 0: all electrons on the point itself, through pixel (0, 0)
    x10 = torch.where(has_diff[:, None], x10, px[:, None])
    y10 = torch.where(has_diff[:, None], y10, py[:, None])

    q_pix = pne[:, None, None] * PDF_AREA.to(dev)
    q_point = torch.zeros((MESH_STEPS, MESH_STEPS), dtype=f32, device=dev)
    q_point[0, 0] = 1.0
    q_pix = torch.where(has_diff[:, None, None], q_pix,
                        pne[:, None, None] * q_point)

    # pixel cells; invalid pixels (off the plane, no point) are aliased
    # onto the table's sentinel padding, as deposition.py:484-492
    ix = torch.floor(x10 * 1000.0 - grid_lo_mm).to(i32)
    iy = torch.floor(y10 * 1000.0 - grid_lo_mm).to(i32)
    bad_x = (ix < 0) | (ix >= grid_n_mm) | ~taken[:, None]
    bad_y = (iy < 0) | (iy >= grid_n_mm)
    ix = torch.where(bad_x, torch.full_like(ix, PAD_TABLE_NX - 1), ix)
    iy = torch.where(bad_y, torch.full_like(iy, PAD_TABLE_NY - 1), iy)
    keys = lookup(ix.contiguous(), iy.contiguous(), tbr.contiguous(), table,
                  rank_bits, KEY_SENTINEL)
    return keys, torch.where(keys != KEY_SENTINEL, q_pix,
                             torch.zeros_like(q_pix))


def deposit_rows_plain(px, py, ptbf, pne, tbr, taken, table,
                       grid_lo_mm: float, grid_n_mm: int, diffusion: float,
                       efield: float, drift_velocity: float, rank_bits: int,
                       lookup=packed_key_lookup_plain) -> torch.Tensor:
    """Plain PyTorch version of the deposit-rows kernel.

    Points in per-event windows [E, pb]: px, py (m), ptbf (float TB), pne
    (electrons) f32, tbr int32 = (tb << rank_bits) | rank, taken bool (the
    slot holds a point); table [560, 640] int32 pad ids; the grid's edge and
    size in mm; the physics scalars as Python floats. Returns [E, pb * 100]
    int64 ``pack64(key, charge)``: the merge key of every mesh pixel (K2's,
    KEY_SENTINEL where vetoed, off the plane or empty) in the high word and
    its charge in electrons (0 where the key is the sentinel) in the low.
    ``lookup`` makes the keys (``packed_key_lookup``'s signature); with K2
    (``deposit_cuda.packed_key_lookup_cuda``) this is the default step as
    it was before the rows kernel.
    """
    e, pb = px.shape
    keys, q = pixel_keys_charges(
        lookup, *(a.reshape(-1) for a in (px, py, ptbf, pne, tbr, taken)),
        table, grid_lo_mm, grid_n_mm, diffusion, efield, drift_velocity,
        rank_bits)
    return pack64(keys, q).reshape(e, pb * MESH_STEPS * MESH_STEPS)


def deposit_rows(px, py, ptbf, pne, tbr, taken, table, grid_lo_mm: float,
                 grid_n_mm: int, diffusion: float, efield: float,
                 drift_velocity: float, rank_bits: int) -> torch.Tensor:
    """The default step's int64 merge rows [E, pb * 100] (arguments as
    ``deposit_rows_plain``): the deposit-rows kernel for CUDA tensors, the
    plain version for CPU tensors."""
    args = (px, py, ptbf, pne, tbr, taken, table, grid_lo_mm, grid_n_mm,
            diffusion, efield, drift_velocity, rank_bits)
    if px.is_cuda:
        return deposit_rows_cuda(*args, MESH_1D, PDF_AREA.numpy())
    return deposit_rows_plain(*args)


def deposit_and_merge(
    positions: torch.Tensor,
    electrons: torch.Tensor,
    valid: torch.Tensor,
    track_labels: torch.Tensor,
    pad_table: torch.Tensor,
    grid_lo_mm: float,
    grid_n_mm: int,
    diffusion: float,
    efield: float,
    drift_velocity: float,
    micromegas_edge: float,
    length: float,
    mpgd_gain: float,
    n_events: int,
    tracks_per_event: int,
    point_budget: int = 1024,
    uniq_budget: int = 12288,
    wiggle: torch.Tensor | None = None,
    merge: str = "sorts",
    lookup: str = "two_stage",
) -> dict[str, torch.Tensor]:
    """Transport deposits to the pad plane and merge to unique (pad, tb).

    positions [T, B, 3] f32 (m), electrons [T, B] int32, valid [T, B] bool,
    track_labels [B] int32, with B = n_events * tracks_per_event event-major
    (track b belongs to event b // K). pad_table [560, 640] int32 pad ids
    (``Config.device_arrays()["pad_table"]``). ``wiggle`` [E, U] f32 in
    [0, 1): the raw-cloud TB wiggle; with None the wiggled ``tbs`` output is
    left out (the Spyral path ships integer tbs and wiggles on the host).
    ``merge`` ("sorts" or "fused") and ``lookup`` ("two_stage" or
    "one_stage") choose the kernels, as the JAX function's ``pallas_sort``
    (True or "fused") and ``lookup_two_stage`` (True or False) do.

    Returns merged entries in per-event windows of U = min(uniq_budget,
    point_budget * 100) rows, flattened (event i owns rows [i*U, (i+1)*U),
    valid rows first in ascending (pad, tb) order): pads, tbs_i, charges
    (gain applied), labels, events, cloud_valid [E*U]; counts and n_points
    [E]; pool_overflow, uniq_overflow, uniq_max scalars (int32); and tbs
    [E*U] f32 where a wiggle is given. As deposition.py:309-582.
    """
    if lookup not in LOOKUPS:
        raise ValueError(f"lookup={lookup!r}: expected one of {LOOKUPS}")
    if merge not in MERGES:
        raise ValueError(f"merge={merge!r}: expected one of {MERGES}")
    t_steps, b = electrons.shape
    k_tracks = tracks_per_event
    e = n_events
    pb = point_budget
    dev = positions.device
    f32, i32 = torch.float32, torch.int32
    p = e * pb

    rank_bits = max(1, int(k_tracks - 1).bit_length())
    if (10240 * NUM_TB) << rank_bits >= 2**31:
        raise ValueError(f"too many tracks per event ({k_tracks}) to pack")
    u_cap = min(uniq_budget, pb * MESH_STEPS * MESH_STEPS)

    with stage("step.deposit"):
        # electrons >= 1 is part of validity (reference solver.py:387-389)
        valid = valid & (electrons >= 1)

        # z -> float TB (reference solver.py:394-398); tb_f in (-1, 0)
        # truncates to 0 and survives, so the keep condition is tb_f > -1
        tb_f = ((length - positions[:, :, 2]) / drift_velocity
                + micromegas_edge)
        tb_i = tb_f.to(i32)
        valid = valid & (tb_f > -1.0) & (tb_i < NUM_TB)

        # --- per-event point-window compaction -------------------------- #
        kt = k_tracks * t_steps

        # [T, B] -> [E * K * T] in (event, nucleus, time) order
        def ev_flat(a):
            return a.transpose(0, 1).reshape(e * kt)

        valid_r = ev_flat(valid).reshape(e, kt)
        n_points = valid_r.sum(dim=1, dtype=i32)
        pool_overflow = torch.clamp(n_points - pb, min=0).sum(dtype=i32)

        slot = torch.cumsum(valid_r.to(i32), dim=1, dtype=i32) - 1
        row = torch.arange(e, dtype=i32, device=dev)[:, None]
        # invalid or overflowing points go to the spare slot p, dropped below
        dest = torch.where(valid_r & (slot < pb), row * pb + slot,
                           torch.full_like(slot, p))
        src = torch.full((p + 1,), -1, dtype=i32, device=dev)
        src.scatter_(0, dest.reshape(-1).long(),
                     torch.arange(e * kt, dtype=i32, device=dev))
        src = src[:p]
        taken = src >= 0
        gsrc = torch.clamp(src, min=0).long()

        px = ev_flat(positions[:, :, 0])[gsrc]
        py = ev_flat(positions[:, :, 1])[gsrc]
        ptbf = ev_flat(tb_f)[gsrc]
        ptbi = ev_flat(tb_i)[gsrc]
        # the gain is applied after the merge
        pne = ev_flat(electrons)[gsrc].to(f32)
        prank = ((gsrc // t_steps) % k_tracks).to(i32)

        # --- diffusion mesh, pad lookup, pixel charges ------------------ #
        tbr = (ptbi << rank_bits) | prank
        phys = (grid_lo_mm, grid_n_mm, diffusion, efield, drift_velocity)
        # one kernel writes the int64 rows the merge sort takes
        rows_kernel = rows_path(merge, lookup)
        if rows_kernel:
            rows = deposit_rows(*(a.reshape(e, pb) for a in (
                px, py, ptbf, pne, tbr, taken)), pad_table, *phys, rank_bits)
        else:
            lookup_fn = (packed_key_lookup if lookup == "two_stage"
                         else packed_key_lookup_rows)
            keys, q = pixel_keys_charges(lookup_fn, px, py, ptbf, pne, tbr,
                                         taken, pad_table, *phys, rank_bits)
    with stage("step.merge"):
        if rows_kernel:
            # the rows' point prefixes: deposit_rows fills slots [0,
            # min(n_points, pb)) of each event and leaves the rest empty
            lanes = torch.clamp(n_points, max=pb) * (MESH_STEPS * MESH_STEPS)
            key2, sums, valid2, n_uniq = _merge_rows(rows, u_cap, rank_bits,
                                                     lanes)
        else:
            w = pb * MESH_STEPS * MESH_STEPS
            key2, sums, valid2, n_uniq = _merge_runs(
                keys.reshape(e, w), q.reshape(e, w), u_cap, rank_bits, merge)
        uniq_max = n_uniq.max()
        uniq_overflow = torch.clamp(n_uniq - u_cap, min=0).sum(dtype=i32)
        counts = torch.clamp(n_uniq, max=u_cap)

        ufinal = key2 >> rank_bits
        rank2 = torch.where(valid2, key2 & ((1 << rank_bits) - 1),
                            torch.zeros_like(key2))
        # the run's deposition-last track has the largest rank (reference
        # transporter.py:169,249 dict-overwrite semantics)
        lab_idx = torch.clamp(row * k_tracks + rank2, 0,
                              b - 1).reshape(-1).long()
        v = valid2.reshape(-1)
        labels = torch.where(v, track_labels[lab_idx],
                             torch.full_like(lab_idx, -1, dtype=i32))
        events_out = torch.where(valid2, row,
                                 torch.full_like(row, e)).reshape(-1)
        pads_out = torch.where(valid2, ufinal // NUM_TB,
                               torch.full_like(ufinal, -1)).reshape(-1)
        tbs_int = torch.where(valid2, ufinal % NUM_TB,
                              torch.zeros_like(ufinal)).reshape(-1)
        charges = torch.where(valid2, sums * np.float32(mpgd_gain),
                              torch.zeros_like(sums)).reshape(-1)

        out = {
            "pads": pads_out,
            "tbs_i": tbs_int,
            "charges": charges,
            "labels": labels,
            "events": events_out,
            "cloud_valid": v,
            "counts": counts,
            "n_points": n_points,
            "pool_overflow": pool_overflow,
            "uniq_overflow": uniq_overflow,
            "uniq_max": uniq_max,
        }
        if wiggle is not None:
            # clamp below tb + 1 so floor(tbs) == tb survives f32 rounding
            # (deposition.py:561-567)
            tb_w = tbs_int.to(f32)
            out["tbs"] = torch.minimum(
                tb_w + wiggle.reshape(-1), torch.nextafter(tb_w + 1.0, tb_w)
            )
    return out


def compact_cloud(cloud: dict, n_events: int, cap: int) -> dict:
    """The merged entries in one pooled layout (deposition.py:586-616):
    valid rows first, ordered by (event, key), at most ``cap`` rows an
    event in a shared pool of min(n_events * cap, rows) slots; for the
    reference-protocol writer path. ``cloud`` holds pads, tbs, charges,
    labels, events, cloud_valid and counts as ``deposit_and_merge`` gives
    them (with a wiggle). Returns the same keys in the pooled layout, with
    counts [E] taken from it, and ``overflow``, the rows past the pool."""
    e = n_events
    s_cap = min(e * cap, cloud["pads"].shape[0])
    evkey = torch.where(cloud["cloud_valid"], cloud["events"],
                        torch.full_like(cloud["events"], 2**30))
    ev, order = torch.sort(evkey, stable=True)
    ev = ev[:s_cap]
    order = order[:s_cap]
    total = cloud["counts"].sum(dtype=torch.int32)
    overflow = torch.clamp(total - s_cap, min=0)
    ev_range = torch.arange(e + 1, dtype=ev.dtype, device=ev.device)
    bounds = torch.searchsorted(ev, ev_range, right=False)
    counts = (bounds[1:] - bounds[:-1]).to(torch.int32)
    valid = (torch.arange(s_cap, dtype=torch.int32, device=ev.device)
             < torch.clamp(total, max=s_cap))
    out = {k: cloud[k][order] for k in ("pads", "tbs", "charges", "labels")}
    out.update(events=torch.where(valid, ev, torch.full_like(ev, e)),
               cloud_valid=valid, counts=counts, overflow=overflow)
    return out
