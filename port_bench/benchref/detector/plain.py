# Frozen copy of the plain versions of attpc_engine_tpu_torch's detector step: the
# Fano draws, the deposit rows and pad lookup (deposition.py, deposit_cuda.py), the merge
# (deposition.py, sort_cuda.py with torch.sort for K3), the Spyral conversion and the host
# assembly (simulator.py); the benchmark's reference imports nothing of the port.
"""The detector stage's plain reference, event by event.

``PlainDetector.simulate`` takes events by their global ids, in any
grouping, and gives each event's Spyral rows and labels as the port's
``run_reader`` gives them to its writer: transport (the plain RK4 window),
Fano-smeared electron counts from the Philox stream keyed (seed, event
id), the 10x10 diffusion mesh and pad lookup, the (pad, tb) merge with its
last-writer label, the ADC threshold and z order, and the host assembly
with its TB wiggle. Every draw depends only on (seed, event id, step), so
an event's rows do not depend on its neighbours, on the batch or on the
budgets the driver tuned, as long as nothing overflowed. Budgets here are
as wide as the events need.

With ``low`` (the control), the transport state and the merged charges are
stored in that lower precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import NUM_TB
from ..nuclear import GasTarget
from .parameters import (
    PAD_TABLE_NX,
    PAD_TABLE_NY,
    Config,
    DetectorParams,
    ElectronicsParams,
    PadParams,
)
from .response import get_response
from .transport import TrackSpecies, integrate_tracks
from ..philox import philox_normal

MESH_STEPS = 10
KEY_SENTINEL = 2**31 - 1
PAD_ID_SENTINEL = 10240
FANO_STREAM = 0
_MASK32 = 0xFFFFFFFF
_INT64_MAX = 0x7FFFFFFFFFFFFFFF
_INT64_MIN = -0x8000000000000000
MESH_1D = np.array(
    [-3.0, -2.3333334922790527, -1.6666667461395264, -0.9999998807907104,
     -0.3333333730697632, 0.33333349227905273, 1.0, 1.666666865348816,
     2.3333334922790527, 3.0],
    dtype=np.float32,
)
PREFIX_BLOCK = 16


def detector_config(cfg: dict, nuclear_map) -> Config:
    """The frozen ``Config`` of a benchmark configuration's ``detector``."""
    d, e = cfg["detector"], cfg["electronics"]
    gas = GasTarget([tuple(c) for c in d["gas_components"]],
                    float(d["gas_pressure_torr"]), nuclear_map)
    return Config(
        DetectorParams(length=d["length"], efield=d["efield"],
                       bfield=d["bfield"], mpgd_gain=d["mpgd_gain"],
                       gas_target=gas, diffusion=d["diffusion"],
                       fano_factor=d["fano_factor"], w_value=d["w_value"]),
        ElectronicsParams(**e),
        PadParams(),
    )


def fano_noise(seed: int, event_ids: torch.Tensor, tracks: int, n_steps: int,
               chunk_steps: int) -> torch.Tensor:
    """Standard normal Fano noise [n_steps, E * tracks] f32 for events of
    global ids ``event_ids`` [E]: step t, track k of event g is normal
    number (t % chunk_steps) * tracks + k of the Philox stream with key
    (seed low word, g) and counter (j // 4, t // chunk_steps, FANO_STREAM,
    seed high word)."""
    dev = event_ids.device
    cs = min(chunk_steps, n_steps)
    n_chunks = -(-n_steps // cs)
    per_chunk = cs * tracks
    n_ctr = -(-per_chunk // 4)
    i64 = dict(dtype=torch.int64, device=dev)
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    ev = event_ids.to(torch.int64) & _MASK32
    n_events = ev.shape[0]
    shape = (n_events, n_chunks, n_ctr)
    counter = [
        torch.arange(n_ctr, **i64)[None, None, :].expand(shape),
        torch.arange(n_chunks, **i64)[None, :, None].expand(shape),
        torch.full(shape, FANO_STREAM, **i64),
        torch.full(shape, seed >> 32, **i64),
    ]
    key = [torch.full(shape, seed & _MASK32, **i64),
           ev[:, None, None].expand(shape)]
    z = philox_normal(counter, key).reshape(n_events, n_chunks, n_ctr * 4)
    z = z[:, :, :per_chunk].reshape(n_events, n_chunks * cs, tracks)
    z = z[:, :n_steps]
    return z.permute(1, 0, 2).reshape(n_steps, n_events * tracks)


def wiggle_for_events(counts, event_numbers, seed: int) -> np.ndarray:
    """U[0, 1) f64 TB wiggle of per-event row runs, from numpy Philox
    streams keyed on (seed, event number)."""
    out = np.empty(int(np.sum(counts)), np.float64)
    pos = 0
    for n, ev in zip(counts, event_numbers):
        n = int(n)
        if n:
            key = np.array([int(seed) & 0xFFFFFFFFFFFFFFFF, int(ev)],
                           dtype=np.uint64)
            gen = np.random.Generator(np.random.Philox(key=key))
            out[pos:pos + n] = gen.random(n)
            pos += n
    return out


def pack64(key: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    return (key.to(torch.int64) << 32) | (
        val.contiguous().view(torch.int32).to(torch.int64) & _MASK32)


def unpack64(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    lo = ((g & _MASK32) ^ 0x80000000) - 0x80000000
    return (g >> 32).to(torch.int32), lo.to(torch.int32).view(torch.float32)


def sort_rows(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=1).values


def _pdf_area() -> torch.Tensor:
    mesh = torch.from_numpy(MESH_1D)
    step = 6.0 / (MESH_STEPS - 1)
    off2 = mesh[:, None] * mesh[:, None] + mesh[None, :] * mesh[None, :]
    return (step * step / (2.0 * math.pi)) * torch.exp(-0.5 * off2)


PDF_AREA = _pdf_area()


def packed_key_lookup(ix, iy, tbr, table, rank_bits: int) -> torch.Tensor:
    ixc = torch.clamp(ix, 0, PAD_TABLE_NX - 1).long()
    iyc = torch.clamp(iy, 0, PAD_TABLE_NY - 1).long()
    flat = ixc[:, :, None] * PAD_TABLE_NY + iyc[:, None, :]
    pad = table.reshape(-1)[flat]
    key = pad * (512 << rank_bits) + tbr.to(torch.int32)[:, None, None]
    return torch.where(pad < PAD_ID_SENTINEL, key,
                       torch.full_like(key, KEY_SENTINEL))


def deposit_rows(px, py, ptbf, pne, tbr, taken, table, grid_lo_mm: float,
                 grid_n_mm: int, diffusion: float, efield: float,
                 drift_velocity: float, rank_bits: int) -> torch.Tensor:
    """[E, pb * 100] int64 ``pack64(key, charge)`` of every mesh pixel of
    the points in per-event windows [E, pb]."""
    e, pb = px.shape
    dev = px.device
    px, py, ptbf, pne, tbr, taken = (a.reshape(-1) for a in (
        px, py, ptbf, pne, tbr, taken))
    sigma = torch.sqrt(2.0 * diffusion * drift_velocity * ptbf / efield)
    has_diff = sigma > 0.0
    sigma_safe = torch.where(has_diff, sigma, torch.ones_like(sigma))
    mesh = torch.from_numpy(MESH_1D).to(dev)
    x10 = px[:, None] + sigma_safe[:, None] * mesh[None, :]
    y10 = py[:, None] + sigma_safe[:, None] * mesh[None, :]
    x10 = torch.where(has_diff[:, None], x10, px[:, None])
    y10 = torch.where(has_diff[:, None], y10, py[:, None])
    q_pix = pne[:, None, None] * PDF_AREA.to(dev)
    q_point = torch.zeros((MESH_STEPS, MESH_STEPS), dtype=torch.float32,
                          device=dev)
    q_point[0, 0] = 1.0
    q_pix = torch.where(has_diff[:, None, None], q_pix,
                        pne[:, None, None] * q_point)
    ix = torch.floor(x10 * 1000.0 - grid_lo_mm).to(torch.int32)
    iy = torch.floor(y10 * 1000.0 - grid_lo_mm).to(torch.int32)
    bad_x = (ix < 0) | (ix >= grid_n_mm) | ~taken[:, None]
    bad_y = (iy < 0) | (iy >= grid_n_mm)
    ix = torch.where(bad_x, torch.full_like(ix, PAD_TABLE_NX - 1), ix)
    iy = torch.where(bad_y, torch.full_like(iy, PAD_TABLE_NY - 1), iy)
    keys = packed_key_lookup(ix, iy, tbr, table, rank_bits)
    q = torch.where(keys != KEY_SENTINEL, q_pix, torch.zeros_like(q_pix))
    return pack64(keys, q).reshape(e, pb * MESH_STEPS * MESH_STEPS)


def _sequential_prefix(x: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    for j in range(1, x.shape[-1]):
        out[..., j] += out[..., j - 1]
    return out


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix along rows, associated as XLA's CPU cumsum:
    sequential within blocks of 16, the block totals prefixed recursively."""
    e, m = x.shape
    if m <= PREFIX_BLOCK:
        return _sequential_prefix(x)
    pad = (-m) % PREFIX_BLOCK
    blocks = torch.nn.functional.pad(x, (0, pad)).reshape(e, -1, PREFIX_BLOCK)
    inner = _sequential_prefix(blocks)
    outer = _prefix_sum(inner[:, :, -1].contiguous())
    excl = torch.cat([torch.zeros_like(outer[:, :1]), outer[:, :-1]], dim=1)
    return (inner + excl[:, :, None]).reshape(e, -1)[:, :m]


def merge_rows(rows: torch.Tensor, rank_bits: int):
    """Equal (key >> rank_bits) runs of sorted ``pack64`` rows merged:
    (key2, sums, valid2, n_uniq), the run ends in key order."""
    packed, qq = unpack64(sort_rows(rows))
    change = (packed >> rank_bits)[:, 1:] != (packed >> rank_bits)[:, :-1]
    last = torch.cat([change, torch.ones_like(change[:, :1])], dim=1)
    real_last = last & (packed != KEY_SENTINEL)
    n_uniq = real_last.sum(dim=1, dtype=torch.int32)
    c = _prefix_sum(qq)
    key2, c2 = unpack64(sort_rows(pack64(
        torch.where(real_last, packed, torch.full_like(packed, KEY_SENTINEL)),
        torch.where(real_last, c, torch.zeros_like(c)))))
    valid2 = key2 != KEY_SENTINEL
    prev = torch.cat([torch.zeros_like(c2[:, :1]), c2[:, :-1]], dim=1)
    sums = torch.where(valid2, torch.clamp(c2 - prev, min=0.0),
                       torch.zeros_like(c2))
    return key2, sums, valid2, n_uniq


class PlainDetector:
    """The reference detector for one configuration (``cfg``, a
    benchmark configuration file's contents) and the nuclei of its
    kinematics rows."""

    def __init__(self, cfg: dict, proton_numbers, mass_numbers, nuclear_map,
                 device: torch.device | str, low: torch.dtype | None = None):
        self.device = torch.device(device)
        self.low = low
        self.config = config = detector_config(cfg, nuclear_map)
        eng = cfg["engine"]
        self.n_time_steps = int(eng["n_time_steps"])
        self.chunk_steps = int(eng["chunk_steps"])
        self.dt = float(eng["dt"])
        indices = list(range(2, len(proton_numbers), 2))
        indices.append(len(proton_numbers) - 1)
        self.sim_indices = [i for i in indices if proton_numbers[i] != 0]
        self.k_tracks = len(self.sim_indices)
        gas = config.det_params.gas_target
        masses, charges, tables = [], [], []
        for i in self.sim_indices:
            nucleus = nuclear_map.get_data(int(proton_numbers[i]),
                                           int(mass_numbers[i]))
            log_ke, dedx = gas.dedx_interp_arrays(nucleus)
            masses.append(nucleus.mass)
            charges.append(float(nucleus.Z))
            tables.append(dedx)
        self.track_masses = np.array(masses)
        dev = self.device
        f32 = torch.float32
        self.species = TrackSpecies(
            mass=torch.as_tensor(np.array(masses), dtype=f32, device=dev),
            charge=torch.as_tensor(np.array(charges), dtype=f32, device=dev),
            log_ke_lo=float(log_ke[0]), dlog_ke=float(log_ke[1] - log_ke[0]),
            dedx=torch.as_tensor(np.stack(tables), dtype=f32,
                                 device=dev).contiguous(),
        )
        arrays = config.device_arrays()
        self.pad_table = torch.as_tensor(arrays["pad_table"], device=dev)
        self.grid_lo_mm = float(arrays["grid_lo_mm"])
        self.grid_n_mm = int(arrays["grid_n_mm"])
        self.labels = torch.as_tensor(np.array(self.sim_indices),
                                      dtype=torch.int32, device=dev)
        resp = np.asarray(get_response(config), dtype=np.float64)
        self.resp_max = float(resp.max())
        self.resp_asc = np.sort(resp)
        self.resp_prefix = np.concatenate([[0.0], np.cumsum(self.resp_asc)])

    def _points(self, vertices, momenta, event_ids, seed: int):
        """Transport and electrons of events [E]: (positions [T, B, 3],
        electrons [T, B], valid [T, B]) with the steps that ran."""
        dp = self.config.det_params
        e, k = len(vertices), self.k_tracks
        p3 = momenta[:, self.sim_indices, :3]
        gvs = (p3 / self.track_masses[None, :, None]).astype(np.float32)
        vg = np.concatenate([np.asarray(vertices, dtype=np.float32),
                             gvs.reshape(e, -1)], axis=1)
        vg = torch.from_numpy(vg).to(self.device)
        pos0 = vg[:, :3].repeat_interleave(k, dim=0)
        gv0 = vg[:, 3:].reshape(e * k, 3)
        s_idx = torch.arange(k, dtype=torch.int32,
                             device=self.device).repeat(e)
        chunk = min(self.chunk_steps, self.n_time_steps)
        positions, dke, alive = integrate_tracks(
            pos0, gv0, s_idx, self.species,
            density=float(dp.gas_target.density), bfield=float(dp.bfield),
            efield=float(dp.efield), dt=self.dt, n_steps=self.n_time_steps,
            chunk_steps=chunk, low=self.low)
        # steps after the last window that ran are empty
        ran = alive.reshape(-1, chunk, alive.shape[1]).any(dim=(1, 2))
        n_win = int(ran.nonzero().max()) + 1 if bool(ran.any()) else 1
        t = n_win * chunk
        positions, dke, alive = positions[:t], dke[:t], alive[:t]
        ids = torch.as_tensor(np.asarray(event_ids), dtype=torch.int64,
                              device=self.device)
        noise = fano_noise(seed, ids, k, t, chunk)
        n_mean = dke * (1.0e6 / dp.w_value)
        sigma = torch.sqrt(dp.fano_factor * n_mean)
        electrons = (n_mean + sigma * noise).to(torch.int32)
        return positions, electrons, alive

    def _merged(self, positions, electrons, valid, e: int):
        """The (pad, tb) merge of events [E]: (pads, tbs, charges, labels,
        valid) [E, U]."""
        cfg = self.config
        dp = cfg.det_params
        k = self.k_tracks
        t_steps = electrons.shape[0]
        dev = positions.device
        rank_bits = max(1, int(k - 1).bit_length())
        valid = valid & (electrons >= 1)
        tb_f = ((dp.length - positions[:, :, 2]) / cfg.drift_velocity
                + float(cfg.elec_params.micromegas_edge))
        tb_i = tb_f.to(torch.int32)
        valid = valid & (tb_f > -1.0) & (tb_i < NUM_TB)
        kt = k * t_steps

        def ev_flat(a):
            return a.transpose(0, 1).reshape(e * kt)

        valid_r = ev_flat(valid).reshape(e, kt)
        n_points = valid_r.sum(dim=1)
        pb = max(int(n_points.max()), 1)
        p = e * pb
        slot = torch.cumsum(valid_r.to(torch.int64), dim=1) - 1
        row = torch.arange(e, dtype=torch.int64, device=dev)[:, None]
        dest = torch.where(valid_r, row * pb + slot, torch.full_like(slot, p))
        src = torch.full((p + 1,), -1, dtype=torch.int64, device=dev)
        src.scatter_(0, dest.reshape(-1),
                     torch.arange(e * kt, dtype=torch.int64, device=dev))
        src = src[:p]
        taken = src >= 0
        gsrc = torch.clamp(src, min=0)
        px = ev_flat(positions[:, :, 0])[gsrc]
        py = ev_flat(positions[:, :, 1])[gsrc]
        ptbf = ev_flat(tb_f)[gsrc]
        ptbi = ev_flat(tb_i)[gsrc]
        pne = ev_flat(electrons)[gsrc].to(torch.float32)
        prank = ((gsrc // t_steps) % k).to(torch.int32)
        tbr = (ptbi << rank_bits) | prank
        rows = deposit_rows(*(a.reshape(e, pb) for a in (
            px, py, ptbf, pne, tbr, taken)), self.pad_table, self.grid_lo_mm,
            self.grid_n_mm, dp.diffusion, dp.efield, cfg.drift_velocity,
            rank_bits)
        key2, sums, valid2, _ = merge_rows(rows, rank_bits)
        if self.low is not None:
            sums = sums.to(self.low).to(sums.dtype)
        ufinal = key2 >> rank_bits
        rank2 = torch.where(valid2, key2 & ((1 << rank_bits) - 1),
                            torch.zeros_like(key2))
        lab_idx = torch.clamp(row * k + rank2, 0, e * k - 1).long()
        labels = torch.where(valid2, self.labels.repeat(e)[lab_idx],
                             torch.full_like(key2, -1))
        pads = torch.where(valid2, ufinal // NUM_TB, torch.full_like(ufinal, -1))
        tbs = torch.where(valid2, ufinal % NUM_TB, torch.zeros_like(ufinal))
        charges = torch.where(valid2, sums * np.float32(dp.mpgd_gain),
                              torch.zeros_like(sums))
        return pads, tbs, charges, labels, valid2

    def _kept(self, pads, tbs, q, labels, valid):
        """The kept rows of each event in the packed order (descending
        integer tb, then pad, label, charge bits): per event (q f32, tb,
        pad, label) numpy arrays."""
        i64 = torch.int64
        amp = torch.clamp(self.resp_max * q, max=4095.0)
        keep = valid & (amp > float(self.config.elec_params.adc_threshold))
        qbits = q.view(torch.int32).to(i64) & _MASK32
        key64 = (torch.where(keep, _INT64_MIN, 0)
                 | ((511 - tbs.to(i64)) << 54) | (pads.to(i64) << 40)
                 | (labels.to(i64) << 32) | qbits)
        key64 = torch.where(keep, key64, _INT64_MAX)
        k_s = sort_rows(key64).cpu().numpy()
        counts = keep.sum(dim=1).cpu().numpy()
        out = []
        for i, n in enumerate(counts):
            g = k_s[i, :n]
            tb = 511 - ((g >> 54) & 0x1FF)
            pad = (g >> 40) & 0x3FFF
            lab = (g >> 32) & 0xFF
            qv = (g & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
            out.append((qv, tb, pad, lab))
        return out

    def assemble(self, q, tb, pad, lab, event_id: int, seed: int):
        """One event's Spyral rows [n, 8] f64 and labels [n] int64 from its
        kept rows in the packed order: the TB wiggle, the stable z order
        and the eight columns."""
        cfg = self.config
        tbs = tb.astype(np.float64) + wiggle_for_events([len(q)], [event_id],
                                                        seed)
        order = np.argsort(-tbs, kind="stable")
        q = q[order].astype(np.float64)
        tbs, pad, lab = tbs[order], pad[order].astype(np.int64), lab[order]
        amp = np.minimum(self.resp_max * q, 4095.0)
        thr = 4095.0 / np.maximum(q, 1e-300)
        idx = np.searchsorted(self.resp_asc, thr, side="right")
        integral = q * self.resp_prefix[idx] + 4095.0 * (NUM_TB - idx)
        win = float(cfg.elec_params.windows_edge)
        mm = float(cfg.elec_params.micromegas_edge)
        out = np.empty((len(pad), 8), dtype=np.float64)
        out[:, 0] = cfg.pad_centers[pad, 0]
        out[:, 1] = cfg.pad_centers[pad, 1]
        out[:, 2] = (win - tbs) / (win - mm) * cfg.det_params.length * 1000.0
        out[:, 3] = amp
        out[:, 4] = integral
        out[:, 5] = pad
        out[:, 6] = tbs
        out[:, 7] = cfg.pad_sizes[pad]
        return out, lab.astype(np.int64)

    def simulate(self, vertices, momenta, event_ids, seed: int,
                 block: int = 64) -> dict:
        """{event id: (spyral [n, 8] f64, labels [n] int64)} of the events
        (vertices [E, 3], momenta [E, N, 4] f64, global ids [E]): one
        transport of them all, then the merge in blocks of ``block``
        events."""
        ids = [int(i) for i in event_ids]
        pos, electrons, valid = self._points(vertices, momenta, ids, seed)
        k = self.k_tracks
        out = {}
        for lo in range(0, len(ids), block):
            hi = min(lo + block, len(ids))
            tracks = slice(lo * k, hi * k)
            merged = self._merged(pos[:, tracks], electrons[:, tracks],
                                  valid[:, tracks], hi - lo)
            for ev, rows in zip(ids[lo:hi], self._kept(*merged)):
                out[ev] = self.assemble(*rows, event_id=ev, seed=seed)
        return out
