"""Detector stage: batched event simulation (port of
attpc_engine_tpu/detector/simulator.py).

A ``DetectorSimulator`` runs the detector step for a batch of events on one
device: transport (K1), electron generation, deposition and merge (K2 and
K3 by default; K6 and K5 with ``EngineParams(lookup="one_stage",
merge="fused")``), and the Spyral conversion (K3), giving packed int32 rows
per batch, which the Spyral assembly (``assemble_device``: TB wiggle, z
order and the eight f64 columns in one kernel on the card) turns into the
rows of the Spyral HDF5 files. ``run_simulation`` streams the batches of a
kinematics file through it into a writer, with the JAX driver's
step-window and budget auto-tuning, one batch's copy to the host in flight
behind the next batch's step and the copy-out and writes on a background
thread, each batch sharded over every card torch finds (one host thread a
card); ``simulate`` runs one event. All run on the card unless the caller
passes ``device="cpu"``, which runs the kernels' plain PyTorch versions.

    integrate_tracks (transport.py)       [E*K] tracks, RK4 windows
 -> generate_electrons (deposition.py)    Fano-smeared counts
 -> deposit_and_merge (deposition.py)     diffusion mesh + (pad, tb) merge
 -> _convert_to_spyral (this file)        ADC threshold, z-order, pool
 -> assemble_device (assemble_cuda.py)    wiggle, exact z order, columns
"""

from __future__ import annotations

import contextvars
import copy
import dataclasses
import os
import queue
import sys
import threading
import time
import weakref
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .. import kernels, nuclear_map
from ..constants import NUM_TB
from ..kernels import require_device, require_devices
from ..utils.profiling import (
    PhaseTimes,
    begin_run,
    card_turns,
    count,
    device_wait,
    end_run,
    on_card,
    phase_timer,
    profiling,
    stage,
)
from .deposition import (
    LOOKUPS,
    MERGES,
    MESH_STEPS,
    compact_cloud,
    deposit_and_merge,
    fano_noise,
    generate_electrons,
    raw_wiggle,
    rows_path,
)
from . import assemble_cuda
from .assemble import AssembleTables
from .parameters import PAD_ID_SENTINEL, PAD_TABLE_NX, PAD_TABLE_NY, Config
from .response import get_response
from .sort_cuda import live_sites, sort_rows
from .transport import TrackSpecies, integrate_tracks

__all__ = [
    "EngineParams",
    "DetectorSimulator",
    "PoolOverflow",
    "run_simulation",
    "simulate",
    "split_packed",
    "wiggle_for_events",
]

_INT64_MAX = 0x7FFFFFFFFFFFFFFF
_INT64_MIN = -0x8000000000000000


def split_packed(packed: np.ndarray):
    """[P, 2] int32 packed rows -> (q f32, tb i32, pad i32, lab i32), the
    bit-exact inverse of ``_convert_to_spyral``'s packing: column 0 holds
    the f32 bits of the gained charge, column 1 tb << 22 | pad << 8 |
    label. (Copy of simulator.py:72-87.)"""
    q = np.ascontiguousarray(packed[:, 0]).view(np.float32)
    meta = packed[:, 1]
    tb = meta >> 22
    pad = (meta >> 8) & 0x3FFF
    lab = meta & 0xFF
    return q, tb, pad, lab


def wiggle_for_events(
    counts: np.ndarray, event_numbers: np.ndarray, seed: int
) -> np.ndarray:
    """U[0, 1) f64 TB wiggle (reference simulator.py:108) for per-event row
    runs, from numpy Philox streams keyed on (seed, event number): the
    same values for any batching of a run. (Copy of simulator.py:90-112,
    and of the writer child's copy.)"""
    out = np.empty(int(np.sum(counts)), np.float64)
    pos = 0
    for n, ev in zip(counts, event_numbers):
        n = int(n)
        if n:
            key = np.array(
                [int(seed) & 0xFFFFFFFFFFFFFFFF, int(ev)], dtype=np.uint64
            )
            gen = np.random.Generator(np.random.Philox(key=key))
            out[pos : pos + n] = gen.random(n)
            pos += n
    return out


@dataclass
class EngineParams:
    """Engine knobs of the batched detector step (the JAX package's
    EngineParams less its TPU-only ones).

    n_time_steps: deposit points per track (reference t_eval: 10,000), the
        physics window: ``run_simulation`` tunes its window down to the
        tracks' observed lifetimes (and retries larger when they outlive
        it), never past this value.
    dt: integrator step in seconds (reference: 1e-10).
    chunk_steps: steps per transport window; the host stops after the
        first window that ends with every track dead.
    point_budget: deposit-point slots per event; overflow is counted and
        ``run_simulation`` doubles the budget and retries.
    uniq_budget: unique (pad, tb) slots per event (the merged window).
    cloud_cap: per-event capacity of the compacted raw-cloud pool, built
        only for a reference-protocol writer (``compact_cloud``).
    out_budget: Spyral rows per event in the shared output pool.
    events_per_batch: events per device step.
    merge: the per-event merge. "sorts" (default): two row sorts (K3)
        around a prefix sum, the JAX package's ``pallas_sort=True``.
        "fused": the whole merge (K5: K3 and the merge-tail kernel), its
        ``pallas_sort="fused"``; rows wider than 2^18 after padding keep
        the sorts path, as there.
    lookup: the pad lookup. "two_stage" (default): K2, the JAX package's
        ``lookup_two_stage=True``. "one_stage": K6, its
        ``lookup_two_stage=False``. Both give the same keys.
    """

    n_time_steps: int = 10000
    dt: float = 1e-10
    chunk_steps: int = 500
    point_budget: int = 1024
    uniq_budget: int = 12288
    cloud_cap: int = 12288
    out_budget: int = 8192
    events_per_batch: int = 256
    merge: str = "sorts"
    lookup: str = "two_stage"

    def __post_init__(self) -> None:
        for name, allowed in (("merge", MERGES), ("lookup", LOOKUPS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"EngineParams.{name}="
                                 f"{getattr(self, name)!r}: expected one of "
                                 f"{allowed}")


class DetectorSimulator:
    """The batched detector step for one (config, reaction) pair on one
    device.

    config: Config; proton_numbers, mass_numbers [N]: the nuclei of each
    kinematics row; indices: which nuclei to simulate (None: every
    exit-channel nucleus, [2, 4, ..., N-1], reference simulator.py:153-158;
    neutral nuclei are skipped); engine: EngineParams; device: where the
    step runs. A CUDA device runs the hand-written kernels, a CPU device
    their plain PyTorch versions.
    """

    def __init__(
        self,
        config: Config,
        proton_numbers: np.ndarray,
        mass_numbers: np.ndarray,
        indices: list[int] | None = None,
        engine: EngineParams | None = None,
        device: torch.device | str = "cuda",
    ):
        self.device = require_device(device)
        self.config = config
        self.engine = engine or EngineParams()
        if indices is None:
            indices = list(range(2, len(proton_numbers), 2))
            indices.append(len(proton_numbers) - 1)
        self.sim_indices = [i for i in indices if proton_numbers[i] != 0]
        if len(self.sim_indices) == 0:
            raise ValueError("No charged nuclei to simulate")
        self.k_tracks = len(self.sim_indices)

        gas = config.det_params.gas_target
        masses, charges, tables = [], [], []
        log_lo = dlog = None
        for i in self.sim_indices:
            nucleus = nuclear_map.get_data(
                int(proton_numbers[i]), int(mass_numbers[i])
            )
            log_ke, dedx = gas.dedx_interp_arrays(nucleus)
            masses.append(nucleus.mass)
            charges.append(float(nucleus.Z))
            tables.append(dedx)
            log_lo = float(log_ke[0])
            dlog = float(log_ke[1] - log_ke[0])
        self.track_masses = np.array(masses)  # f64, for the gamma*beta init
        dev = config.device_arrays()
        resp = np.asarray(get_response(config), dtype=np.float64)
        self.from_jax_state({
            "mass": np.array(masses),
            "charge": np.array(charges),
            "dedx": np.stack(tables),
            "log_ke_lo": log_lo,
            "dlog_ke": dlog,
            "key_grid_mm": dev["key_grid_mm"],
            "pad_table": dev["pad_table"],
            "labels": np.array(self.sim_indices),
            "resp_max": float(resp.max()),
        })
        # host response tables (f64, the reference's arithmetic) for
        # assemble_spyral
        self._resp_asc_f64 = np.sort(resp)
        self._resp_prefix_f64 = np.concatenate(
            [[0.0], np.cumsum(self._resp_asc_f64)]
        )
        self._grid_lo_mm = float(dev["grid_lo_mm"])
        self._grid_n_mm = int(dev["grid_n_mm"])

    def from_jax_state(self, state: dict) -> None:
        """Load the step's tables from numpy arrays: the JAX simulator's
        (so that tests compute both sides from identical tables) or this
        constructor's own.

        Keys: mass, charge [S]; dedx [S, N]; log_ke_lo, dlog_ke; key_grid_mm
        [n_mm, n_mm]; either pad_table [560, 640] or the JAX kernel's
        plane_hi and plane_lo (pad id = hi * 128 + lo); labels [S];
        resp_max. The key grid is checked against the pad table.
        """
        dev = self.device
        f32 = torch.float32
        if "pad_table" in state:
            table = np.asarray(state["pad_table"], dtype=np.int32)
        else:
            table = (np.asarray(state["plane_hi"]) * 128
                     + np.asarray(state["plane_lo"])).astype(np.int32)
        if table.shape != (PAD_TABLE_NX, PAD_TABLE_NY):
            raise ValueError(f"pad table of shape {table.shape}")
        key_grid = np.asarray(state["key_grid_mm"])
        n_mm = key_grid.shape[0]
        pads = table[:n_mm, :n_mm].astype(np.int64)
        expect = np.where(pads < PAD_ID_SENTINEL, pads * NUM_TB, 2**31 - 1)
        if not np.array_equal(expect, key_grid):
            raise ValueError("key_grid_mm and the pad-id table disagree")
        self.species = TrackSpecies(
            mass=torch.as_tensor(np.asarray(state["mass"]), dtype=f32,
                                 device=dev),
            charge=torch.as_tensor(np.asarray(state["charge"]), dtype=f32,
                                   device=dev),
            log_ke_lo=float(state["log_ke_lo"]),
            dlog_ke=float(state["dlog_ke"]),
            dedx=torch.as_tensor(np.asarray(state["dedx"]), dtype=f32,
                                 device=dev).contiguous(),
        )
        self.pad_table = torch.as_tensor(table, device=dev).contiguous()
        self._labels = torch.as_tensor(
            np.asarray(state["labels"]), dtype=torch.int32, device=dev
        )
        self._resp_max = float(state["resp_max"])

    # ------------------------------------------------------------------ #

    def _core(
        self,
        vg: torch.Tensor,
        n_events: int,
        point_budget: int,
        uniq_budget: int,
        n_steps: int,
        seed: int,
        event_start: int,
        noise: torch.Tensor | None,
        wiggle: bool = False,
    ):
        """Transport + electrons + deposit/merge for ``n_events`` events
        (simulator.py:359-485). ``noise`` [n_steps, E*K] replaces the Fano
        draws of ``fano_noise(seed, event_start, ...)``; with ``wiggle`` the
        cloud also holds the raw cloud's wiggled ``tbs`` (``raw_wiggle``).
        Returns (cloud dict, steps_alive)."""
        cfg, eng = self.config, self.engine
        dp = cfg.det_params
        e, k = n_events, self.k_tracks
        b = e * k
        chunk = min(eng.chunk_steps, n_steps)
        with stage("step.transport"):
            pos0 = vg[:, :3].repeat_interleave(k, dim=0)  # [B, 3] event-major
            gv0 = vg[:, 3:].reshape(b, 3)
            s_idx = torch.arange(k, dtype=torch.int32,
                                 device=vg.device).repeat(e)
            track_labels = self._labels.repeat(e)
            positions, dke, alive = integrate_tracks(
                pos0, gv0, s_idx, self.species,
                density=float(dp.gas_target.density), bfield=float(dp.bfield),
                efield=float(dp.efield), dt=float(eng.dt), n_steps=n_steps,
                chunk_steps=chunk,
            )
            # steps with any live track (the JAX run_simulation retunes its
            # window from it; kept in meta_i32)
            steps_alive = alive.any(dim=1).sum(dtype=torch.int32)
        with stage("step.fano"):
            if noise is None:
                noise = fano_noise(seed, event_start, e, k, n_steps, chunk,
                                   device=vg.device)
            electrons = generate_electrons(
                dke, noise.to(vg.device), dp.w_value, dp.fano_factor
            )
            u_cap = min(uniq_budget, point_budget * 100)
            raw = (raw_wiggle(seed, event_start, e, u_cap, device=vg.device)
                   if wiggle else None)
        cloud = deposit_and_merge(
            positions, electrons, alive, track_labels,
            self.pad_table,
            grid_lo_mm=self._grid_lo_mm,
            grid_n_mm=self._grid_n_mm,
            diffusion=dp.diffusion,
            efield=dp.efield,
            drift_velocity=cfg.drift_velocity,
            micromegas_edge=float(cfg.elec_params.micromegas_edge),
            length=dp.length,
            mpgd_gain=float(dp.mpgd_gain),
            n_events=e,
            tracks_per_event=k,
            point_budget=point_budget,
            uniq_budget=uniq_budget,
            wiggle=raw,
            merge=eng.merge,
            lookup=eng.lookup,
        )
        return cloud, steps_alive

    def _finish(self, cloud: dict, steps_alive: torch.Tensor,
                out_budget: int, e: int) -> dict:
        """Spyral conversion + the per-batch metadata (simulator.py:487-519).
        meta_i32: kept counts [E], n_points [E], merged counts [E], then
        out_overflow, uniq_overflow, pool_overflow, steps_alive, uniq_max."""
        window = cloud["pads"].shape[0] // e
        packed, counts, out_overflow = self._convert_to_spyral(
            cloud, out_budget, e, window
        )
        cloud["packed"] = packed
        cloud["spyral_counts"] = counts
        cloud["spyral_overflow"] = out_overflow
        scalars = torch.stack([
            out_overflow, cloud["uniq_overflow"], cloud["pool_overflow"],
            steps_alive, cloud["uniq_max"],
        ]).to(torch.int32)
        cloud["meta_i32"] = torch.cat(
            [counts, cloud["n_points"], cloud["counts"], scalars]
        )
        return cloud

    def _convert_to_spyral(self, cloud: dict, out_budget: int, e: int,
                           window: int):
        """ADC threshold, per-event z order and the pooled output
        (simulator.py:744-873).

        Each merged row packs into one int64 sort key: [63] keep,
        [62:54] 511 - tb, [53:40] pad, [39:32] label, [31:0] f32 charge
        bits, so an ascending signed row sort (K3) puts each event's kept
        rows first in descending integer tb (ascending z). The kept prefixes
        are then packed into the [min(E*out_budget, E*window), 2] int32
        pool: f32 charge bits, tb << 22 | pad << 8 | label."""
        w = window
        dev = cloud["charges"].device
        q = cloud["charges"]
        tbs_i = cloud["tbs_i"]
        amp = torch.clamp(self._resp_max * q, max=4095.0)
        keep = cloud["cloud_valid"] & (
            amp > float(self.config.elec_params.adc_threshold)
        )
        counts = keep.reshape(e, w).sum(dim=1, dtype=torch.int32)
        total = counts.sum(dtype=torch.int32)
        out_pool = min(e * out_budget, e * w)
        out_overflow = torch.clamp(total - out_pool, min=0)

        i64 = torch.int64
        qbits = q.view(torch.int32).to(i64) & 0xFFFFFFFF
        key64 = (
            torch.where(keep, _INT64_MIN, 0)
            | ((511 - tbs_i.to(i64)) << 54)
            | (cloud["pads"].to(i64) << 40)
            | (cloud["labels"].to(i64) << 32)
            | qbits
        )
        # dropped rows sort last (their fields may be garbage)
        key64 = torch.where(keep, key64, _INT64_MAX)
        k_s = sort_rows(key64.reshape(e, w))

        # pool slot s -> (event, column): the event whose kept rows cover s
        cum = torch.cumsum(counts, dim=0, dtype=torch.int32)
        slots = torch.arange(out_pool, dtype=torch.int32, device=dev)
        ev = torch.searchsorted(cum, slots, right=True).clamp(max=e - 1)
        start = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                           cum[:-1]])
        col = torch.clamp(slots - start[ev], 0, w - 1)
        ok = slots < torch.clamp(total, max=out_pool)
        g = k_s.reshape(-1)[ev.long() * w + col.long()]

        tb_g = 511 - ((g >> 54) & 0x1FF)
        meta = ((tb_g << 22) | (((g >> 40) & 0x3FFF) << 8)
                | ((g >> 32) & 0xFF)).to(torch.int32)
        qlo = (((g & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)
        packed = torch.stack(
            [torch.where(ok, qlo, 0), torch.where(ok, meta, 0)], dim=-1
        )
        return packed, counts, out_overflow

    # ------------------------------------------------------------------ #

    def assemble_spyral(self, q, tbs, pads, labels):
        """Spyral's 8 f64 columns from the packed rows (simulator.py:630-673,
        the reference's writer math): x/y from pad centers, z from the
        wiggled tb, amplitude and integral of the GET response applied to
        the merged charge (sorted response + prefix sums), pad id, tb, pad
        size. Returns (spyral [n, 8] f64, labels [n] i64)."""
        cfg = self.config
        pads = pads.astype(np.int64)
        labels = labels.astype(np.int64)
        q = q.astype(np.float64)
        tbs = np.asarray(tbs, dtype=np.float64)
        amp = np.minimum(self._resp_max * q, 4095.0)
        thr = 4095.0 / np.maximum(q, 1e-300)
        idx = np.searchsorted(self._resp_asc_f64, thr, side="right")
        integral = q * self._resp_prefix_f64[idx] + 4095.0 * (NUM_TB - idx)
        win = float(cfg.elec_params.windows_edge)
        mm = float(cfg.elec_params.micromegas_edge)
        out = np.empty((len(pads), 8), dtype=np.float64)
        out[:, 0] = cfg.pad_centers[pads, 0]
        out[:, 1] = cfg.pad_centers[pads, 1]
        out[:, 2] = (win - tbs) / (win - mm) * cfg.det_params.length * 1000.0
        out[:, 3] = amp
        out[:, 4] = integral
        out[:, 5] = pads
        out[:, 6] = tbs
        out[:, 7] = cfg.pad_sizes[pads]
        return out, labels

    def assemble_spyral_ordered(self, packed, counts, event_numbers,
                                wiggle_seed: int):
        """split_packed + host TB wiggle + exact per-event z order
        (simulator.py:675-719): the native C pipeline for contiguous event
        ranges where the library is available, numpy otherwise (the two
        are bit-identical). Returns pooled (spyral [n, 8], labels [n])."""
        ev = np.asarray(event_numbers)
        if len(ev) and np.array_equal(ev, np.arange(ev[0], ev[0] + len(ev))):
            from ..native import native_assemble_batch

            res = native_assemble_batch(
                packed, counts, int(ev[0]), wiggle_seed, self._native_tables()
            )
            if res is not None:
                return res
        q, tb, pad, lab = split_packed(packed)
        tbs = tb + wiggle_for_events(counts, event_numbers, wiggle_seed)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        for i in range(len(counts)):
            lo, hi = offsets[i], offsets[i + 1]
            if hi - lo > 1:
                order = np.argsort(-tbs[lo:hi], kind="stable")
                q[lo:hi] = q[lo:hi][order]
                tbs[lo:hi] = tbs[lo:hi][order]
                pad[lo:hi] = pad[lo:hi][order]
                lab[lo:hi] = lab[lo:hi][order]
        return self.assemble_spyral(q, tbs, pad, lab)

    def assemble_device(self, packed: torch.Tensor, counts, event_ids,
                        seed: int):
        """The Spyral assembly on ``self.device``: packed rows [P, 2] int32
        (P = sum(counts)) of events with ``counts`` [E] kept rows and
        global ids ``event_ids`` [E] -> device tensors (spyral [P, 8] f64,
        labels [P] int64), each event's rows in ascending z, the TB wiggle
        keyed (``seed``, event id). The same values as
        ``assemble_spyral_ordered``, bit for bit: on a CUDA device the
        kernel (``assemble_cuda``; a build or launch failure raises), on
        the CPU its plain version."""
        dev = self.device
        return assemble_cuda.assemble(
            packed.to(dev),
            torch.as_tensor(counts).to(device=dev, dtype=torch.int32),
            torch.as_tensor(event_ids).to(device=dev, dtype=torch.int64),
            seed, self._assemble_tables())

    def _assemble_tables(self) -> AssembleTables:
        t = getattr(self, "_asm_tables", None)
        if t is None:
            t = AssembleTables.from_numpy(self._native_tables(), self.device)
            self._asm_tables = t
        return t

    def _native_tables(self) -> dict:
        t = getattr(self, "_nat_tables", None)
        if t is None:
            cfg = self.config
            pc = np.asarray(cfg.pad_centers, dtype=np.float64)
            t = {
                "pad_cx": np.ascontiguousarray(pc[:, 0]),
                "pad_cy": np.ascontiguousarray(pc[:, 1]),
                "pad_sizes": np.ascontiguousarray(
                    np.asarray(cfg.pad_sizes, dtype=np.float64)
                ),
                "resp_asc": np.ascontiguousarray(self._resp_asc_f64),
                "resp_prefix": np.ascontiguousarray(self._resp_prefix_f64),
                "resp_max": self._resp_max,
                "windows_edge": float(cfg.elec_params.windows_edge),
                "micromegas_edge": float(cfg.elec_params.micromegas_edge),
                "length": float(cfg.det_params.length),
            }
            self._nat_tables = t
        return t

    # ------------------------------------------------------------------ #

    def simulate_batch(
        self,
        vertices: np.ndarray,
        momenta: np.ndarray,
        seed: int = 0,
        event_start: int = 0,
        noise: torch.Tensor | np.ndarray | None = None,
        assemble: bool = True,
        point_budget: int | None = None,
        uniq_budget: int | None = None,
        out_budget: int | None = None,
        n_steps: int | None = None,
        wiggle_seed: int = 0,
        compact: bool = False,
        cloud_cap: int | None = None,
    ) -> dict:
        """Simulate a batch of events on ``self.device``.

        vertices [E, 3] f64 (m); momenta [E, N, 4] f64 (MeV). ``seed`` keys
        the Fano draws of event ``event_start + i`` (global ids, so the
        draws do not depend on the batching); ``noise`` [n_steps, E*K]
        standard normals replaces them.

        Returns a dict of device tensors: ``packed`` [P, 2] int32 (split on
        the host with ``split_packed``; event i's rows are
        [cumsum(counts)[i-1], cumsum(counts)[i])), ``spyral_counts`` [E],
        ``meta_i32``, the merged cloud and the overflow counters; with
        ``assemble``, also host ``spyral`` [total, 8] f64 and
        ``spyral_labels`` [total] i64, assembled on ``self.device``
        (``assemble_device``; event i's TB wiggle keyed (``wiggle_seed``,
        i)).
        With ``compact``, the merged cloud (with its wiggled ``tbs``) is
        pooled by ``compact_cloud`` at ``cloud_cap`` rows an event (its
        counts replace the merged ones) and ``cloud_overflow`` counts the
        rows past the pool: the reference-protocol writer's layout.
        """
        eng = self.engine
        e = len(vertices)
        with stage("step.prepare"):
            # initial gamma*beta = p / m (reference solver.py:273), f64 on
            # host
            p3 = momenta[:, self.sim_indices, :3]
            gvs = (p3 / self.track_masses[None, :, None]).astype(np.float32)
            vg = np.concatenate(
                [np.asarray(vertices, dtype=np.float32), gvs.reshape(e, -1)],
                axis=1,
            )
            vg_dev = torch.from_numpy(vg).to(self.device)
            if noise is not None:
                noise = torch.tensor(noise, dtype=torch.float32)
        cloud, steps_alive = self._core(
            vg_dev, e, point_budget or eng.point_budget,
            uniq_budget or eng.uniq_budget, n_steps or eng.n_time_steps,
            seed, event_start, noise, wiggle=compact,
        )
        with stage("step.convert"):
            out = self._finish(cloud, steps_alive,
                               out_budget or eng.out_budget, e)
            if compact:
                cc = compact_cloud(out, e, cloud_cap or eng.cloud_cap)
                out["cloud_overflow"] = cc.pop("overflow")
                out.update(cc)
        if assemble:
            count("syncs", "assemble")
            total = int(out["spyral_counts"].sum())
            spyral, labels = self.assemble_device(
                out["packed"][:total], out["spyral_counts"],
                torch.arange(e), wiggle_seed)
            out["spyral"] = spyral.cpu().numpy()
            out["spyral_labels"] = labels.cpu().numpy()
        return out


class PoolOverflow(RuntimeError):
    """A batch overflowed one or more per-event budgets."""

    def __init__(self, kinds: dict):
        super().__init__(f"pool overflow: {kinds}")
        self.kinds = kinds


def overflow_kinds(meta: np.ndarray, n_steps: int | None = None,
                   max_steps: int | None = None,
                   cloud_overflow: int = 0) -> dict:
    """The budgets a batch overflowed (simulator.py:1162-1185), from its
    meta_i32, whose last five entries are the out, uniq and point
    overflows, steps_alive and uniq_max: "point", "uniq", "out"; "cloud"
    where ``cloud_overflow`` (rows past the compacted pool) is positive;
    "steps" where tracks were alive at the end of a window of ``n_steps``
    shorter than the physics window ``max_steps``."""
    out_overflow, uniq_overflow, pool_overflow, steps_alive = meta[-5:-1]
    kinds = {}
    if pool_overflow > 0:
        kinds["point"] = int(pool_overflow)
    if uniq_overflow > 0:
        kinds["uniq"] = int(uniq_overflow)
    if out_overflow > 0:
        kinds["out"] = int(out_overflow)
    if cloud_overflow > 0:
        kinds["cloud"] = int(cloud_overflow)
    if n_steps is not None and steps_alive >= n_steps and n_steps < max_steps:
        kinds["steps"] = int(steps_alive)
    return kinds


# one DetectorSimulator for simulate(): it holds the step's device tables
_SIMULATE_CACHE: dict = {}


def _config_fingerprint(config: Config) -> tuple:
    """Value-derived key of everything a DetectorSimulator takes from a
    Config (simulator.py:46-58): physics scalars, electronics, the gas and
    the pad asset sources."""
    dp, ep, pp = config.det_params, config.elec_params, config.pad_params
    gas = dp.gas_target
    return (
        dp.length, dp.efield, dp.bfield, dp.mpgd_gain, dp.diffusion,
        dp.fano_factor, dp.w_value,
        ep.clock_freq, ep.amp_gain, ep.shaping_time, ep.micromegas_edge,
        ep.windows_edge, ep.adc_threshold,
        tuple(gas.components), gas.pressure, getattr(gas, "temperature", None),
        str(pp.grid_path), str(pp.geometry_path), str(pp.pad_size_path),
    )


def _engine_fingerprint(engine: EngineParams | None) -> tuple | None:
    """Every field of ``engine`` (simulator.py:61-69)."""
    return None if engine is None else dataclasses.astuple(engine)


def simulate(
    momenta: np.ndarray,
    vertex: np.ndarray,
    proton_numbers: np.ndarray,
    mass_numbers: np.ndarray,
    config: Config,
    rng: np.random.Generator,
    indices: list[int],
    engine: EngineParams | None = None,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """One event, the reference's single-event API (simulator.py:995-1048).

    Returns (cloud [n, 3] f64 = [pad, tb (wiggled), electrons], labels
    [n] i64): the event's merged cloud as ``simulate_batch(compact=True)``
    gives it, with the seed drawn from ``rng`` as the JAX package draws its
    key (``rng.integers(0, 2**63 - 1)``). The DetectorSimulator of the last
    (config, nuclei, indices, engine, device) is kept, keyed by content,
    not identity; bulk work belongs in ``run_simulation``.
    """
    dev = require_device(device)
    cache_key = (
        _config_fingerprint(config),
        tuple(np.asarray(proton_numbers).tolist()),
        tuple(np.asarray(mass_numbers).tolist()),
        tuple(indices),
        _engine_fingerprint(engine),
        str(dev),
    )
    sim = _SIMULATE_CACHE.get(cache_key)
    if sim is None:
        sim = DetectorSimulator(config, proton_numbers, mass_numbers,
                                indices=indices, engine=engine, device=dev)
        _SIMULATE_CACHE.clear()
        _SIMULATE_CACHE[cache_key] = sim
    seed = int(rng.integers(0, 2**63 - 1))
    # a one-event pool as wide as the merged window: nothing is cut
    out = sim.simulate_batch(np.asarray(vertex)[None, :],
                             np.asarray(momenta)[None, :, :], seed=seed,
                             assemble=False, compact=True,
                             cloud_cap=sim.engine.uniq_budget)
    n = int(out["counts"][0])
    cloud = torch.stack([out["pads"][:n].double(), out["tbs"][:n].double(),
                         out["charges"][:n].double()], dim=-1)
    return cloud.cpu().numpy(), out["labels"][:n].long().cpu().numpy()


class _HostCopies:
    """Copies of a batch's rows to the host (the assembled Spyral rows and
    labels, or the packed rows), started behind the batch's step and
    finished on the writer thread (simulator.py:1353-1363).

    On a CUDA device a copy runs on a side stream, after an event recorded
    on the compute stream, into a page-locked buffer of the source's type
    and row shape; the source is kept alive for the side stream
    (``record_stream``). ``finish`` waits for the copy, copies the rows out
    into an array the caller owns and only then frees the buffer for
    another batch; ``lend`` hands the buffer's rows to a callback without
    a copy and frees the buffer after it, unless the callback kept them.
    ``start`` runs on the main thread and ``finish`` and ``lend`` on the
    writer thread: the free list is taken and refilled under a lock. On
    the CPU the rows are the tensor's own memory. ``times`` counts each
    fresh page-locked buffer (``pinned_allocs``, ``pinned_bytes``) and
    each wait for a copy (``syncs`` at ``copy-finish``).

    ``start_many`` copies the rows of several cards, end to end, into one
    buffer, each card's on a side stream of its own, and its handle waits
    for each card's copy (``syncs`` at the site given for it).
    """

    ROWS_QUANTUM = 1 << 16

    def __init__(self, device: torch.device,
                 times: PhaseTimes | None = None):
        self.cuda = device.type == "cuda"
        # the side stream of each card: ``device``'s made here, another
        # card's on the first copy from it
        self.streams = {}
        if self.cuda:
            side = torch.cuda.Stream(device)
            self.streams[side.device] = side
        self.free: list[torch.Tensor] = []
        self.lock = threading.Lock()
        self.times = times if times is not None else PhaseTimes()

    def take_free(self, rows: int,
                  like: torch.Tensor | None = None) -> torch.Tensor | None:
        """The first free buffer of at least ``rows`` rows (and of
        ``like``'s type and row shape, where given), taken out of the free
        list by its position (``list.remove`` would compare buffers with
        the elementwise tensor ``==``), or None."""
        with self.lock:
            for i, buf in enumerate(self.free):
                if buf.shape[0] >= rows and (
                        like is None or (buf.dtype == like.dtype
                                         and buf.shape[1:] == like.shape[1:])):
                    return self.free.pop(i)
        return None

    def _buffer(self, rows: int, like: torch.Tensor) -> torch.Tensor:
        """A free page-locked buffer of at least ``rows`` rows of
        ``like``'s type and row shape, or a new one."""
        buf = self.take_free(rows, like=like)
        if buf is None:
            q = self.ROWS_QUANTUM
            buf = torch.empty((max(-(-rows // q), 1) * q, *like.shape[1:]),
                              dtype=like.dtype, pin_memory=True)
            self.times.count("pinned_allocs")
            self.times.count("pinned_bytes", n=buf.nbytes)
        return buf

    def _copy(self, buf: torch.Tensor, at: int, src: torch.Tensor):
        """Copy ``src`` into ``buf[at:]`` on its card's side stream, after
        the work queued on its card's current stream; the copy's event."""
        side = self.streams.get(src.device)
        if side is None:
            side = self.streams[src.device] = torch.cuda.Stream(src.device)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(src.device))
        side.wait_event(ready)
        with torch.cuda.stream(side):
            buf[at:at + src.shape[0]].copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        src.record_stream(side)
        return done

    def start(self, src: torch.Tensor):
        if not self.cuda:
            return src
        rows = src.shape[0]
        buf = self._buffer(rows, src)
        return buf, rows, self._copy(buf, 0, src)

    def start_many(self, srcs: list, sites: list):
        """One handle for the rows of ``srcs`` (one tensor a card, of one
        type and row shape) end to end; waiting for it counts a ``syncs``
        at ``sites[k]`` for card k's copy."""
        if not self.cuda:
            return torch.cat(srcs)
        rows = sum(src.shape[0] for src in srcs)
        buf = self._buffer(rows, srcs[0])
        waits, at = [], 0
        for src, site in zip(srcs, sites):
            waits.append((site, self._copy(buf, at, src)))
            at += src.shape[0]
        return buf, rows, waits

    def _wait(self, done) -> None:
        """Wait for a handle's copy, or for each card's (``start_many``),
        counting each wait."""
        for site, event in (done if isinstance(done, list)
                            else [("copy-finish", done)]):
            self.times.count("syncs", site)
            event.synchronize()

    def finish(self, handle) -> np.ndarray:
        if not self.cuda:
            return handle.numpy()
        buf, rows, done = handle
        self._wait(done)
        rows_np = buf[:rows].numpy().copy()
        with self.lock:
            self.free.append(buf)
        return rows_np

    def lend(self, handles, use) -> None:
        """Call ``use(*arrays)`` with host views of the copies' page-locked
        buffers, once each copy is done: no copy out. Then each buffer goes
        back to the pool, unless its array outlived the call (``use`` kept
        it, or a view of it): such a buffer stays with its array and
        leaves the pool, so that no later copy overwrites what a caller
        kept. On the CPU the arrays are the tensors' own memory."""
        if not self.cuda:
            use(*(h.numpy() for h in handles))
            return
        arrays = []
        for buf, rows, done in handles:
            self._wait(done)
            arrays.append(buf[:rows].numpy())
        alive = [weakref.ref(a) for a in arrays]
        use(*arrays)
        del arrays
        with self.lock:
            self.free.extend(buf for (buf, _, _), ref in zip(handles, alive)
                             if ref() is None)


def _count_merge_sort(times: PhaseTimes, n_points: np.ndarray,
                      point_budget: int) -> None:
    """One step's counters of K3's live merge sort (``run_reader``'s
    "merge_sort.*"), from its events' n_points on the host."""
    per_point = MESH_STEPS * MESH_STEPS
    lanes = np.minimum(n_points.astype(np.int64), point_budget) * per_point
    times.count("merge_sort.lanes", n=int(lanes.sum()))
    times.count("merge_sort.width_lanes",
                n=len(lanes) * point_budget * per_point)
    for site, rows in live_sites(lanes).items():
        times.count("merge_sort.rows", site, rows)


def _round_up(k, q: int) -> int:
    """k rounded up to a multiple of q, at least q (simulator.py:1327-1330)."""
    return max(((int(k) + q - 1) // q) * q, q)


class _Cards:
    """One host thread a device of a run over several ("card-<k>"), each
    under a copy of the caller's context marked as its card's
    (``profiling.on_card``), so that the run's recorder finds it, and on
    its card as the thread's current CUDA device. ``submit`` hands card k
    a call; ``collect`` waits for the calls handed to the first ``n``
    cards and returns their results in card order, or raises the first
    exception once every card has answered. The threads run their calls
    in turns, holding ``baton``, which a thread gives up while it waits on
    its card (``profiling.device_wait``): a sync on one card holds up that
    card's thread only."""

    def __init__(self, devices: list):
        self.jobs = [queue.SimpleQueue() for _ in devices]
        self.results = [queue.SimpleQueue() for _ in devices]
        self.baton = threading.Lock()
        self.threads = []
        for k, dev in enumerate(devices):
            ctx = contextvars.copy_context()
            t = threading.Thread(target=ctx.run, args=(self._loop, k, dev),
                                 name=f"card-{k}", daemon=True)
            t.start()
            self.threads.append(t)

    def _loop(self, k: int, dev: torch.device) -> None:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        on_card(f"card-{k}", dev, self.baton)
        while True:
            job = self.jobs[k].get()
            if job is None:
                return
            fn, args = job
            try:
                with self.baton:
                    answer = (True, fn(*args))
            except BaseException as exc:  # raised on the caller's thread
                answer = (False, exc)
            self.results[k].put(answer)

    def submit(self, k: int, fn, *args) -> None:
        self.jobs[k].put((fn, args))

    def collect(self, n: int) -> list:
        answers = [self.results[k].get() for k in range(n)]
        for ok, value in answers:
            if not ok:
                raise value
        return [value for _, value in answers]

    def close(self) -> None:
        for q in self.jobs:
            q.put(None)
        for t in self.threads:
            t.join()


def _shards(n: int, n_devices: int) -> list[tuple[int, int]]:
    """A batch's events [0, n) cut into contiguous shards of
    ceil(n / n_devices) events, one a device (a short batch uses fewer)."""
    size = -(-n // n_devices)
    return [(lo, min(lo + size, n)) for lo in range(0, n, size)]


def run_reader(
    config: Config,
    reader,
    writer,
    indices: list[int] | None = None,
    engine: EngineParams | None = None,
    seed: int | None = None,
    show_progress: bool = True,
    start_event: int = 0,
    stop_event: int | None = None,
    auto_tune: bool = True,
    device: torch.device | str | list = "cuda",
    input_name: str | None = None,
) -> dict:
    """The batch loop of ``run_simulation`` over an open kinematics
    ``reader``: an object with ``n_events``, ``proton_numbers``,
    ``mass_numbers``, ``read_range(start, stop)`` -> (vertices, momenta)
    and ``close()``. It closes the reader and the writer on every exit.
    ``input_name`` is the input's name in the run manifest. Arguments and
    result as ``run_simulation``'s; a factoring of its body (so that a run
    can read arrays where no HDF5 reader exists), not an entry point.
    """
    times = PhaseTimes()
    token = begin_run(times)
    wall_t0 = time.perf_counter()
    # from the call to the first read: the simulators and their tables, the
    # host copies, the card threads and the writer thread
    init = phase_timer(times, "init").__enter__()
    progress = None
    sims: list = []
    devices: list = []
    budgets: dict = {}
    stop = None
    wq: queue.Queue = queue.Queue(maxsize=2)
    werr: list[BaseException] = []
    wthread = None
    cards = None
    try:
        devices = require_devices(device)
        if len(devices) == 1:
            # one device: the step's stages are timed on its stream
            times.cuda = devices[0] if devices[0].type == "cuda" else None
        engine = engine or EngineParams()
        sims = [DetectorSimulator(config, reader.proton_numbers,
                                  reader.mass_numbers, indices=indices,
                                  engine=engine, device=d) for d in devices]
        if seed is None:
            seed = int(np.random.SeedSequence().entropy % (2**31))
        stop = (reader.n_events if stop_event is None
                else min(stop_event, reader.n_events))
        if show_progress:
            try:
                from tqdm import tqdm

                progress = tqdm(total=reader.n_events)
            except ImportError:
                pass
        eb = engine.events_per_batch
        chunk = engine.chunk_steps
        # a writer without write_spyral_pool takes the reference protocol:
        # each event's raw [pad, tb, electrons] cloud through write()
        raw_writer = not hasattr(writer, "write_spyral_pool")
        # a writer with write_packed (SpyralWriterProc) takes packed rows
        # and assembles them in its child; any other writer of
        # write_spyral_pool takes rows assembled on the device
        packed_writer = hasattr(writer, "write_packed")
        copies = _HostCopies(devices[0], times)
        stats = {"events": 0, "rows": 0}
        budgets.update(
            point=engine.point_budget, uniq=engine.uniq_budget,
            cloud=engine.cloud_cap, out=engine.out_budget,
            # probe first: under auto-tuning the first batch runs one
            # chunk; the "steps" overflow climbs x4 up to the physics window
            steps=(min(chunk, engine.n_time_steps) if auto_tune
                   else engine.n_time_steps),
        )
        tuned = not auto_tune
        live_sort = rows_path(engine.merge, engine.lookup)

        def pull_batch(sim, out, n: int, cur_steps: int, point: int,
                       start: int, batch: int):
            """The metadata of events [start, start + n) (a sync, before
            the next dispatch), its overflows raised as PoolOverflow, then
            its Spyral assembly on the device, or the pull of its
            compacted raw cloud. Returns (counts, the device rows to copy
            to the host: (packed,) for a writer of packed rows, else
            (spyral, labels), merged counts, raw cloud, statistics for the
            tuning)."""
            with phase_timer(times, "pull-meta", batch):
                times.count("syncs", "pull-meta")
                with device_wait():
                    meta = out["meta_i32"].cpu().numpy()
            times.resolve()
            if live_sort:
                _count_merge_sort(times, meta[n:2 * n], point)
            cloud_overflow = 0
            if "cloud_overflow" in out:
                times.count("syncs", "cloud-overflow")
                with device_wait():
                    cloud_overflow = int(out["cloud_overflow"])
            kinds = overflow_kinds(meta, cur_steps, engine.n_time_steps,
                                   cloud_overflow)
            if kinds:
                raise PoolOverflow(kinds)
            # the port runs a short batch unpadded: stride n
            counts = meta[:n]
            n_points = meta[n:2 * n]
            merged_counts = meta[2 * n:3 * n]
            tune_stats = (int(n_points.max(initial=0)), int(meta[-1]),
                          int(counts.sum()), int(meta[-2]))
            if not raw_writer:
                total = int(counts.sum())
                packed = out["packed"][:total]
                if packed_writer:
                    return counts, (packed,), merged_counts, None, tune_stats
                with phase_timer(times, "assemble-device", batch):
                    rows = sim.assemble_device(
                        packed, out["spyral_counts"],
                        torch.arange(start, start + n, device=sim.device),
                        seed)
                return counts, rows, merged_counts, None, tune_stats
            with phase_timer(times, "pull-cloud", batch), device_wait():
                cl_counts = out["counts"][:n].cpu().numpy()
                cl_total = int(cl_counts.sum())
                raw = torch.stack(
                    [out[k][:cl_total].double()
                     for k in ("pads", "tbs", "charges")], dim=-1,
                ).cpu().numpy()
                labels_all = out["labels"][:cl_total].long().cpu().numpy()
            return counts, None, None, (raw, labels_all, cl_counts), tune_stats

        def step(sim, vertices, momenta, start: int, batch: int,
                 shard_budgets: dict, dispatch: str, after_dispatch=None):
            """Events [start, start + n) of batch ``batch`` dispatched on
            ``sim``'s device and pulled (``pull_batch``), again while a
            budget overflows, with every overflowing budget of
            ``shard_budgets`` doubled (the window climbed), at most 8
            times; ``after_dispatch`` runs once, after the first
            dispatch."""
            for _attempt in range(8):
                with phase_timer(times, dispatch, batch):
                    out = sim.simulate_batch(
                        vertices, momenta, seed=seed, event_start=start,
                        assemble=False,
                        point_budget=shard_budgets["point"],
                        uniq_budget=shard_budgets["uniq"],
                        out_budget=shard_budgets["out"],
                        n_steps=shard_budgets["steps"],
                        compact=raw_writer,
                        cloud_cap=shard_budgets["cloud"],
                    )
                if after_dispatch is not None:
                    after_dispatch()
                    after_dispatch = None
                try:
                    return pull_batch(sim, out, len(vertices),
                                      shard_budgets["steps"],
                                      shard_budgets["point"], start, batch)
                except PoolOverflow as ov:
                    for kind in ov.kinds:
                        times.count("retries", kind)
                        if kind == "steps":
                            shard_budgets["steps"] = min(
                                _round_up(shard_budgets["steps"] * 4, chunk),
                                engine.n_time_steps)
                        else:
                            shard_budgets[kind] *= 2
                            if shard_budgets[kind] > 2**21:
                                raise
            raise RuntimeError("pool budgets failed to converge")

        def shard_step(k: int, vertices, momenta, start: int, batch: int,
                       shard_budgets: dict):
            """Card k's shard of batch ``batch``, on card k's thread: a
            ``shard.step`` span timed on card k's stream around the shard's
            ``shard.dispatch`` and its pull, and under a profiler its turns
            (``shard.turn``). Returns ``step``'s result and the shard's
            budgets."""
            with phase_timer(times, "shard.step", batch, device_time=True), \
                    card_turns(times, batch):
                times.count("shard.events", f"card-{k}", len(vertices))
                pulled = step(sims[k], vertices, momenta, start, batch,
                              shard_budgets, "shard.dispatch")
            return pulled, shard_budgets

        def submit_shards(vertices, momenta, batch: int) -> int:
            """Hand each card its shard of batch ``batch``, with its own
            copy of the budgets; the number of shards."""
            cuts = _shards(len(vertices), len(devices))
            for k, (lo, hi) in enumerate(cuts):
                cards.submit(k, shard_step, k, vertices[lo:hi],
                             momenta[lo:hi], batch + lo, batch, dict(budgets))
            return len(cuts)

        def collect_shards(batch: int, n_shards: int):
            """The shards' results of batch ``batch``, joined in event
            order, with the copies of their rows started; the run's budgets
            grow to the largest any shard reached. Returns (counts, copy
            handles, merged counts, raw cloud, statistics for the
            tuning)."""
            answers = cards.collect(n_shards)
            for _, shard_budgets in answers:
                for key, value in shard_budgets.items():
                    budgets[key] = max(budgets[key], value)
            parts = [pulled for pulled, _ in answers]
            counts = np.concatenate([p[0] for p in parts])
            stat = [p[4] for p in parts]
            tune_stats = (max(s[0] for s in stat), max(s[1] for s in stat),
                          sum(s[2] for s in stat), max(s[3] for s in stat))
            if raw_writer:
                cloud = tuple(np.concatenate([p[3][i] for p in parts])
                              for i in range(3))
                return counts, None, None, cloud, tune_stats
            sites = [f"copy-finish.card-{k}" for k in range(n_shards)]
            with phase_timer(times, "pull-start", batch):
                handle = tuple(copies.start_many(list(rows), sites)
                               for rows in zip(*(p[1] for p in parts)))
            merged = np.concatenate([p[2] for p in parts])
            return counts, handle, merged, None, tune_stats

        def write_out(pending) -> None:
            """Finish one batch's copy to the host and write it, on the
            writer thread."""
            counts, handle, raw_counts, cloud_np, start, n = pending
            events = np.arange(start, start + n)
            if cloud_np is None:
                if packed_writer:
                    with phase_timer(times, "pull-packed", start):
                        packed = copies.finish(handle[0])
                    with phase_timer(times, "ship-to-writer", start):
                        writer.write_packed(packed, counts, events,
                                            raw_counts=raw_counts,
                                            wiggle_seed=seed)
                else:
                    pull = phase_timer(times, "pull-spyral", start).__enter__()

                    def write(spyral, labels):
                        pull.__exit__()
                        with phase_timer(times, "h5py-write", start):
                            writer.write_spyral_pool(spyral, labels, counts,
                                                     event_numbers=events,
                                                     raw_counts=raw_counts)

                    copies.lend(handle, write)
            else:
                raw, labels_all, cl_counts = cloud_np
                offsets = np.concatenate([[0], np.cumsum(cl_counts)])
                for i in range(n):
                    lo, hi = int(offsets[i]), int(offsets[i + 1])
                    if hi > lo:
                        writer.write(raw[lo:hi], labels_all[lo:hi], config,
                                     start + i)
            if progress is not None:
                progress.update(n)

        def writer_loop() -> None:
            while True:
                pending = wq.get()
                if pending is None:
                    return
                try:
                    if not werr:
                        write_out(pending)
                except BaseException as exc:  # raised on the main thread
                    werr.append(exc)

        def enqueue_write(pending) -> None:
            if werr:
                raise werr[0]
            wq.put(pending)

        if len(devices) > 1:
            if devices[0].type == "cuda":
                kernels.library()  # built or loaded once, before the threads
            cards = _Cards(devices)
        wthread = threading.Thread(target=writer_loop, name="spyral-writer")
        wthread.start()
        init.__exit__()
        init = None
        # the previous batch, whose rows are on their way to the host
        pending_dev = None

        def flush() -> None:
            nonlocal pending_dev
            if pending_dev is not None:
                enqueue_write(pending_dev)
                pending_dev = None

        def finish(start: int, n: int, counts, handle, merged, cloud_np,
                   tune_stats) -> None:
            """A batch's rows on their way to the writer, its counts, and
            after the first batch the budgets retightened to its
            multiplicities."""
            nonlocal pending_dev, tuned
            if cloud_np is not None:
                enqueue_write((counts, None, None, cloud_np, start, n))
            elif cards is None:
                pending_dev = (counts, handle, merged, None, start, n)
            else:
                enqueue_write((counts, handle, merged, None, start, n))
            stats["events"] += n
            stats["rows"] += int(counts.sum())
            if not tuned:
                # retighten to the first batch's multiplicities
                pts_max, uniq_max, kept, steps_alive = tune_stats
                budgets["point"] = min(budgets["point"],
                                       _round_up(pts_max * 1.3, 64))
                budgets["uniq"] = min(budgets["uniq"],
                                      _round_up(uniq_max * 1.3, 1024))
                budgets["out"] = min(budgets["out"],
                                     _round_up(kept / eb * 1.3, 1024))
                budgets["steps"] = min(_round_up(steps_alive * 1.3, chunk),
                                       engine.n_time_steps)
                tuned = True

        for start in range(start_event, stop, eb):
            with phase_timer(times, "read", start):
                vertices, momenta = reader.read_range(start,
                                                      min(start + eb, stop))
            if profiling():
                times.count("batches")
            n = len(vertices)
            if cards is None:
                counts, rows, merged, cloud_np, tune_stats = step(
                    sims[0], vertices, momenta, start, start, budgets,
                    "dispatch", flush)
                handle = None
                if rows is not None:
                    with phase_timer(times, "pull-start", start):
                        handle = tuple(copies.start(r) for r in rows)
                del rows
                finish(start, n, counts, handle, merged, cloud_np,
                       tune_stats)
                continue
            n_shards = submit_shards(vertices, momenta, start)
            finish(start, n, *collect_shards(start, n_shards))
        flush()
        wq.put(None)
        wthread.join()
        if werr:
            raise werr[0]
        times.resolve(wait=True)
        if os.environ.get("ATTPC_TPU_TIMING"):
            print(f"[run_simulation] budgets={budgets}\n{times.summary()}",
                  file=sys.stderr)
        stats["budgets"] = dict(budgets)
        stats["phase_seconds"] = dict(times.seconds)
        stats["counters"] = copy.deepcopy(times.counters)
        stats["spans"] = times.span_summary()
        return stats
    finally:
        if init is not None:
            init.__exit__()
        end_run(token)
        if cards is not None:
            cards.close()
        if wthread is not None and wthread.is_alive():
            wq.put(None)
            wthread.join()
        try:
            writer.close()
        finally:
            reader.close()
            if progress is not None:
                progress.close()
        if sims and hasattr(writer, "get_directory_name"):
            from ..utils.manifest import write_run_manifest

            dp, ep = config.det_params, config.elec_params
            write_run_manifest(
                writer.get_directory_name(),
                stage="detector",
                seed=seed,
                event_range=(start_event, stop),
                device=devices,
                config={
                    "input": input_name,
                    "length_m": dp.length,
                    "efield": dp.efield,
                    "bfield": dp.bfield,
                    "mpgd_gain": dp.mpgd_gain,
                    "diffusion": dp.diffusion,
                    "fano_factor": dp.fano_factor,
                    "w_value": dp.w_value,
                    "adc_threshold": ep.adc_threshold,
                    "sim_indices": sims[0].sim_indices,
                },
                budgets=budgets,
                phase_seconds=dict(times.seconds),
                wall_seconds=time.perf_counter() - wall_t0,
                extra={"events_per_batch": engine.events_per_batch,
                       "counters": times.counters,
                       "spans": times.span_summary()},
            )


def run_simulation(
    config: Config,
    input_path: Path | str,
    writer,
    indices: list[int] | None = None,
    engine: EngineParams | None = None,
    seed: int | None = None,
    show_progress: bool = True,
    start_event: int = 0,
    stop_event: int | None = None,
    auto_tune: bool = True,
    device: torch.device | str | list = "cuda",
) -> dict:
    """Run the detector simulation over a kinematics file into ``writer``
    (simulator.py:1051-1479; its device mesh as threads, one a card).

    Batches of ``engine.events_per_batch`` events are read with
    ``KinematicsReader`` and simulated on ``device``: by default
    (``"cuda"``) on every CUDA card torch finds, on one card with an
    index (``"cuda:1"``), the plain PyTorch versions with ``device="cpu"``,
    or on each device of a list; a CUDA device where torch finds none
    raises before any work. Over several devices each batch is cut into
    contiguous shards of ceil(events / devices) events, one a device (a
    short batch uses fewer), each dispatched on its device by a host
    thread of its own ("card-<k>") with its global event ids, so that a
    sync on one card holds up no other; the writer gets each batch's rows
    whole and in event order, as from one device. The rows do not depend
    on the layout: every draw is keyed by (seed, global event id).

    With ``auto_tune`` the first batch runs one chunk of ``chunk_steps``
    steps (a window that the "steps" overflow climbs x4, up to
    ``n_time_steps``), and then the window and the point, uniq and out
    budgets are retightened to 1.3x the first batch's multiplicities
    (rounded up to chunk_steps, 64, 1024 and 1024). A batch that overflows
    a budget runs again with every overflowing budget doubled (the window
    climbed), at most 8 times; over several devices only the shard that
    overflowed runs again, the run's budgets, shared by the shards, grow
    to the largest a shard reached before the next batch is handed out,
    and the probe's retightening takes the largest multiplicities of the
    shards. Every draw depends only on the event's
    global id, so a retry or a tuned window reproduces the same physics,
    and a run resumed with the same seed at ``start_event`` reproduces the
    events it would have produced, for any ``events_per_batch``.

    Each batch's rows are assembled on ``device`` once its metadata shows
    no overflow (``DetectorSimulator.assemble_device``: on the card one
    kernel launch a batch) and copied to the host behind the next batch's
    step; one background thread finishes the copies and writes (a bounded
    queue, batches in order; its first exception is raised here). The
    writer takes packed rows (``write_packed``, SpyralWriterProc, whose
    child assembles them on the host), assembled rows
    (``write_spyral_pool``, SpyralWriter; on the card it gets views of
    page-locked buffers, which the driver reuses after the call unless the
    writer kept the arrays) or, lacking both, each event's raw [pad, tb,
    electrons] cloud (``write``, the reference ``SimulationWriter``
    protocol; the "cloud" overflow doubles ``cloud_cap``). The writer is closed on every
    exit; one with ``get_directory_name`` gets a run manifest there.
    ``show_progress`` shows a tqdm bar where tqdm is installed;
    ``ATTPC_TPU_TIMING`` prints the budgets and phase times to stderr.

    Returns {"events": n, "rows": Spyral rows kept, "budgets": the final
    budgets, "phase_seconds": wall seconds by phase ("init": from the call
    to the first read; then each batch's "read", "dispatch", "pull-meta",
    "assemble-device" and "pull-start" on this thread, "pull-spyral" and
    "h5py-write" on the writer thread), "counters", "spans"}. The run
    manifest holds the counters and spans too.

    "counters", always kept: "syncs", the host's waits on the device by
    site ("transport.window": each physics window's live-track check;
    "pull-meta": a batch's metadata; "cloud-overflow": the raw cloud's
    pool overflow; "assemble": ``simulate_batch(assemble=True)``;
    "copy-finish": the writer thread's wait for a batch's copy; over
    several devices each site carries the card's name,
    "pull-meta.card-1", "copy-finish.card-1");
    "pinned_allocs" and "pinned_bytes", the page-locked buffers allocated
    for the copies to the host; "retries", the batches run again, by the
    budget that overflowed; "batches", the batches read while a torch
    profiler recorded; over several devices "shard.events", the events
    each card ran, by card ("card-0", ...); in the default configuration
    (``merge="sorts"``, ``lookup="two_stage"``), whose merge sort takes
    K3's live route over each event's point prefix (``sort_cuda.
    sort_rows_live``), counted from each step's metadata: "merge_sort.lanes",
    the prefixes' lanes (min(n_points, point_budget) * 100 an event),
    "merge_sort.width_lanes", the rows' lanes (point_budget * 100 an
    event), and "merge_sort.rows", the events by the route their prefix
    takes on the card (``sort_cuda.live_sites``: "cluster-1" ...
    "cluster-8", "wide", "empty").

    "spans", while a torch profiler records (``utils.trace_to``; empty
    without one): each span's host seconds, count and, for a step stage
    on the card, the seconds the stream spent between the stage's two
    CUDA events (else None), by name: the phases above, and the stages of
    each "dispatch" (``DetectorSimulator.simulate_batch``): "step.prepare"
    (the initial gamma*beta and its copy to the device), "step.transport",
    "step.fano" (the Fano draws and the electrons), "step.deposit" (the
    points' compaction and their pixel rows), "step.merge" (the merge of
    equal (pad, tb) keys) and "step.convert" (threshold, z order and the
    pooled rows). Each is also a ``record_function`` range of the trace;
    ``utils.profiling.last_run()`` holds the last call's spans themselves.
    Over several devices each card's thread (its span's ``thread``,
    "card-<k>") has, for each batch, in place of "dispatch": a
    "shard.step" span, timed on the card's stream from before the shard's
    dispatch to after its assembly, around "shard.dispatch" (the shard's
    ``simulate_batch``, with the stages inside it timed on the card's
    stream), "pull-meta" and "assemble-device", and its "shard.turn"
    spans, one for each stretch of the thread's host work between its
    waits on the card and for its turn (``utils.profiling``), timed on the
    card's stream from the turn's start to the end of the work launched in
    it; "pull-start" (the copies of every card's rows into one page-locked
    buffer) stays on this thread.
    """
    from ..io.kinematics_file import KinematicsReader

    try:
        require_devices(device)
        reader = KinematicsReader(input_path)
    except BaseException:
        writer.close()
        raise
    return run_reader(config, reader, writer, indices=indices, engine=engine,
                      seed=seed, show_progress=show_progress,
                      start_event=start_event, stop_event=stop_event,
                      auto_tune=auto_tune, device=device,
                      input_name=str(input_path))
