"""Detector stage: batched event simulation (port of
attpc_engine_tpu/detector/simulator.py).

A ``DetectorSimulator`` runs the detector step for a batch of events on one
device: transport (K1), electron generation, deposition and merge (K2 and
K3 by default; K6 and K5 with ``EngineParams(lookup="one_stage",
merge="fused")``), and the Spyral conversion (K3), giving packed int32 rows
per batch, which the Spyral assembly (``assemble_device``: TB wiggle, z
order and the eight f64 columns in one kernel on the card) turns into the
rows of the Spyral HDF5 files; ``StepMeta`` reads a step's metadata on the
host. On a CUDA device the default step (no noise given, no raw cloud
pooled, ``merge="sorts"``, ``lookup="two_stage"``) runs as one CUDA graph
from its second call in a row at the same budgets (``step_graph.py``).
``simulate`` runs one event. The driver that streams the batches of a
kinematics file through the step into a writer, ``run_simulation`` and its
batch loop ``run_reader``, is ``driver.py``; both names are importable from
here too. All run on the card unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions.

    integrate_tracks (transport.py)       [E*K] tracks, RK4 windows
 -> fano_electrons_cuda (fano_cuda.py)    Fano draws and smeared counts
    / generate_electrons (deposition.py)  (the CPU, or noise given)
 -> deposit_and_merge (deposition.py)     diffusion mesh + (pad, tb) merge
 -> _convert_to_spyral (this file)        ADC threshold, z-order, pool
 -> assemble_device (assemble_cuda.py)    wiggle, exact z order, columns
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import nuclear_map
from ..constants import NUM_TB
from ..kernels import require_device
from ..utils.profiling import count, stage
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
from .fano_cuda import WORDS, fano_electrons_cuda, fano_key, fano_words
from .parameters import PAD_ID_SENTINEL, PAD_TABLE_NX, PAD_TABLE_NY, Config
from .response import get_response
from .sort_cuda import live_sites, sort_rows
from .step_graph import StepGraphs
from .transport import TrackSpecies, integrate_tracks

__all__ = [
    "EngineParams",
    "DetectorSimulator",
    "PoolOverflow",
    "StepMeta",
    "run_simulation",
    "simulate",
    "split_packed",
    "wiggle_for_events",
]


def __getattr__(name: str):
    # the driver imports this module: its two entry points are imported
    # back on first use, so that either module may be imported first
    if name in ("run_reader", "run_simulation"):
        from . import driver

        return getattr(driver, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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
    chunk_steps: steps per transport window; the windows after the first
        that ends with every track dead do nothing (decided on the
        device).
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
        # the default step's CUDA graph (step_graph.py); none off the card
        self._graphs = (StepGraphs(self.device) if self.device.type == "cuda"
                        else None)
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
        resp_max. The key grid is checked against the pad table. A graph
        of the step, which reads the old tables, is dropped.
        """
        if self._graphs is not None:
            self._graphs.forget()
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

    def _stage_inputs(self, vertices: np.ndarray, momenta: np.ndarray,
                      seed: int, event_start: int) -> torch.Tensor:
        """The step's inputs on the host, f32 [E * (3 + 3 K) + WORDS]: the
        vertices and the initial gamma*beta of each event's tracks (``vg``
        [E, 3 + 3 K], row by row), then the Fano kernel's words of the batch
        (``fano_words``, their int32 bits), so that one copy takes them to
        the device."""
        e = len(vertices)
        # initial gamma*beta = p / m (reference solver.py:273), f64 on host
        p3 = momenta[:, self.sim_indices, :3]
        gvs = (p3 / self.track_masses[None, :, None]).astype(np.float32)
        host = np.empty(e * (3 + 3 * self.k_tracks) + WORDS, np.float32)
        vg = host[:-WORDS].reshape(e, -1)
        vg[:, :3] = vertices
        vg[:, 3:] = gvs.reshape(e, -1)
        host[-WORDS:] = fano_words(seed, event_start).view(np.float32)
        return torch.from_numpy(host)

    def _core(
        self,
        inputs: torch.Tensor,
        n_events: int,
        point_budget: int,
        uniq_budget: int,
        n_steps: int,
        noise: torch.Tensor | None,
        wiggle: tuple[int, int] | None = None,
    ):
        """Transport + electrons + deposit/merge for ``n_events`` events
        (simulator.py:359-485), from ``_stage_inputs``'s ``inputs`` on the
        device, which hold the batch's seed and first event id in the Fano
        words: the kernel reads them on the card, the plain
        ``fano_noise(seed, event_start, ...)`` on the host. ``noise``
        [n_steps, E*K] replaces the Fano draws. With ``wiggle`` (seed,
        event_start) the cloud also holds the raw cloud's wiggled ``tbs``
        (``raw_wiggle``). Returns (cloud dict, steps_alive)."""
        cfg, eng = self.config, self.engine
        dp = cfg.det_params
        e, k = n_events, self.k_tracks
        b = e * k
        chunk = min(eng.chunk_steps, n_steps)
        vg = inputs[:-WORDS].view(e, 3 + 3 * k)
        with stage("step.transport"):
            # [B, 3] event-major
            pos0 = vg[:, None, :3].expand(e, k, 3).reshape(b, 3)
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
            # on the card the draws and counts are one kernel; given noise
            # (the tests' JAX draws) and the CPU take the plain version
            words = inputs[-WORDS:].view(torch.int32)
            if noise is None and vg.is_cuda:
                site = "kernel"
                electrons = fano_electrons_cuda(
                    dke, words, e, k, chunk, dp.w_value, dp.fano_factor)
            else:
                site = "plain"
                if noise is None:
                    noise = fano_noise(*fano_key(words), e, k, n_steps,
                                       chunk, device=vg.device)
                electrons = generate_electrons(
                    dke, noise.to(vg.device), dp.w_value, dp.fano_factor
                )
            count("fano.draws", site, n_steps * b)
            u_cap = min(uniq_budget, point_budget * 100)
            raw = (None if wiggle is None else
                   raw_wiggle(*wiggle, e, u_cap, device=vg.device))
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
        out_overflow, uniq_overflow, pool_overflow, steps_alive, uniq_max
        (read on the host by ``StepMeta.decode``)."""
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

    def count_merge_sort(self, meta: StepMeta, point_budget: int) -> None:
        """Count what K3's live merge sort took in one step of this
        simulator's at ``point_budget``, from the step's metadata, in the
        current run's recorder, whether the step ran eagerly or as a
        replay of its graph: "merge_sort.lanes", the events' prefixes
        (min(n_points, point_budget) * 100 lanes an event);
        "merge_sort.width_lanes", the rows' lanes; "merge_sort.rows", the
        events by the route their prefix takes on the card. Nothing where
        the step's merge takes no live route (``rows_path``)."""
        if not rows_path(self.engine.merge, self.engine.lookup):
            return
        per_point = MESH_STEPS * MESH_STEPS
        lanes = np.minimum(meta.n_points.astype(np.int64),
                           point_budget) * per_point
        count("merge_sort.lanes", n=int(lanes.sum()))
        count("merge_sort.width_lanes",
              n=len(lanes) * point_budget * per_point)
        for site, rows in live_sites(lanes).items():
            count("merge_sort.rows", site, rows)

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

        On a CUDA device the default step (no ``noise``, no ``compact``,
        ``merge="sorts"``, ``lookup="two_stage"``) is a CUDA graph from the
        second call in a row at the same events and budgets
        (``step_graph.py``): its tensors are then the graph's, which the
        next such call overwrites on the current stream. Read them, or
        queue what reads them on the current stream, before that call:
        ``run_reader``, which dispatches a batch before it pulls the one
        before, queues copies of what it pulls behind each dispatch
        (``driver._Output.keep``).
        """
        eng = self.engine
        e = len(vertices)
        budgets = (point_budget or eng.point_budget,
                   uniq_budget or eng.uniq_budget,
                   out_budget or eng.out_budget, n_steps or eng.n_time_steps)
        graphs = (self._graphs if noise is None and not compact
                  and rows_path(eng.merge, eng.lookup) else None)
        key = (self.device, e, *budgets)
        with stage("step.prepare"):
            host = self._stage_inputs(vertices, momenta, seed, event_start)
            inputs = (graphs.inputs(key, host) if graphs is not None
                      else host.to(self.device, non_blocking=True))
            if noise is not None:
                noise = torch.tensor(noise, dtype=torch.float32)

        def step(inputs: torch.Tensor) -> dict:
            # what a graph replays: a function of the inputs alone
            cloud, steps_alive = self._core(
                inputs, e, budgets[0], budgets[1], budgets[3], noise,
                wiggle=(seed, event_start) if compact else None)
            with stage("step.convert"):
                out = self._finish(cloud, steps_alive, budgets[2], e)
                if compact:
                    cc = compact_cloud(out, e, cloud_cap or eng.cloud_cap)
                    out["cloud_overflow"] = cc.pop("overflow")
                    out.update(cc)
            return out

        out = step(inputs) if graphs is None else graphs.run(key, inputs, step)
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


@dataclass
class StepMeta:
    """A step's metadata on the host: ``meta_i32`` as ``_finish`` lays it
    out, read by ``decode``, the one reader of that layout.

    counts: Spyral rows kept [E]; n_points: deposit points [E]; merged:
    merged (pad, tb) rows [E]; the rows past the out pool, the uniq window
    and the point budget (``out_overflow``, ``uniq_overflow``,
    ``point_overflow``) and, for a step that pooled its raw cloud
    (``compact``), past that pool (``cloud_overflow``, not in
    ``meta_i32``); steps_alive: steps with a live track; uniq_max: the
    largest merged window of an event.
    """

    counts: np.ndarray
    n_points: np.ndarray
    merged: np.ndarray
    out_overflow: int
    uniq_overflow: int
    point_overflow: int
    steps_alive: int
    uniq_max: int
    cloud_overflow: int = 0

    @classmethod
    def decode(cls, meta_i32, cloud_overflow: int = 0) -> StepMeta:
        """The metadata of a step's ``meta_i32`` on the host (3 E + 5
        int32), with the raw cloud pool's overflow where it has one."""
        meta = np.asarray(meta_i32)
        n = (len(meta) - 5) // 3
        scalars = [int(v) for v in meta[3 * n:]]
        return cls(meta[:n], meta[n:2 * n], meta[2 * n:3 * n], *scalars,
                   cloud_overflow=int(cloud_overflow))

    @classmethod
    def join(cls, metas: list[StepMeta]) -> StepMeta:
        """The metadata of consecutive shards of one batch as one batch's:
        the events' arrays end to end, the overflows summed, the largest
        steps_alive and uniq_max."""
        def cat(name):
            return np.concatenate([getattr(m, name) for m in metas])

        def total(name):
            return sum(getattr(m, name) for m in metas)

        return cls(cat("counts"), cat("n_points"), cat("merged"),
                   total("out_overflow"), total("uniq_overflow"),
                   total("point_overflow"),
                   max(m.steps_alive for m in metas),
                   max(m.uniq_max for m in metas), total("cloud_overflow"))

    @property
    def kept(self) -> int:
        """The Spyral rows kept in all the events."""
        return int(self.counts.sum())


def overflow_kinds(meta: StepMeta, n_steps: int | None = None,
                   max_steps: int | None = None) -> dict:
    """The budgets a batch overflowed (simulator.py:1162-1185), each with
    its count: "point", "uniq", "out", "cloud" (the raw cloud's pool);
    "steps" where tracks were alive at the end of a window of ``n_steps``
    shorter than the physics window ``max_steps``."""
    kinds = {kind: n for kind, n in (
        ("point", meta.point_overflow), ("uniq", meta.uniq_overflow),
        ("out", meta.out_overflow), ("cloud", meta.cloud_overflow)) if n > 0}
    if (n_steps is not None and meta.steps_alive >= n_steps
            and n_steps < max_steps):
        kinds["steps"] = meta.steps_alive
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
