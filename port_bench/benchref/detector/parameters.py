# Frozen copy of attpc_engine_tpu_torch/detector/parameters.py; the benchmark's reference imports nothing of the port.
"""Detector configuration: parameter dataclasses + ``Config``.

Mirrors the reference's ``detector/parameters.py``
(upstream attpc_engine/detector/parameters.py:10-261) API:
``DetectorParams``, ``ElectronicsParams``, ``PadParams`` and a ``Config``
that derives the drift velocity and loads pad-plane geometry.

Port details:

- geometry comes from the port's copy of the JAX package's bundle,
  ``data/pad_assets.npz`` (``data/PROVENANCE.md`` names its source),
- ``Config.device_arrays()`` builds the numpy tables of the detector step
  once, among them the ``[560, 640]`` int32 pad-id table that the pad-lookup
  kernel reads (``deposit_cuda.py``),
- the beam-pad veto is folded into that table.

Known divergence from the reference (documented): the reference's
``load_pad_sizes`` reads ``geometry_path`` instead of ``pad_size_path`` for
custom paths (parameters.py:255) — a bug we do not reproduce.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..nuclear.target import GasTarget

__all__ = ["DetectorParams", "ElectronicsParams", "PadParams", "Config", "DEFAULT"]

DEFAULT = "Default"

PAD_ASSETS = Path(__file__).resolve().parents[1] / "data" / "pad_assets.npz"

# pad-id table of the lookup kernel: [PAD_TABLE_NX (x cells), PAD_TABLE_NY
# (y cells)], vetoed cells and padding hold PAD_ID_SENTINEL. The shape and
# the rule are those of attpc_engine_tpu/detector/deposit_pallas.py:53-80,
# so the table equals plane_hi * 128 + plane_lo there.
PAD_ID_SENTINEL = 10240
PAD_TABLE_NX = 560
PAD_TABLE_NY = 640


@dataclass
class DetectorParams:
    """Detector parameters.

    Attributes
    ----------
    length: float
        Active-volume length in meters.
    efield: float
        Electric field magnitude in V/m (+z, parallel to the beam).
    bfield: float
        Magnetic field magnitude in Tesla (+z).
    mpgd_gain: int
        Overall micropattern gas detector gain (unitless).
    gas_target: GasTarget
        Target gas.
    diffusion: float
        Transverse electron diffusion coefficient (Volts).
    fano_factor: float
        Fano factor of the gas (unitless).
    w_value: float
        W-value of the gas in eV (energy per electron-ion pair).
    """

    length: float
    efield: float
    bfield: float
    mpgd_gain: int
    gas_target: GasTarget
    diffusion: float
    fano_factor: float
    w_value: float


@dataclass
class ElectronicsParams:
    """GET electronics parameters.

    Attributes
    ----------
    clock_freq: float
        GET clock frequency in MHz.
    amp_gain: int
        Amplifier gain in lsb/fC.
    shaping_time: int
        Shaping time in ns.
    micromegas_edge: int
        Micromegas edge in time buckets.
    windows_edge: int
        Window edge in time buckets.
    adc_threshold: int
        Minimum signal amplitude for a point to be kept.
    """

    clock_freq: float
    amp_gain: int
    shaping_time: int
    micromegas_edge: int
    windows_edge: int
    adc_threshold: int


@dataclass
class PadParams:
    """Pad-plane geometry sources.

    ``Default`` uses the packaged asset bundle. Custom paths accept the
    reference's file formats (grid npz with ``grid``/``edges``; centers and
    sizes CSVs with a header line).
    """

    grid_path: Path | str = DEFAULT
    geometry_path: Path | str = DEFAULT
    pad_size_path: Path | str = DEFAULT


class Config:
    """All simulation input parameters + derived state.

    Attributes
    ----------
    det_params, elec_params, pad_params
        The input dataclasses.
    drift_velocity: float
        Electron drift velocity in m/time-bucket, derived as
        length / (windows_edge - micromegas_edge) (reference
        parameters.py:164-174).
    pad_grid: np.ndarray [5600, 5600] int16
    pad_grid_edges: np.ndarray [3]
    pad_centers: np.ndarray [10240, 2]
    pad_sizes: np.ndarray [10240]
    beam_pads: np.ndarray [n]
    beam_mask: np.ndarray [10240] bool
    """

    def __init__(
        self,
        detector_params: DetectorParams,
        electronics_params: ElectronicsParams,
        pad_params: PadParams,
    ):
        self.det_params = detector_params
        self.elec_params = electronics_params
        self.pad_params = pad_params
        self.calculate_drift_velocity()
        self._load_pad_data()
        self._device_cache = None

    def calculate_drift_velocity(self) -> None:
        """Drift velocity in m/TB (reference parameters.py:164-174)."""
        self.drift_velocity = self.det_params.length / float(
            self.elec_params.windows_edge - self.elec_params.micromegas_edge
        )

    def _load_pad_data(self) -> None:
        pp = self.pad_params
        bundle = None
        if DEFAULT in (pp.grid_path, pp.geometry_path, pp.pad_size_path):
            with np.load(PAD_ASSETS) as data:
                bundle = dict(data.items())

        if pp.grid_path == DEFAULT:
            self.pad_grid = bundle["grid"]
            self.pad_grid_edges = bundle["edges"]
        else:
            data = np.load(pp.grid_path)
            self.pad_grid = np.asarray(data["grid"], dtype=np.int16)
            self.pad_grid_edges = np.asarray(data["edges"], dtype=np.float64)

        if pp.geometry_path == DEFAULT:
            self.pad_centers = bundle["centers"]
        else:
            self.pad_centers = np.loadtxt(
                pp.geometry_path, delimiter=",", skiprows=1
            )[:, :2].astype(np.float64)

        if pp.pad_size_path == DEFAULT:
            self.pad_sizes = bundle["sizes"]
        else:
            self.pad_sizes = np.loadtxt(
                pp.pad_size_path, delimiter=",", skiprows=1
            ).astype(np.float64)

        n_pads = len(self.pad_centers)
        if bundle is not None and "beam_mask" in bundle:
            self.beam_pads = bundle["beam_pads"]
            self.beam_mask = bundle["beam_mask"]
        else:
            raise ValueError("custom pad geometry needs the bundle's beam pads")
        self.n_pads = n_pads

    def device_arrays(self) -> dict:
        """The numpy tables of the detector step, built once.

        ``key_grid_mm`` [n_mm, n_mm] int32: pad id * NUM_TB per 1-mm cell,
        KEY_SENTINEL where vetoed (positions are floored to whole mm before
        binning, reference transporter.py:101-120, so one cell per mm is
        enough). ``pad_table`` [560, 640] int32: the pad id per cell, with
        PAD_ID_SENTINEL for holes, beam pads and padding; the pad-lookup
        kernel reads it.
        """
        if self._device_cache is None:
            from ..constants import NUM_TB
            from .response import get_response

            lo, hi, step = self.pad_grid_edges
            n_mm = int(round(hi - lo))
            mm = np.arange(n_mm)
            src = np.round(mm / step).astype(np.int64)
            src = np.clip(src, 0, self.pad_grid.shape[0] - 1)
            grid_mm = self.pad_grid[np.ix_(src, src)].astype(np.int64)
            vetoed = (grid_mm < 0) | self.beam_mask[np.clip(grid_mm, 0, None)]
            key_grid = np.where(vetoed, np.int32(2**31 - 1), grid_mm * NUM_TB)
            self._device_cache = {
                "key_grid_mm": key_grid.astype(np.int32),
                "pad_table": build_pad_table(grid_mm, self.beam_mask),
                "grid_lo_mm": float(lo),
                "grid_n_mm": n_mm,
                "edges": np.asarray(self.pad_grid_edges, dtype=np.float32),
                "centers": np.asarray(self.pad_centers, dtype=np.float32),
                "sizes": np.asarray(self.pad_sizes, dtype=np.float32),
                "response": np.asarray(get_response(self), dtype=np.float32),
            }
        return self._device_cache


def build_pad_table(grid_mm: np.ndarray, beam_mask: np.ndarray) -> np.ndarray:
    """[n_mm, n_mm] pad-id grid (-1 for holes) -> [560, 640] int32 table.

    The rule of attpc_engine_tpu/detector/deposit_pallas.py:59-80: holes,
    beam pads and the padding get PAD_ID_SENTINEL. The grid must leave at
    least one padding row and column: callers alias invalid pixels onto
    cell (559, 639).
    """
    n_mm = grid_mm.shape[0]
    if n_mm >= PAD_TABLE_NX:
        raise ValueError(
            f"pad grid too large for the lookup table: {n_mm} >= {PAD_TABLE_NX}"
        )
    vetoed = (grid_mm < 0) | beam_mask[np.clip(grid_mm, 0, None)]
    ids = np.where(vetoed, PAD_ID_SENTINEL, grid_mm).astype(np.int32)
    table = np.full((PAD_TABLE_NX, PAD_TABLE_NY), PAD_ID_SENTINEL, np.int32)
    table[:n_mm, :n_mm] = ids
    return table
