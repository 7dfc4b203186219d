"""Host C++ libraries, loaded with ctypes (port of attpc_engine_tpu/native).

``libstopping`` generates the stopping-power tables; ``libspyral_io`` is the
Spyral writer's hot path (Philox TB wiggle, per-event z-sort, [n, 8] f64
assembly, HDF5 writes through the libhdf5 bundled with h5py). Both are built
with ``g++`` from the repository's ``native/*.cpp`` into the port's own
git-ignored ``build/`` directory on first use, once for each source (a
library built by one process is loaded by the others); where the build or
the load fails, callers take the pure-Python versions, which compute the
same values.
``ATTPC_TPU_NO_NATIVE=1`` forces the Python versions.

This is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

BUILD_DIR = Path(__file__).resolve().parent / "build"
_NATIVE_SRC = Path(__file__).resolve().parents[1] / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_libs: dict[str, ctypes.CDLL | None] = {}
_paths: dict[str, Path | None] = {}


def _build(name: str, source: str) -> Path | None:
    """``build/lib<name>-<hash>.so`` compiled from ``native/<source>``, the
    hash taken over the source, the flags and ``g++ --version``; None on
    failure.

    A process loads the library another process built from the same
    source. The check and the build hold an exclusive lock on
    ``build/native.lock``, so that processes started together wait for
    one build, and the library is written under a temporary name and
    renamed into place, so that no process loads a half-written file.
    """
    if name not in _paths:
        _paths[name] = _build_once(name, _NATIVE_SRC / source)
    return _paths[name]


def _build_once(name: str, src: Path) -> Path | None:
    if not src.exists():
        return None
    try:
        version = subprocess.run(["g++", "--version"], capture_output=True,
                                 check=True, timeout=60).stdout
        h = hashlib.sha256(src.read_bytes() + b"\0"
                           + "\0".join(GXX_FLAGS).encode() + b"\0" + version)
        so_path = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "native.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if so_path.exists():
                return so_path
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(
                    ["g++", *GXX_FLAGS, "-o", tmp, str(src), "-ldl"],
                    check=True, capture_output=True, timeout=300)
                os.replace(tmp, so_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    except (OSError, subprocess.SubprocessError):
        return None
    return so_path


def hdf5_bundle() -> tuple[str | None, list[str]]:
    """(libhdf5 path, dependency .so paths) from h5py's wheel, or (None, [])
    where h5py is not installed."""
    import glob

    try:
        import h5py
    except ImportError:
        return None, []
    base = Path(h5py.__file__).resolve().parent.parent / "h5py.libs"
    libs = sorted(glob.glob(str(base / "*.so*")))
    main = [p for p in libs if Path(p).name.startswith("libhdf5-")]
    deps = [p for p in libs if "hdf5" not in Path(p).name]
    return (main[0] if main else None), deps


def spyral_io_path() -> Path | None:
    """Path of the built libspyral_io, or None."""
    if os.environ.get("ATTPC_TPU_NO_NATIVE"):
        return None
    return _build("spyral_io", "spyral_io.cpp")


def get_spyral_io_lib() -> ctypes.CDLL | None:
    """The handle to libspyral_io with its assembly entry point declared,
    or None."""
    if "spyral_io" not in _libs:
        lib = None
        so_path = spyral_io_path()
        if so_path is not None:
            try:
                lib = ctypes.CDLL(str(so_path))
            except OSError:
                lib = None
        if lib is not None:
            d = ctypes.POINTER(ctypes.c_double)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.sio_assemble_batch.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, i64p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, d, d, d, d,
                d, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_double, d, i64p,
            ]
            lib.sio_assemble_batch.restype = None
        _libs["spyral_io"] = lib
    return _libs["spyral_io"]


def native_assemble_batch(
    packed: np.ndarray,
    counts: np.ndarray,
    start_event: int,
    wiggle_seed: int,
    tables: dict,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Packed device rows -> (spyral [n, 8] f64, labels i64), each event's
    rows z-sorted; None if the library is unavailable. ``tables`` as in
    ``DetectorSimulator._native_tables``."""
    lib = get_spyral_io_lib()
    if lib is None:
        return None
    packed = np.ascontiguousarray(packed, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    rows = int(counts.sum())
    out_spyral = np.empty((rows, 8), dtype=np.float64)
    out_labels = np.empty(rows, dtype=np.int64)
    d = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sio_assemble_batch(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rows,
        counts.ctypes.data_as(i64p),
        len(counts),
        int(start_event),
        int(wiggle_seed) & 0xFFFFFFFFFFFFFFFF,
        tables["pad_cx"].ctypes.data_as(d),
        tables["pad_cy"].ctypes.data_as(d),
        tables["pad_sizes"].ctypes.data_as(d),
        tables["resp_asc"].ctypes.data_as(d),
        tables["resp_prefix"].ctypes.data_as(d),
        len(tables["resp_asc"]),
        float(tables["resp_max"]),
        float(tables["windows_edge"]),
        float(tables["micromegas_edge"]),
        float(tables["length"]),
        out_spyral.ctypes.data_as(d),
        out_labels.ctypes.data_as(i64p),
    )
    return out_spyral, out_labels


def get_stopping_lib() -> ctypes.CDLL | None:
    """The handle to libstopping, or None if it cannot be built or loaded."""
    if "stopping" not in _libs:
        lib = None
        so_path = (
            None if os.environ.get("ATTPC_TPU_NO_NATIVE")
            else _build("stopping", "stopping.cpp")
        )
        if so_path is not None:
            try:
                lib = ctypes.CDLL(str(so_path))
            except OSError:
                lib = None
        if lib is not None:
            d = ctypes.POINTER(ctypes.c_double)
            lib.mass_stopping_power.argtypes = [
                ctypes.c_int, ctypes.c_double, d, ctypes.c_int,
                d, d, d, ctypes.c_int, ctypes.c_double, d,
            ]
            lib.mass_stopping_power.restype = None
        _libs["stopping"] = lib
    return _libs["stopping"]


def native_mass_stopping_power(
    z_proj: int,
    mass_mev: float,
    ke_mev: np.ndarray,
    constituents: list[tuple[int, int, float]],
    i_override_ev: float | None = None,
) -> np.ndarray | None:
    """C++ stopping power; None if the library is unavailable."""
    lib = get_stopping_lib()
    if lib is None:
        return None
    ke = np.ascontiguousarray(np.atleast_1d(ke_mev), dtype=np.float64)
    z_t = np.ascontiguousarray([c[0] for c in constituents], dtype=np.float64)
    a_t = np.ascontiguousarray([c[1] for c in constituents], dtype=np.float64)
    w_t = np.ascontiguousarray([c[2] for c in constituents], dtype=np.float64)
    out = np.empty_like(ke)
    d = ctypes.POINTER(ctypes.c_double)
    lib.mass_stopping_power(
        int(z_proj), float(mass_mev),
        ke.ctypes.data_as(d), len(ke),
        z_t.ctypes.data_as(d), a_t.ctypes.data_as(d), w_t.ctypes.data_as(d),
        len(constituents),
        float(i_override_ev or 0.0),
        out.ctypes.data_as(d),
    )
    return out.reshape(np.shape(ke_mev))
