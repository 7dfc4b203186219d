"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for Hopper
(``sm_90a``), one nvcc process per source, all started together, and
linked into one shared library with a plain C interface, loaded with
ctypes: pointers and the stream go in as ``c_void_p``, and every entry
point returns the ``cudaError_t`` of its launches, which ``check`` turns
into an exception. The library is built into the git-ignored ``build/``
directory on first use, in the process that launches a kernel; nothing is
built when a module is imported. Its name carries a hash of every file in
``csrc/``, the flags and ``nvcc --version``, so that a process loads a
library another process built from the same sources and never one built
from other sources; concurrent first users wait on a lock in ``build/``
for one build.

The flags leave out ``--use_fast_math`` (IEEE ``logf``, ``sqrtf`` and
division) and add ``-fmad=false``: the transport kernel must round like its
plain PyTorch version, whose multiplies and adds are separate kernels, and
the merge tails (``merge_fused.cu``, ``merge_cluster.cu``,
``compact_runs.cu``) add only, in the order of their plain version. The
Spyral assembly (``assemble.cu``) rounds each f64 operation explicitly
(``__dmul_rn``, ``__dadd_rn``, ``__ddiv_rn``) in the order of the C++
library it is held to. The deposit-rows kernel rounds each of its few f32 operations explicitly
(``__fmul_rn``, ``__fadd_rn``), so it would not contract without the flag
either. The Fano kernel (``fano.cu``) rounds each of its f32 operations
explicitly, in the order of its plain version (``generate_electrons`` of
``fano_noise``), and uses IEEE ``logf``, ``sqrtf``, ``sinf`` and ``cosf``,
the functions PyTorch's CUDA kernels call. The other kernels do integer
work only.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("transport.cu", "deposit.cu", "deposit_rows.cu", "sort_cluster.cu",
           "merge_rows.cu", "merge_fused.cu", "merge_cluster.cu",
           "compact_runs.cu", "assemble.cu", "fano.cu")
LIBRARY = "libattpc_kernels-{key}.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
)
BUILD_TIMEOUT_S = 900

_state: dict = {"lib": None, "path": None, "build": None}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def run_parallel(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of the first
    that fails. Every process is waited for."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def source_key() -> str:
    """Hash of the sources the library is built from: every file in
    ``csrc/`` (the headers included), the source list, ``NVCC_FLAGS`` and
    ``nvcc --version``."""
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.is_file():
            h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update("\0".join(SOURCES + NVCC_FLAGS).encode())
    h.update(subprocess.run([nvcc(), "--version"], capture_output=True,
                            check=True, timeout=60).stdout)
    return h.hexdigest()[:16]


def build() -> Path:
    """Path of ``build/libattpc_kernels-<source_key>.so``, compiled from
    every source if no process has built it yet: one nvcc per source, in
    parallel, then one link. The check and the build hold an exclusive
    lock on ``build/kernels.lock``, so that processes started together
    wait for one build; the library is written under a temporary name and
    renamed into place, so that no process finds it half written. Raises
    with nvcc's output if the build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out = BUILD_DIR / LIBRARY.format(key=source_key())
    with open(BUILD_DIR / "kernels.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        built = not out.exists()
        if built:
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                objs = [str(Path(tmp) / f"{Path(s).stem}.o") for s in SOURCES]
                run_parallel([[nvcc(), *NVCC_FLAGS, "-c", str(CSRC / s),
                               "-o", o] for s, o in zip(SOURCES, objs)])
                lib = str(Path(tmp) / "lib.so")
                run_parallel([[nvcc(), *NVCC_FLAGS, "-shared", "-o", lib,
                               *objs]])
                os.replace(lib, out)
    _state["build"] = {"built": built, "seconds": time.perf_counter() - t0,
                       "library": out.name}
    _state["path"] = out
    return out


def build_seconds() -> dict | None:
    """This process's ``build``: {"built": True if it compiled the
    library, False if it loaded one already built from the same sources,
    "seconds": the build's time, or the check's and any wait's for one
    built by another process, "library": the file's name}; None if
    ``build`` has not run in this process."""
    return _state["build"]


def declare_rk4(lib: ctypes.CDLL) -> None:
    """Argument and result types of ``attpc_rk4_window`` in ``lib`` (this
    library, or a build of ``transport.cu`` alone)."""
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.attpc_rk4_window.argtypes = (
        [vp] * 7 + [i32, i32] + [vp] * 4 + [i32, i32] + [f32] * 15
        + [i32, vp]
    )
    lib.attpc_rk4_window.restype = ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                         ctypes.c_float)
    declare_rk4(lib)
    lib.attpc_packed_key_lookup.argtypes = [vp] * 5 + [i64, i32, i32, vp]
    lib.attpc_packed_key_lookup_rows.argtypes = (
        [vp] * 5 + [i64, i32, i32, vp])
    lib.attpc_pad_lookup.argtypes = [vp] * 4 + [i64, vp]
    lib.attpc_deposit_rows.argtypes = (
        [vp] * 10 + [i64, f32, f32, f32, i32, i32, vp])
    lib.attpc_sort_rows_cluster.argtypes = [
        vp, vp, i32, i64, i32, i32, i64, i32, i64, vp]
    lib.attpc_merge_rows_pass.argtypes = [vp, vp, vp, i64, i32, i64, i64, vp]
    lib.attpc_sort_rows_live.argtypes = [vp] * 4 + [i32, i64, i32, vp]
    lib.attpc_merge_rows_live.argtypes = [vp] * 5 + [i64, i32, i64, vp]
    lib.attpc_merge_rows_splits.argtypes = [i32, i64, i64]
    lib.attpc_merge_rows_splits.restype = i64
    lib.attpc_merge_rows_live_splits.argtypes = [i32, i64]
    lib.attpc_merge_rows_live_splits.restype = i64
    lib.attpc_sort_rows_cluster_occupancy.argtypes = [
        i32, i32, ctypes.POINTER(i32)]
    lib.attpc_merge_tail.argtypes = [vp] * 4 + [i32, i64, i32, i32, vp]
    lib.attpc_merge_cluster.argtypes = [vp] * 5 + [i32] * 7 + [vp]
    lib.attpc_merge_cluster_occupancy.argtypes = [
        i32, i32, ctypes.POINTER(i32)]
    lib.attpc_compact_runs.argtypes = [vp] * 7 + [i32, i64, i32, i32, vp]
    lib.attpc_compact_runs_prefix_stride.argtypes = [i32]
    lib.attpc_compact_runs_prefix_stride.restype = i32
    lib.attpc_fano_electrons.argtypes = (
        [vp] * 3 + [i32] * 4 + [ctypes.c_uint32] + [f32] * 3 + [vp])
    f64 = ctypes.c_double
    lib.attpc_assemble_spyral.argtypes = (
        [vp, i64, vp, i32, vp, ctypes.c_uint64] + [vp] * 4 + [i32] + [vp] * 2
        + [i32] + [f64] * 4 + [vp] * 4)
    for fn in (lib.attpc_packed_key_lookup,
               lib.attpc_packed_key_lookup_rows, lib.attpc_pad_lookup,
               lib.attpc_deposit_rows, lib.attpc_sort_rows_cluster,
               lib.attpc_sort_rows_cluster_occupancy,
               lib.attpc_merge_rows_pass, lib.attpc_sort_rows_live,
               lib.attpc_merge_rows_live, lib.attpc_merge_tail,
               lib.attpc_merge_cluster, lib.attpc_merge_cluster_occupancy,
               lib.attpc_compact_runs, lib.attpc_assemble_spyral,
               lib.attpc_fano_electrons):
        fn.restype = ctypes.c_int
    lib.attpc_error_string.argtypes = [i32]
    lib.attpc_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use by this process or
    loaded as another built it (``build``)."""
    if _state["lib"] is None:
        lib = ctypes.CDLL(str(_state["path"] or build()))
        _declare(lib)
        _state["lib"] = lib
    return _state["lib"]


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().attpc_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed: {msg} ({err})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    """The current PyTorch stream of ``t``'s device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple[int, ...] | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``): the kernels take nothing else."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def require_device(device: torch.device | str) -> torch.device:
    """``device`` as a torch.device; raises if it is a CUDA device and
    torch finds none. Nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: torch finds no CUDA device; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def require_devices(device) -> list[torch.device]:
    """The devices a driver run spreads each batch over: every CUDA card
    torch finds for a CUDA device without an index (``"cuda"``), one
    device for a device with an index (``"cuda:1"``) or the CPU, and each
    device of a list or tuple, all of one type. Raises as
    ``require_device`` does."""
    if isinstance(device, (list, tuple)):
        devices = [require_device(d) for d in device]
        if not devices or len({d.type for d in devices}) != 1:
            raise ValueError(f"devices {device!r}: give one or more "
                             "devices, all of one type")
        return devices
    dev = require_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]
