"""Spyral point-cloud writers (port of attpc_engine_tpu/detector/writer.py).

The output contract is the JAX package's (and the reference's,
upstream attpc_engine/detector/writer.py:12-281): files ``run_XXXX.h5``
of at most ``max_events_per_file`` events; per event ``/cloud/cloud_{n}``
f64 [N, 8] = [pad_x_mm, pad_y_mm, z_mm, amplitude, integral, pad_id,
tb_float, pad_size], z-ascending and ADC-thresholded, with attrs orig_run,
orig_event and ic_* = -1.0; ``/cloud/labels_{n}`` i64 [N]; group attrs
min_event and max_event; events with an empty raw cloud are skipped.

``SpyralWriter`` writes from this process; ``SpyralWriterProc`` hands the
packed device rows to a child process, the JAX package's writer script
``attpc_engine_tpu/io/spyral_child.py`` (it imports no package module and
no jax), launched by path. h5py is imported on use.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from .parameters import Config
from .response import get_response

__all__ = ["SpyralWriter", "SpyralWriterProc", "SPYRAL_CHILD"]

SPYRAL_CHILD = (
    Path(__file__).resolve().parents[2]
    / "attpc_engine_tpu" / "io" / "spyral_child.py"
)

# batches in flight to the child before the parent waits for an ack
MAX_OUTSTANDING = 4

# events whose points all failed the ADC threshold get 0-row datasets
# (reference writer.py:240-251)
_EMPTY_SPYRAL = np.empty((0, 8), dtype=np.float64)
_EMPTY_LABELS = np.empty((0,), dtype=np.int64)


class SpyralWriter:
    """Multi-file Spyral HDF5 writer in this process (writer.py:80-229).

    directory_path, config, max_events_per_file (default 5000),
    first_run_number; datasets are uncompressed, the reference's layout.
    """

    def __init__(
        self,
        directory_path: Path | str,
        config: Config,
        max_events_per_file: int = 5_000,
        first_run_number: int = 0,
    ):
        import h5py

        self._h5 = h5py
        self.directory_path = Path(directory_path)
        self.config = config
        self.max_events_per_file = max_events_per_file
        self.run_number = first_run_number
        self.starting_event = 0
        self.last_event = 0
        self.events_written = 0
        self._open()

    def _open(self) -> None:
        path = self.directory_path / f"run_{self.run_number:04d}.h5"
        self.file = self._h5.File(path, "w")
        self.cloud_group = self.file.create_group("cloud")

    def _write_event(self, spyral: np.ndarray, labels: np.ndarray,
                     event_number: int) -> None:
        if self.events_written == self.max_events_per_file:
            self.close()
            self.run_number += 1
            self._open()
            self.starting_event = event_number
            self.events_written = 0
        dset = self.cloud_group.create_dataset(
            f"cloud_{event_number}", data=spyral
        )
        dset.attrs["orig_run"] = self.run_number
        dset.attrs["orig_event"] = event_number
        dset.attrs["ic_amplitude"] = -1.0
        dset.attrs["ic_multiplicity"] = -1.0
        dset.attrs["ic_integral"] = -1.0
        dset.attrs["ic_centroid"] = -1.0
        self.cloud_group.create_dataset(
            f"labels_{event_number}", data=labels
        )
        self.last_event = event_number
        self.events_written += 1

    def write_spyral_pool(
        self,
        spyral_pool: np.ndarray,
        labels_pool: np.ndarray,
        counts: np.ndarray,
        event_numbers: np.ndarray,
        raw_counts: np.ndarray | None = None,
    ) -> None:
        """Write one batch: spyral_pool [sum(counts), 8] with the events'
        rows in order. An event whose raw cloud was empty (``raw_counts``
        0, or None and no kept rows) is skipped; one whose rows all failed
        the ADC threshold gets empty datasets."""
        offsets = np.concatenate([[0], np.cumsum(counts)])
        for i, event_number in enumerate(event_numbers):
            lo, hi = int(offsets[i]), int(offsets[i + 1])
            if hi == lo:
                if raw_counts is None or int(raw_counts[i]) == 0:
                    continue
                self._write_event(_EMPTY_SPYRAL, _EMPTY_LABELS,
                                  int(event_number))
                continue
            self._write_event(spyral_pool[lo:hi], labels_pool[lo:hi],
                              int(event_number))

    def get_directory_name(self) -> Path:
        return self.directory_path

    def close(self) -> None:
        self.cloud_group.attrs["min_event"] = self.starting_event
        self.cloud_group.attrs["max_event"] = self.last_event
        self.file.close()


class SpyralWriterProc:
    """Spyral writer in a child process fed over POSIX shared memory
    (writer.py:232-551, one child): the child is
    ``attpc_engine_tpu/io/spyral_child.py``, launched by path, and it
    assembles, wiggles, z-sorts and writes each batch. Its files equal
    ``SpyralWriter``'s. ``run_simulation`` ships it the packed device rows
    through ``write_packed``."""

    def __init__(
        self,
        directory_path: Path | str,
        config: Config,
        max_events_per_file: int = 5_000,
        first_run_number: int = 0,
    ):
        from ..native import hdf5_bundle, spyral_io_path

        self.directory_path = Path(directory_path)
        self.config = config
        resp = np.asarray(get_response(config), dtype=np.float64)
        asc = np.sort(resp)
        with tempfile.NamedTemporaryFile(suffix=".npz", delete=False) as f:
            np.savez(
                f,
                pad_centers=np.asarray(config.pad_centers, dtype=np.float64),
                pad_sizes=np.asarray(config.pad_sizes, dtype=np.float64),
                resp_asc=asc,
                resp_prefix=np.concatenate([[0.0], np.cumsum(asc)]),
                resp_max=resp.max(),
                windows_edge=float(config.elec_params.windows_edge),
                micromegas_edge=float(config.elec_params.micromegas_edge),
                length=float(config.det_params.length),
            )
            self._tables_path = f.name
        # the child takes the native assembly + HDF5 library where both it
        # and h5py's libhdf5 are available, numpy + h5py otherwise
        env = os.environ.copy()
        so = spyral_io_path()
        h5path, _ = hdf5_bundle()
        if so is not None and h5path is not None:
            env["ATTPC_SIO_LIB"] = str(so)
            env["ATTPC_SIO_HDF5"] = h5path
        self._proc = subprocess.Popen(
            [sys.executable, str(SPYRAL_CHILD), self._tables_path,
             str(self.directory_path), str(max_events_per_file),
             str(first_run_number), "-"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env,
        )
        self._outstanding: list = []
        self._free: list = []
        self._closed = False

    def _reap_one(self) -> None:
        line = self._proc.stdout.readline()
        if not line.startswith("ok "):
            raise RuntimeError(
                f"spyral writer child failed (rc={self._proc.poll()}): {line!r}"
            )
        name = line.split()[1]
        for i, shm in enumerate(self._outstanding):
            if shm.name == name:
                self._free.append(shm)  # acked segments are reused
                del self._outstanding[i]
                return
        raise RuntimeError(f"child acked unknown shm {name!r}")

    def write_packed(
        self,
        packed: np.ndarray,
        counts: np.ndarray,
        event_numbers: np.ndarray,
        raw_counts: np.ndarray | None = None,
        wiggle_seed: int = 0,
    ) -> None:
        """Ship one batch of packed [rows, 2] int32 rows to the child, which
        draws the TB wiggle from ``wiggle_seed``; ``raw_counts`` as in
        ``SpyralWriter.write_spyral_pool``."""
        from multiprocessing import shared_memory

        if self._proc.poll() is not None:
            raise RuntimeError(
                f"spyral writer child exited early (rc={self._proc.returncode})"
            )
        while len(self._outstanding) >= MAX_OUTSTANDING:
            self._reap_one()
        rows = len(packed)
        if rows == 0 and (raw_counts is None or int(np.sum(raw_counts)) == 0):
            return
        need = max(rows * 8, 1)
        shm = None
        for i, seg in enumerate(self._free):
            if seg.size >= need:
                shm = self._free.pop(i)
                break
        if shm is None:
            # rounded up so later, slightly larger batches reuse it
            shm = shared_memory.SharedMemory(
                create=True, size=(need + (1 << 21) - 1) >> 21 << 21
            )
        if rows:
            np.ndarray((rows, 2), dtype=np.int32, buffer=shm.buf)[:] = packed
        self._outstanding.append(shm)
        msg = {
            "shm": shm.name,
            "rows": rows,
            "counts": np.asarray(counts, dtype=np.int64).tolist(),
            "raw_counts": (None if raw_counts is None else
                           np.asarray(raw_counts, dtype=np.int64).tolist()),
            "start": int(event_numbers[0]),
            "wseed": int(wiggle_seed),
        }
        self._proc.stdin.write(json.dumps(msg) + "\n")
        self._proc.stdin.flush()

    def get_directory_name(self) -> Path:
        return self.directory_path

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        line = ""
        try:
            while self._outstanding:
                self._reap_one()
            self._proc.stdin.write(json.dumps({"close": True}) + "\n")
            self._proc.stdin.flush()
            line = self._proc.stdout.readline()
            self._proc.stdin.close()
            self._proc.wait(timeout=120)
        finally:
            if self._proc.poll() is None:
                self._proc.kill()
                self._proc.wait()
            for shm in self._outstanding + self._free:
                shm.close()
                shm.unlink()
            self._outstanding.clear()
            self._free.clear()
            os.unlink(self._tables_path)
        if line.strip() != "done":
            raise RuntimeError(f"spyral writer child exited abnormally: {line!r}")
