"""Spyral point-cloud writers (port of attpc_engine_tpu/detector/writer.py).

The output contract is the JAX package's (and the reference's,
upstream attpc_engine/detector/writer.py:12-281): files ``run_XXXX.h5``
of at most ``max_events_per_file`` events; per event ``/cloud/cloud_{n}``
f64 [N, 8] = [pad_x_mm, pad_y_mm, z_mm, amplitude, integral, pad_id,
tb_float, pad_size], z-ascending and ADC-thresholded, with attrs orig_run,
orig_event and ic_* = -1.0; ``/cloud/labels_{n}`` i64 [N]; group attrs
min_event and max_event; events with an empty raw cloud are skipped.

``SpyralWriter`` writes from this process, from assembled batches or, as
the reference ``SimulationWriter`` protocol's ``write``, from one event's
raw cloud; ``SpyralWriterProc`` hands the packed device rows to one child
process or to ``n_shards`` of them, each child the port's writer script
``io/spyral_child.py`` (a copy of the JAX package's; it imports no package
module), launched by path. Both take an HDF5 ``compression``
filter. h5py is imported on use.
"""

from __future__ import annotations

import atexit
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Protocol

import numpy as np

from .parameters import Config
from .response import get_response

__all__ = ["SimulationWriter", "SpyralWriter", "SpyralWriterProc",
           "convert_to_spyral", "SPYRAL_CHILD"]

SPYRAL_CHILD = Path(__file__).resolve().parents[1] / "io" / "spyral_child.py"

# batches in flight to the child before the parent waits for an ack
MAX_OUTSTANDING = 4

# events whose points all failed the ADC threshold get 0-row datasets
# (reference writer.py:240-251)
_EMPTY_SPYRAL = np.empty((0, 8), dtype=np.float64)
_EMPTY_LABELS = np.empty((0,), dtype=np.int64)


class SimulationWriter(Protocol):
    """The reference writer protocol (writer.py:40-50): ``run_simulation``
    hands a writer with neither ``write_spyral_pool`` nor ``write_packed``
    each event's raw cloud through ``write``."""

    def write(
        self, data: np.ndarray, labels: np.ndarray, config: Config, event_number: int
    ) -> None: ...

    def get_directory_name(self) -> Path: ...

    def close(self) -> None: ...


def convert_to_spyral(
    points: np.ndarray,
    window_edge: int,
    mm_edge: int,
    length: float,
    response: np.ndarray,
    pad_centers: np.ndarray,
    pad_sizes: np.ndarray,
) -> np.ndarray:
    """Spyral's 8 columns of a raw [N, 3] = [pad, tb, electrons] cloud
    (writer.py:53-78, the reference's writer.py:61-112)."""
    pads = points[:, 0].astype(np.int64)
    tbs = points[:, 1]
    electrons = points[:, 2]
    storage = np.empty((len(points), 8))
    sig = np.minimum(response[None, :] * electrons[:, None], 4095.0)
    storage[:, 0] = pad_centers[pads, 0]
    storage[:, 1] = pad_centers[pads, 1]
    storage[:, 2] = (window_edge - tbs) / (window_edge - mm_edge) * length * 1000.0
    storage[:, 3] = sig.max(axis=1)
    storage[:, 4] = sig.sum(axis=1)
    storage[:, 5] = pads
    storage[:, 6] = tbs
    storage[:, 7] = pad_sizes[pads]
    return storage


def _dataset_kwargs(compression: str | None) -> dict:
    """h5py create_dataset filter arguments for ``compression`` (None,
    "lzf" or "gzip" at level 1), as the writer child reads them."""
    if compression == "gzip":
        return {"compression": "gzip", "compression_opts": 1}
    if compression is not None:
        return {"compression": compression}
    return {}


class SpyralWriter:
    """Multi-file Spyral HDF5 writer in this process (writer.py:80-229).

    directory_path, config, max_events_per_file (default 5000),
    first_run_number; ``compression``: None (default, the reference's
    uncompressed layout), "lzf" or "gzip", an HDF5 filter that readers do
    not see.
    """

    def __init__(
        self,
        directory_path: Path | str,
        config: Config,
        max_events_per_file: int = 5_000,
        first_run_number: int = 0,
        compression: str | None = None,
    ):
        import h5py

        self._h5 = h5py
        self.directory_path = Path(directory_path)
        self.config = config
        self.response = np.asarray(get_response(config)).copy()
        self.max_events_per_file = max_events_per_file
        self._dset_kwargs = _dataset_kwargs(compression)
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
            f"cloud_{event_number}", data=spyral, **self._dset_kwargs
        )
        dset.attrs["orig_run"] = self.run_number
        dset.attrs["orig_event"] = event_number
        dset.attrs["ic_amplitude"] = -1.0
        dset.attrs["ic_multiplicity"] = -1.0
        dset.attrs["ic_integral"] = -1.0
        dset.attrs["ic_centroid"] = -1.0
        self.cloud_group.create_dataset(
            f"labels_{event_number}", data=labels, **self._dset_kwargs
        )
        self.last_event = event_number
        self.events_written += 1

    def write_spyral_batch(
        self,
        spyral: np.ndarray,
        labels: np.ndarray,
        counts: np.ndarray,
        event_numbers: np.ndarray,
        raw_counts: np.ndarray | None = None,
    ) -> None:
        """Write one batch of padded rows: spyral [E, C, 8] (each event's
        ``counts`` rows first), labels [E, C]; empty events as in
        ``write_spyral_pool``."""
        for i, event_number in enumerate(event_numbers):
            n = int(counts[i])
            if n == 0:
                if raw_counts is None or int(raw_counts[i]) == 0:
                    continue
                self._write_event(_EMPTY_SPYRAL, _EMPTY_LABELS,
                                  int(event_number))
                continue
            self._write_event(spyral[i, :n], labels[i, :n], int(event_number))

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

    def write(self, data: np.ndarray, labels: np.ndarray, config: Config,
              event_number: int) -> None:
        """The reference protocol's write of one event's raw [N, 3] =
        [pad, tb, electrons] cloud (writer.py:196-214): convert, threshold,
        z-sort, store."""
        spyral = convert_to_spyral(
            data,
            config.elec_params.windows_edge,
            config.elec_params.micromegas_edge,
            config.det_params.length,
            self.response,
            config.pad_centers,
            config.pad_sizes,
        )
        mask = spyral[:, 3] > config.elec_params.adc_threshold
        spyral = spyral[mask]
        labels = labels[mask]
        order = np.argsort(spyral[:, 2], kind="stable")
        self._write_event(spyral[order], labels[order], event_number)

    def set_number_of_events(self) -> None:
        self.cloud_group.attrs["min_event"] = self.starting_event
        self.cloud_group.attrs["max_event"] = self.last_event

    def get_directory_name(self) -> Path:
        return self.directory_path

    def close(self) -> None:
        self.set_number_of_events()
        self.file.close()


class SpyralWriterProc:
    """Spyral writer in child processes fed over POSIX shared memory
    (writer.py:232-551, less its recycle path): each child is the port's
    ``io/spyral_child.py``, launched by path, and it
    assembles, wiggles, z-sorts and writes each batch. Its files equal
    ``SpyralWriter``'s. ``run_simulation`` ships it the packed device rows
    through ``write_packed``.

    ``compression`` as ``SpyralWriter``'s; ``max_outstanding``: batches in
    flight to a child before the parent waits for an ack. With ``n_shards``
    > 1 there are that many children, child k owning every n_shards-th run
    file, fed by file so that each file still holds a contiguous range of
    written events. ``run_stride`` and ``owns_first_file`` are a child's
    share of that striping (set by the striped writer for its shards).
    """

    def __init__(
        self,
        directory_path: Path | str,
        config: Config,
        max_events_per_file: int = 5_000,
        first_run_number: int = 0,
        compression: str | None = None,
        max_outstanding: int = MAX_OUTSTANDING,
        n_shards: int = 1,
        run_stride: int = 1,
        owns_first_file: bool = True,
    ):
        self.directory_path = Path(directory_path)
        self.config = config
        self.max_events_per_file = max_events_per_file
        self._closed = False
        self._shards: list[SpyralWriterProc] | None = None
        if n_shards > 1:
            if run_stride != 1:
                raise ValueError("n_shards and run_stride are exclusive")
            self._shards = [
                SpyralWriterProc(
                    directory_path, config, max_events_per_file,
                    first_run_number + i, compression, max_outstanding,
                    run_stride=n_shards, owns_first_file=(i == 0),
                )
                for i in range(n_shards)
            ]
            self._written_total = 0
            return
        from ..native import hdf5_bundle, spyral_io_path

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
        # argv as spyral_child.main reads it
        self._proc = subprocess.Popen(
            [sys.executable, str(SPYRAL_CHILD), self._tables_path,
             str(self.directory_path), str(max_events_per_file),
             str(first_run_number), compression or "-", str(run_stride),
             "1" if owns_first_file else "0"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env,
        )
        self._max_outstanding = max_outstanding
        self._outstanding: list = []
        self._free: list = []

        # a parent that dies must not leak its /dev/shm segments
        def cleanup(pools=(self._outstanding, self._free)):
            for segs in pools:
                for shm in segs:
                    try:
                        shm.close()
                        shm.unlink()
                    except OSError:
                        pass
                segs.clear()

        self._cleanup = cleanup
        atexit.register(cleanup)

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
        """Ship one batch of packed [rows, 2] int32 rows to the child (or,
        striped, to the children owning its files), which draws the TB
        wiggle from ``wiggle_seed``; ``raw_counts`` as in
        ``SpyralWriter.write_spyral_pool``."""
        from multiprocessing import shared_memory

        if self._shards is not None:
            self._route_packed(packed, counts, event_numbers, raw_counts,
                               wiggle_seed)
            return
        if self._proc.poll() is not None:
            raise RuntimeError(
                f"spyral writer child exited early (rc={self._proc.returncode})"
            )
        while len(self._outstanding) >= self._max_outstanding:
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

    def _route_packed(self, packed, counts, event_numbers, raw_counts,
                      wiggle_seed) -> None:
        """Striped: split the batch at the written-event file boundaries
        and ship each piece to the shard owning that run file
        (writer.py:454-494). An event counts toward rotation if it has rows
        or a non-empty raw cloud, as in the child; the per-event TB wiggle
        makes the bytes independent of the split."""
        counts = np.asarray(counts, dtype=np.int64)
        raws = None if raw_counts is None else np.asarray(raw_counts,
                                                          dtype=np.int64)
        written = counts > 0
        if raws is not None:
            written |= raws > 0
        row_off = np.concatenate([[0], np.cumsum(counts)])
        n = len(counts)
        mepf = self.max_events_per_file
        i = 0
        while i < n:
            w_rest = written[i:]
            if not w_rest.any():
                break
            file_idx = self._written_total // mepf
            cap = mepf - (self._written_total % mepf)
            wcum = np.cumsum(w_rest)
            j = i + int(np.searchsorted(wcum, cap, side="right"))
            lo, hi = int(row_off[i]), int(row_off[j])
            self._shards[file_idx % len(self._shards)].write_packed(
                packed[lo:hi], counts[i:j], event_numbers[i:j],
                raw_counts=None if raws is None else raws[i:j],
                wiggle_seed=wiggle_seed,
            )
            self._written_total += int(wcum[j - i - 1])
            i = j

    def write_spyral_pool(self, spyral_pool, labels_pool, counts,
                          event_numbers, raw_counts=None) -> None:
        """Not taken: this writer consumes packed rows (``write_packed``)."""
        raise NotImplementedError(
            "SpyralWriterProc consumes packed rows via write_packed"
        )

    def get_directory_name(self) -> Path:
        return self.directory_path

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._shards is not None:
            errs = []
            for shard in self._shards:
                try:
                    shard.close()
                except Exception as exc:  # close every shard regardless
                    errs.append(exc)
            if errs:
                raise errs[0]
            return
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
            self._cleanup()
            atexit.unregister(self._cleanup)
            os.unlink(self._tables_path)
        if line.strip() != "done":
            raise RuntimeError(f"spyral writer child exited abnormally: {line!r}")
