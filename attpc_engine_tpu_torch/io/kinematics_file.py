# Copied from attpc_engine_tpu/io/kinematics_file.py; the port imports no jax, so it holds its own copy.
"""Kinematics HDF5 file writer/reader.

Two schemas are supported:

- ``"reference"``: bit-compatible with the reference engine's layout
  (upstream attpc_engine/kinematics/pipeline.py:449-493):
  ``/data`` attrs {n_events, proton_numbers, mass_numbers, chunk_size,
  n_chunks}; groups ``/data/chunk_k`` attrs {min_event, max_event}; one
  float64 ``[N, 4]`` dataset ``event_i`` per event with attrs
  vertex_x/y/z. Files written this way are readable by the reference
  detector stage and converter, and vice versa.

- ``"columnar"`` (default): batched layout for TPU-scale event counts —
  ``/data/vertices`` ``[n, 3]`` and ``/data/momenta`` ``[n, N, 4]``
  (float64, chunked, gzip-free for write speed), same ``/data`` attrs.
  Writing 1M events creates 2 datasets instead of 1M.

``KinematicsReader`` auto-detects the schema and yields event batches
either way.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["KinematicsWriter", "KinematicsReader", "CHUNK_SIZE"]

CHUNK_SIZE: int = 1_000_000


class KinematicsWriter:
    """Stream kinematics event batches to an HDF5 file."""

    def __init__(
        self,
        path: Path | str,
        n_events: int,
        proton_numbers: np.ndarray,
        mass_numbers: np.ndarray,
        schema: str = "columnar",
    ):
        if schema not in ("columnar", "reference"):
            raise ValueError(f"Unknown kinematics schema {schema!r}")
        self.path = Path(path)
        self.schema = schema
        self.n_events = n_events
        self.n_nuclei = len(proton_numbers)
        self._written = 0
        import h5py as h5  # imported on use: h5py is optional on the device host

        self._file = h5.File(self.path, "w")
        self._data = self._file.create_group("data")
        self._data.attrs["n_events"] = n_events
        self._data.attrs["proton_numbers"] = np.asarray(proton_numbers, dtype=np.int64)
        self._data.attrs["mass_numbers"] = np.asarray(mass_numbers, dtype=np.int64)
        self._data.attrs["chunk_size"] = CHUNK_SIZE

        if schema == "columnar":
            self._data.attrs["layout"] = "columnar-v1"
            self._vertices = self._data.create_dataset(
                "vertices", shape=(n_events, 3), dtype=np.float64
            )
            self._momenta = self._data.create_dataset(
                "momenta", shape=(n_events, self.n_nuclei, 4), dtype=np.float64
            )
            # columnar files are single-chunk by construction
            self._data.attrs["n_chunks"] = 1
        else:
            self._chunk = 0
            self._chunk_event = 0
            self._chunk_group = self._data.create_group("chunk_0")
            self._chunk_group.attrs["min_event"] = 0

    def write_batch(self, vertices: np.ndarray, momenta: np.ndarray) -> None:
        """Append a batch of events (vertices [b,3], momenta [b,N,4])."""
        b = len(vertices)
        if self._written + b > self.n_events:
            raise ValueError("Writing more events than declared n_events")
        if self.schema == "columnar":
            self._vertices[self._written : self._written + b] = vertices
            self._momenta[self._written : self._written + b] = momenta
            self._written += b
            return
        for i in range(b):
            event = self._written
            if self._chunk_event == CHUNK_SIZE:
                self._chunk_group.attrs["max_event"] = event - 1
                self._chunk_event = 0
                self._chunk += 1
                self._chunk_group = self._data.create_group(f"chunk_{self._chunk}")
                self._chunk_group.attrs["min_event"] = event
            dset = self._chunk_group.create_dataset(f"event_{event}", data=momenta[i])
            dset.attrs["vertex_x"] = vertices[i][0]
            dset.attrs["vertex_y"] = vertices[i][1]
            dset.attrs["vertex_z"] = vertices[i][2]
            self._chunk_event += 1
            self._written += 1

    def close(self) -> None:
        if self.schema == "reference":
            self._chunk_group.attrs["max_event"] = max(self._written - 1, 0)
            self._data.attrs["n_chunks"] = self._chunk + 1
        self._file.close()


class KinematicsReader:
    """Read kinematics files of either schema as event-index batches.

    Attributes
    ----------
    n_events: int
    proton_numbers, mass_numbers: np.ndarray [N]
    """

    def __init__(self, path: Path | str):
        self.path = Path(path)
        import h5py as h5  # imported on use: h5py is optional on the device host

        self._file = h5.File(self.path, "r")
        self._data = self._file["data"]
        self.n_events = int(self._data.attrs["n_events"])
        self.proton_numbers = np.asarray(self._data.attrs["proton_numbers"])
        self.mass_numbers = np.asarray(self._data.attrs["mass_numbers"])
        self.n_nuclei = len(self.proton_numbers)
        self.is_columnar = "vertices" in self._data
        if not self.is_columnar:
            self.chunk_size = int(self._data.attrs["chunk_size"])

    def read_range(self, start: int, stop: int) -> tuple[np.ndarray, np.ndarray]:
        """Read events [start, stop) -> (vertices [b,3], momenta [b,N,4])."""
        stop = min(stop, self.n_events)
        b = stop - start
        if self.is_columnar:
            return (
                self._data["vertices"][start:stop],
                self._data["momenta"][start:stop],
            )
        vertices = np.empty((b, 3), dtype=np.float64)
        momenta = np.empty((b, self.n_nuclei, 4), dtype=np.float64)
        for i, event in enumerate(range(start, stop)):
            chunk = event // self.chunk_size
            dset = self._data[f"chunk_{chunk}"][f"event_{event}"]
            momenta[i] = dset[:]
            vertices[i, 0] = dset.attrs["vertex_x"]
            vertices[i, 1] = dset.attrs["vertex_y"]
            vertices[i, 2] = dset.attrs["vertex_z"]
        return vertices, momenta

    def batches(self, batch_size: int):
        """Iterate (start_index, vertices, momenta) over the whole file."""
        for start in range(0, self.n_events, batch_size):
            vertices, momenta = self.read_range(start, start + batch_size)
            yield start, vertices, momenta

    def close(self) -> None:
        self._file.close()
