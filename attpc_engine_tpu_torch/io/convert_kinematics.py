# Copied from attpc_engine_tpu/io/convert_kinematics.py; the port imports no jax, so it holds its own copy.
"""Kinematics HDF5 -> parquet dataframe, run as
``python -m attpc_engine_tpu_torch.io.convert_kinematics in.h5 out.parquet``
(the ``convert-kinematics`` console script names the JAX package's copy).

Covers the reference's converter
(upstream attpc_engine/kinematics/convert_kinematics.py:11-75)
with the same output columns: one row per (event, nucleus) with Z, A,
isotope, energy, px, py, pz and the vertex. Reads both kinematics schemas
(columnar and reference) and writes parquet via pyarrow in vectorized
batches instead of a per-row Python loop.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .. import nuclear_map
from .kinematics_file import KinematicsReader

__all__ = ["convert_kinematics_hdf5_to_parquet", "main"]


def convert_kinematics_hdf5_to_parquet(
    input_path: Path | str,
    output_path: Path | str,
    batch_size: int = 65536,
) -> None:
    input_path = Path(input_path)
    if not input_path.exists():
        raise Exception(f"Input path {input_path} does not exist!")
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as err:
        raise RuntimeError(
            "convert-kinematics requires pyarrow (pip install pyarrow)"
        ) from err

    reader = KinematicsReader(input_path)
    n_nuclei = reader.n_nuclei
    isotopes = [
        nuclear_map.get_data(
            int(reader.proton_numbers[i]), int(reader.mass_numbers[i])
        ).isotopic_symbol
        for i in range(n_nuclei)
    ]

    schema = pa.schema(
        [
            ("event", pa.int64()),
            ("Z", pa.int64()),
            ("A", pa.int64()),
            ("isotope", pa.string()),
            ("energy", pa.float64()),
            ("px", pa.float64()),
            ("py", pa.float64()),
            ("pz", pa.float64()),
            ("vertex_x", pa.float64()),
            ("vertex_y", pa.float64()),
            ("vertex_z", pa.float64()),
        ]
    )
    writer = pq.ParquetWriter(str(output_path), schema)
    try:
        for start, vertices, momenta in reader.batches(batch_size):
            b = len(vertices)
            events = np.repeat(np.arange(start, start + b, dtype=np.int64), n_nuclei)
            z = np.tile(reader.proton_numbers.astype(np.int64), b)
            a = np.tile(reader.mass_numbers.astype(np.int64), b)
            iso = np.tile(np.array(isotopes, dtype=object), b)
            flat = momenta.reshape(b * n_nuclei, 4)
            vx = np.repeat(vertices[:, 0], n_nuclei)
            vy = np.repeat(vertices[:, 1], n_nuclei)
            vz = np.repeat(vertices[:, 2], n_nuclei)
            table = pa.table(
                {
                    "event": events,
                    "Z": z,
                    "A": a,
                    "isotope": iso.astype(str),
                    "energy": flat[:, 3],
                    "px": flat[:, 0],
                    "py": flat[:, 1],
                    "pz": flat[:, 2],
                    "vertex_x": vx,
                    "vertex_y": vy,
                    "vertex_z": vz,
                },
                schema=schema,
            )
            writer.write_table(table)
    finally:
        writer.close()
        reader.close()


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Convert the simulation kinematics HDF5 data to a dataframe"
    )
    parser.add_argument("input", type=Path, help="The simulation HDF5 data")
    parser.add_argument(
        "output", type=Path, help="The output dataframe file path (parquet)"
    )
    args = parser.parse_args()
    convert_kinematics_hdf5_to_parquet(args.input, args.output)


if __name__ == "__main__":
    main()
