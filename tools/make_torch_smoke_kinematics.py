"""Write the kinematics input of the PyTorch port's chip smoke run.

Samples the flagship reaction of bench.py (12C(d,p) at 120 MeV through D2
at 300 Torr, ground-state excitation, polar angle uniform in [0, pi]) with
the JAX package's ``run_kinematics_pipeline``: 1,536 events (four batches
of 384) at seed 1. The events are stored as a small .npz
(``attpc_engine_tpu_torch/data/smoke_kinematics.npz``: vertices [E, 3] f64,
momenta [E, 4, 4] f64, proton_numbers and mass_numbers [4]), so that
``chip_smoke.py``, which reads it, needs no h5py.

Run from the repository root: ``python tools/make_torch_smoke_kinematics.py``.
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax

jax.config.update("jax_platforms", "cpu")

import h5py
import numpy as np

from attpc_engine_tpu import nuclear_map
from attpc_engine_tpu.kinematics import (
    ExcitationGaussian,
    KinematicsPipeline,
    PolarUniform,
    Reaction,
    run_kinematics_pipeline,
)

N_EVENTS = 1536
SEED = 1
OUT = (Path(__file__).resolve().parents[1] / "attpc_engine_tpu_torch"
       / "data" / "smoke_kinematics.npz")


def main() -> None:
    pipeline = KinematicsPipeline(
        [
            Reaction(
                target=nuclear_map.get_data(1, 2),
                projectile=nuclear_map.get_data(6, 12),
                ejectile=nuclear_map.get_data(1, 1),
            )
        ],
        [ExcitationGaussian(0.0, 0.0)],
        [PolarUniform(0.0, np.pi)],
        120.0,
    )
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "kine.h5"
        run_kinematics_pipeline(pipeline, N_EVENTS, path, seed=SEED,
                                show_progress=False, use_mesh=False)
        with h5py.File(path, "r") as f:
            data = f["data"]
            arrays = {
                "vertices": np.asarray(data["vertices"], dtype=np.float64),
                "momenta": np.asarray(data["momenta"], dtype=np.float64),
                "proton_numbers": np.asarray(data.attrs["proton_numbers"]),
                "mass_numbers": np.asarray(data.attrs["mass_numbers"]),
            }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez(OUT, **arrays)
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
