"""The kinematics a cell feeds the detector stage, made from ``--seed`` by
the benchmark's frozen copy of the port's kinematics pipeline
(``benchref.kinematics``): the same seed gives the same events, and both
the port and the reference are handed them."""

from __future__ import annotations

import numpy as np
import torch

from benchref import nuclear_map
from benchref.kinematics.angle import PolarUniform
from benchref.kinematics.excitation import ExcitationGaussian, ExcitationUniform
from benchref.kinematics.pipeline import (
    KinematicsPipeline,
    KinematicsTargetMaterial,
)
from benchref.kinematics.reaction import Decay, Reaction
from benchref.nuclear import GasTarget

SAMPLE_BATCH = 65536  # events sampled on the device at once


def _excitation(spec: dict):
    if spec["kind"] == "gaussian":
        return ExcitationGaussian(spec["centroid"], spec["width"])
    if spec["kind"] == "uniform":
        return ExcitationUniform(spec["min"], spec["max"])
    raise ValueError(f"excitation kind {spec['kind']!r}")


def _polar(spec: dict):
    if spec["kind"] == "uniform":
        return PolarUniform(spec["min"], spec["max"])
    raise ValueError(f"polar kind {spec['kind']!r}")


def pipeline(cfg: dict, device) -> KinematicsPipeline:
    """The frozen pipeline of a configuration's ``kinematics``; its target
    material is the detector's gas."""
    kin, det = cfg["kinematics"], cfg["detector"]
    nucleus = lambda za: nuclear_map.get_data(*za)  # noqa: E731
    steps = []
    for step in kin["steps"]:
        if "reaction" in step:
            r = step["reaction"]
            steps.append(Reaction(nucleus(r["target"]), nucleus(r["projectile"]),
                                  nucleus(r["ejectile"])))
        else:
            d = step["decay"]
            steps.append(Decay(nucleus(d["parent"]), nucleus(d["residual_1"])))
    material = None
    if kin.get("target_material") is not None:
        tm = kin["target_material"]
        gas = GasTarget([tuple(c) for c in det["gas_components"]],
                        float(det["gas_pressure_torr"]), nuclear_map)
        material = KinematicsTargetMaterial(gas, tuple(tm["z_range"]),
                                            tm["rho_sigma"])
    return KinematicsPipeline(
        steps, [_excitation(s["excitation"]) for s in kin["steps"]],
        [_polar(s["polar"]) for s in kin["steps"]], kin["beam_energy"],
        target_material=material, device=device)


class Events:
    """Events [0, n) of ``seed``: host f64 ``vertices`` [n, 3] and
    ``momenta`` [n, N, 4], and the nuclei of the rows."""

    def __init__(self, cfg: dict, n: int, seed: int, device):
        pipe = pipeline(cfg, device)
        self.proton_numbers = pipe.get_proton_numbers()
        self.mass_numbers = pipe.get_mass_numbers()
        vs, ms = [], []
        for start in range(0, n, SAMPLE_BATCH):
            batch = pipe.sample_events(min(SAMPLE_BATCH, n - start), seed,
                                       start, device=device)
            if not bool(batch.accepted.all()):
                raise RuntimeError("kinematics: events not accepted within "
                                   "the sample limit")
            vs.append(batch.vertices.cpu().numpy())
            ms.append(batch.momenta.cpu().numpy())
        self.vertices = np.concatenate(vs)
        self.momenta = np.concatenate(ms)
        del batch
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


class ArrayReader:
    """Events held in host arrays as a reader for the port's ``run_reader``
    (the card's Python has no h5py to read a kinematics file). ``on_read``,
    if given, is called with each range's start before it is read."""

    def __init__(self, events: Events, n: int, on_read=None):
        self.events, self.n_events = events, n
        self.proton_numbers = events.proton_numbers
        self.mass_numbers = events.mass_numbers
        self.on_read = on_read

    def read_range(self, start: int, stop: int):
        if self.on_read is not None:
            self.on_read(start)
        return (self.events.vertices[start:stop],
                self.events.momenta[start:stop])

    def close(self) -> None:
        pass
