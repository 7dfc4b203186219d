"""The port's entry points run on the card unless the caller asks for the
CPU, and its engine knobs take only the values they name.

``DetectorSimulator``, ``run_simulation``, ``fano_noise``,
``run_simulation_multihost`` (on ``cuda:{LOCAL_RANK}``) and the
kinematics entry points (``KinematicsPipeline``, ``run_kinematics_pipeline``,
``run_kinematics``, ``Reaction.calculate``) default to ``device="cuda"``. Where torch finds no CUDA device they raise before any
work; nothing falls back to the CPU. With ``device="cpu"`` they run the
plain PyTorch versions. The checks that need the absence of a card skip
where there is one.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from attpc_engine_tpu_torch.detector import (
    DetectorSimulator,
    EngineParams,
    SpyralWriter,
    run_simulation,
)
from attpc_engine_tpu_torch.detector.deposition import fano_noise
from tests.test_torch_host import torch_config

Z, A = np.array([1, 6, 1, 6]), np.array([2, 12, 1, 13])
SMALL = dict(n_time_steps=50, chunk_steps=50, point_budget=64,
             events_per_batch=2)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")


@pytest.fixture(scope="module")
def kine_file(tmp_path_factory):
    from attpc_engine_tpu_torch.io.kinematics_file import KinematicsWriter

    data = np.load(Path(__file__).resolve().parents[1]
                   / "attpc_engine_tpu_torch" / "data"
                   / "smoke_kinematics.npz")
    path = tmp_path_factory.mktemp("kine") / "k.h5"
    w = KinematicsWriter(path, 2, Z, A)
    w.write_batch(data["vertices"][:2], data["momenta"][:2])
    w.close()
    return path


def test_simulator_defaults_to_the_card_and_raises_without_one(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectorSimulator(torch_config(), Z, A,
                          engine=EngineParams(**SMALL))
    sim = DetectorSimulator(torch_config(), Z, A,
                            engine=EngineParams(**SMALL), device="cpu")
    assert sim.device == torch.device("cpu")
    assert sim.pad_table.device == torch.device("cpu")


def test_run_simulation_defaults_to_the_card_and_raises_without_one(
        no_card, kine_file, tmp_path):
    class Writer:
        closed = False

        def close(self):
            self.closed = True

    writer = Writer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_simulation(torch_config(), kine_file, writer,
                       engine=EngineParams(**SMALL), seed=1)
    assert writer.closed  # the caller's writer is closed on the error
    config = torch_config()
    stats = run_simulation(config, kine_file, SpyralWriter(tmp_path, config),
                           engine=EngineParams(**SMALL), seed=1,
                           device="cpu")
    assert stats["events"] == 2


def test_run_simulation_multihost_defaults_to_the_card(no_card, kine_file,
                                                      tmp_path, monkeypatch):
    """The device defaults to cuda:{LOCAL_RANK} and raises without a card,
    before any file is touched; device="cpu" runs the slice."""
    from attpc_engine_tpu_torch.parallel import run_simulation_multihost

    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    kw = dict(seed=1, engine=EngineParams(**SMALL))
    with pytest.raises(RuntimeError, match="'cuda:1'.*device='cpu'"):
        run_simulation_multihost(torch_config(), kine_file, tmp_path, **kw)
    assert list(tmp_path.iterdir()) == []
    assert run_simulation_multihost(torch_config(), kine_file, tmp_path,
                                    device="cpu", **kw) == (0, 2)
    assert (tmp_path / "run_0000.h5").exists()


def test_fano_noise_defaults_to_the_card(no_card):
    kw = dict(seed=1, event_start=0, n_events=2, tracks=2, n_steps=8,
              chunk_steps=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fano_noise(**kw)
    assert fano_noise(device="cpu", **kw).shape == (8, 4)


def _kinematics_pipeline(**kw):
    from attpc_engine_tpu_torch import nuclear_map
    from attpc_engine_tpu_torch.kinematics import (
        ExcitationGaussian,
        KinematicsPipeline,
        PolarUniform,
        Reaction,
    )

    d = nuclear_map.get_data
    return KinematicsPipeline([Reaction(d(1, 2), d(6, 12), d(1, 1))],
                              [ExcitationGaussian(0.0, 0.0)],
                              [PolarUniform(0.0, np.pi)], 120.0, **kw)


class _KinematicsWriter:
    def __init__(self):
        self.events, self.closed = 0, False

    def write_batch(self, vertices, momenta):
        self.events += len(vertices)

    def close(self):
        self.closed = True


def test_kinematics_pipeline_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _kinematics_pipeline()
    pipe = _kinematics_pipeline(device="cpu")
    assert pipe.device == torch.device("cpu")
    vertex, momenta = pipe.run(seed=1)
    assert vertex.shape == (3,) and momenta.shape == (4, 4)


def test_run_kinematics_pipeline_defaults_to_the_card(no_card, tmp_path):
    from attpc_engine_tpu_torch.kinematics import run_kinematics_pipeline

    pipe = _kinematics_pipeline(device="cpu")
    path = tmp_path / "k.h5"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_kinematics_pipeline(pipe, 4, path, seed=1, show_progress=False)
    assert not path.exists()  # raised before any file was written
    run_kinematics_pipeline(pipe, 4, path, seed=1, show_progress=False,
                            device="cpu")
    assert path.exists()


def test_run_kinematics_defaults_to_the_card(no_card):
    from attpc_engine_tpu_torch.kinematics import run_kinematics

    pipe = _kinematics_pipeline(device="cpu")
    writer = _KinematicsWriter()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_kinematics(pipe, 4, writer, seed=1, show_progress=False)
    assert writer.closed and writer.events == 0
    writer = _KinematicsWriter()
    stats = run_kinematics(pipe, 4, writer, seed=1, show_progress=False,
                           device="cpu")
    assert writer.closed and writer.events == stats["events"] == 4


def test_reaction_calculate_defaults_to_the_card(no_card):
    from attpc_engine_tpu_torch import nuclear_map
    from attpc_engine_tpu_torch.kinematics import Decay, Reaction

    d = nuclear_map.get_data
    rxn = Reaction(d(6, 12), d(1, 2), d(1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rxn.calculate(16.0, 0.3, 0.0, 0.0)
    vectors = rxn.calculate(16.0, 0.3, 0.0, 0.0, device="cpu")
    decay = Decay(d(6, 13), d(1, 1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        decay.calculate(vectors[3], 0.3, 0.0, 0.0)
    assert len(vectors) == 4


@pytest.mark.parametrize("knob,value", [
    ("merge", "Fused"), ("merge", "fused_transpose"), ("merge", True),
    ("lookup", "two-stage"), ("lookup", "auto"), ("lookup", False),
])
def test_engine_params_reject_unknown_knob_values(knob, value):
    with pytest.raises(ValueError, match=knob):
        EngineParams(**{knob: value})


def test_engine_params_accept_both_configurations():
    assert EngineParams().merge == "sorts"
    assert EngineParams().lookup == "two_stage"
    e = EngineParams(merge="fused", lookup="one_stage")
    assert (e.merge, e.lookup) == ("fused", "one_stage")
