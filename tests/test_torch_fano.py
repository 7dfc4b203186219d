"""The step's Fano stage on the CPU: which version makes the electrons, the
``fano.draws`` counter, and what the Fano kernel's wrapper refuses.

``csrc/fano.cu`` runs only on the card (``tests/test_torch_cuda.py`` holds
it to its plain version there, bit for bit). Here:

- ``DetectorSimulator`` on the CPU takes the plain version,
  ``generate_electrons`` of ``fano_noise``'s draws or of the noise the
  caller gives, never the kernel, and counts the draws at site ``plain``;
- the wrapper refuses what the kernel cannot take before it loads the
  library.

This file imports nothing of JAX.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from attpc_engine_tpu_torch import nuclear_map
from attpc_engine_tpu_torch.detector import (
    Config,
    DetectorParams,
    DetectorSimulator,
    ElectronicsParams,
    EngineParams,
    PadParams,
    simulator,
)
from attpc_engine_tpu_torch.detector.deposition import fano_noise
from attpc_engine_tpu_torch.detector.fano_cuda import (
    fano_electrons_cuda,
    fano_words,
)
from attpc_engine_tpu_torch.nuclear import GasTarget
from attpc_engine_tpu_torch.utils import profiling

SMOKE = np.load(Path(__file__).resolve().parents[1] / "attpc_engine_tpu_torch"
                / "data" / "smoke_kinematics.npz")
W_VALUE, FANO = 34.0, 0.2


def _simulator(n_steps: int) -> DetectorSimulator:
    gas = GasTarget([(1, 2, 2)], 300.0, nuclear_map)
    config = Config(
        DetectorParams(1.0, 45000.0, 2.85, 175000, gas, 0.277, FANO,
                       W_VALUE),
        ElectronicsParams(6.25, 900, 1000, 10, 560, 40), PadParams())
    return DetectorSimulator(
        config, SMOKE["proton_numbers"], SMOKE["mass_numbers"],
        engine=EngineParams(n_time_steps=n_steps, chunk_steps=100,
                            events_per_batch=4),
        device="cpu")


@pytest.mark.parametrize("noise", ["drawn", "given"])
def test_the_cpu_takes_the_plain_fano_stage_and_counts_it(noise,
                                                          monkeypatch):
    """The plain version, fed ``fano_noise``'s draws (keyed by seed and
    global event id) or the caller's noise; the kernel never; the draws
    counted at "plain", steps x events x tracks."""
    n_steps, e, seed, start = 200, 3, 5, 7
    sim = _simulator(n_steps)
    k = sim.k_tracks
    given = (np.random.default_rng(3).standard_normal((n_steps, e * k))
             .astype(np.float32) if noise == "given" else None)
    seen = []
    real = simulator.generate_electrons

    def spy(dke, z, w_value, fano_factor):
        seen.append(z)
        return real(dke, z, w_value, fano_factor)

    def kernel(*args):
        raise AssertionError("the Fano kernel ran off the card")

    monkeypatch.setattr(simulator, "generate_electrons", spy)
    monkeypatch.setattr(simulator, "fano_electrons_cuda", kernel)
    rec = profiling.PhaseTimes()
    token = profiling.begin_run(rec)
    try:
        sim.simulate_batch(SMOKE["vertices"][:e], SMOKE["momenta"][:e],
                           seed=seed, event_start=start, noise=given,
                           assemble=False)
    finally:
        profiling.end_run(token)
    expect = (torch.from_numpy(given) if given is not None else
              fano_noise(seed, start, e, k, n_steps, 100, device="cpu"))
    assert len(seen) == 1 and torch.equal(seen[0], expect)
    assert rec.counters["fano.draws"] == {"plain": n_steps * e * k}


@pytest.mark.parametrize("case,reason", [
    ("on the cpu", "expected a CUDA tensor"),
    ("one axis", "expected dke"),
    ("no tracks", "must be positive"),
    ("no events", "must be positive"),
    ("no chunk", "must be positive"),
])
def test_the_fano_wrapper_refuses_what_the_kernel_cannot_take(case, reason):
    dke = torch.zeros((8, 6))
    kw = dict(words=torch.from_numpy(fano_words(1, 0)), n_events=3, tracks=2,
              chunk_steps=4, w_value=W_VALUE, fano_factor=FANO)
    if case == "one axis":
        dke = dke.reshape(-1)
    elif case == "no tracks":
        kw["tracks"] = 0
    elif case == "no events":
        kw["n_events"] = 0
    elif case == "no chunk":
        kw["chunk_steps"] = 0
    with pytest.raises(ValueError, match=reason):
        fano_electrons_cuda(dke, **kw)
