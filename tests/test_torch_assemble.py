"""The Spyral assembly's plain version (``detector/assemble.py``) against
the JAX package, on the CPU, bit for bit.

The assembly turns a batch's packed rows into Spyral rows: each row's TB
wiggle from numpy's Philox4x64 keyed (seed, event id), each event's rows in
ascending z (``np.argsort(-(tb + wiggle), kind="stable")``) and the eight
f64 columns. What must hold, bit for bit:

- ``philox4x64_uniform`` equals ``Generator(Philox(key=[seed, ev]))
  .random(n)`` for row counts that are not multiples of 4, seeds past
  2^63 and event ids past 2^32;
- ``assemble_plain`` equals the JAX package's
  ``DetectorSimulator.assemble_spyral_ordered`` on both its paths (the C++
  library ``native/spyral_io.cpp`` and numpy), on the packed rows of a
  small batch of the JAX step and on synthetic rows with every edge case:
  empty and one-row events, equal-tb runs longer than 32, an event whose
  integer tbs are not descending, q = 0, q at both ends of the response
  table, tb 0 and 511, and a wiggle that rounds tb + w up to the next
  integer;
- one call over events [0, 384) equals the calls over [0, 100) and
  [100, 384);
- the port's ``DetectorSimulator.assemble_device`` on the CPU gives the
  same rows from its own tables.

The CUDA kernel (``csrc/assemble.cu``) is held to the plain version and to
the C++ library in tests/test_torch_cuda.py and chip_smoke.py.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import attpc_engine_tpu.detector.simulator as jsimulator
import attpc_engine_tpu.native as jnative
from __graft_entry__ import _tiny_setup
from attpc_engine_tpu.detector.simulator import DetectorSimulator as JaxSim
from attpc_engine_tpu.detector.simulator import EngineParams as JaxEngine
from attpc_engine_tpu_torch.detector import EngineParams
from attpc_engine_tpu_torch.detector.assemble import (
    AssembleTables,
    assemble_plain,
    philox4x64_uniform,
)
from attpc_engine_tpu_torch.detector.simulator import DetectorSimulator
from tests.assemble_cases import descending_event, edge_events, forged_tie, pool
from tests.test_torch_host import jax_config, torch_config

Z, A = np.array([1, 6, 1, 6]), np.array([2, 12, 1, 13])
E, T = 4, 500
ENGINE = dict(n_time_steps=T, chunk_steps=250, point_budget=1024,
              uniq_budget=12288, out_budget=8192, events_per_batch=E)
SEED = 7
BIG_SEED = 2**63 + 12345


def _bits(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x).view(np.int64)


@pytest.fixture(scope="module")
def jsim():
    return JaxSim(jax_config(), Z, A)


def _tables(sim) -> AssembleTables:
    return AssembleTables.from_numpy(sim._native_tables(), "cpu")


def _reference(sim, packed, counts, events, seed, path, monkeypatch):
    """The JAX package's host assembly on its C++ (``native``) or numpy
    path."""
    if path == "native":
        assert jnative.get_spyral_io_lib() is not None
    else:
        monkeypatch.setattr(jnative, "native_assemble_batch",
                            lambda *a, **k: None)
    return sim.assemble_spyral_ordered(packed, counts, np.asarray(events),
                                       seed)


def _plain(sim, packed, counts, events, seed, wiggle=None):
    spyral, labels = assemble_plain(
        torch.from_numpy(packed), torch.from_numpy(np.asarray(counts)),
        torch.from_numpy(np.asarray(events, np.int64)), seed, _tables(sim),
        wiggle=None if wiggle is None else torch.from_numpy(wiggle))
    return spyral.numpy(), labels.numpy()


def _assert_same(got, ref) -> None:
    (gs, gl), (rs, rl) = got, ref
    assert gs.shape == rs.shape and gs.dtype == rs.dtype == np.float64
    np.testing.assert_array_equal(_bits(gs), _bits(rs))
    np.testing.assert_array_equal(gl, rl)
    assert gl.dtype == rl.dtype == np.int64


# ----------------------------------------------------------------------- #
# the wiggle


@pytest.mark.parametrize("seed", [0, SEED, BIG_SEED, 2**64 - 1])
def test_wiggle_is_numpys_philox_stream(seed):
    """Row counts 0, 1, 3, 4, 5 and 1,023 (lanes of a last block dropped),
    event ids past 2^32, seeds past 2^63, all in one pooled call."""
    counts = np.array([0, 1, 3, 4, 5, 1023, 2])
    events = np.array([0, 1, 2**32 + 5, 2**40 + 3, 17, 2**33, 2**62],
                      dtype=np.int64)
    got = philox4x64_uniform(seed, torch.from_numpy(events),
                             torch.from_numpy(counts)).numpy()
    ref = jsimulator.wiggle_for_events(counts, events, seed)
    assert got.dtype == np.float64 and len(got) == counts.sum()
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    for n, ev, run in zip(counts, events,
                          np.split(got, np.cumsum(counts)[:-1])):
        key = np.array([seed, ev], dtype=np.uint64)
        gen = np.random.Generator(np.random.Philox(key=key))
        np.testing.assert_array_equal(_bits(run), _bits(gen.random(n)))


def test_wiggle_of_no_rows():
    got = philox4x64_uniform(SEED, torch.zeros(3, dtype=torch.int64),
                             torch.zeros(3, dtype=torch.int64))
    assert got.shape == (0,) and got.dtype == torch.float64


# ----------------------------------------------------------------------- #
# a batch of the JAX step


@pytest.fixture(scope="module")
def jax_batch():
    """The packed rows of one 4-event batch of the JAX step on the CPU, and
    the simulator that made them."""
    pipeline, tiny = _tiny_setup(events_per_batch=E, n_time_steps=T)
    vert, mom = (np.asarray(x) for x in
                 pipeline.run_batch(E, key=jax.random.PRNGKey(5)))
    sim = JaxSim(tiny.config, Z, A, engine=JaxEngine(**ENGINE))
    out = sim.simulate_batch(jax.random.PRNGKey(11), vert, mom,
                             assemble=False)
    counts = np.asarray(out["spyral_counts"])
    packed = np.array(out["packed"])[:counts.sum()]
    assert counts.sum() > 100
    return sim, packed, counts


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("seed", [SEED, BIG_SEED])
def test_plain_equals_jax_on_the_steps_rows(jax_batch, path, seed,
                                            monkeypatch):
    sim, packed, counts = jax_batch
    events = np.arange(10, 10 + E)
    ref = _reference(sim, packed, counts, events, seed, path, monkeypatch)
    _assert_same(_plain(sim, packed, counts, events, seed), ref)


def test_assemble_device_on_the_cpu_equals_jax(jax_batch, monkeypatch):
    """The port's simulator, from its own config, on the CPU: its tables
    equal the JAX simulator's, and so do its rows."""
    jsim_, packed, counts = jax_batch
    tsim = DetectorSimulator(torch_config(), Z, A,
                             engine=EngineParams(**ENGINE), device="cpu")
    jt, tt = jsim_._native_tables(), tsim._native_tables()
    assert jt.keys() == tt.keys()
    for k in jt:
        np.testing.assert_array_equal(np.asarray(jt[k]), np.asarray(tt[k]))
    events = np.arange(E)
    spyral, labels = tsim.assemble_device(torch.from_numpy(packed),
                                          torch.from_numpy(counts),
                                          events, SEED)
    assert spyral.device.type == "cpu"
    ref = _reference(jsim_, packed, counts, events, SEED, "native",
                     monkeypatch)
    _assert_same((spyral.numpy(), labels.numpy()), ref)


# ----------------------------------------------------------------------- #
# synthetic rows


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("seed", [0, BIG_SEED])
@pytest.mark.parametrize("first_event", [0, 2**32 + 9])
def test_plain_equals_jax_on_edge_cases(jsim, path, seed, first_event,
                                        monkeypatch):
    rng = np.random.default_rng(4)
    packed, counts = pool(edge_events(jsim._native_tables(), rng))
    events = np.arange(first_event, first_event + len(counts))
    ref = _reference(jsim, packed, counts, events, seed, path, monkeypatch)
    got = _plain(jsim, packed, counts, events, seed)
    _assert_same(got, ref)
    assert np.isfinite(got[0]).all()


def test_wiggle_rounding_up_to_the_next_tb(jsim, monkeypatch):
    """A wiggle of 1 - 2^-53 rounds tb + w up to tb + 1 (for tb >= 1),
    which ties a row of the next run up with wiggle 0: the stable order
    keeps the earlier row first, over the whole event. The wiggle is forged
    on both sides (the JAX package's numpy path draws it through
    ``wiggle_for_events``)."""
    packed, counts, wiggle, n = forged_tie()
    monkeypatch.setattr(jsimulator, "wiggle_for_events",
                        lambda counts, events, seed: wiggle.copy())
    ref = _reference(jsim, packed, counts, np.arange(2), SEED, "numpy",
                     monkeypatch)
    got = _plain(jsim, packed, counts, np.arange(2), SEED, wiggle=wiggle)
    _assert_same(got, ref)
    # event 0: row 0 at 9.5, row 2 (tb 7 rounded up) at 8.0, then the tie
    # at 7.0: row 1 (tb 7, w 0) before row 3 (tb 6 rounded up)
    order = got[0][:n, 5].astype(int) - 100
    assert order[:4].tolist() == [0, 2, 1, 3]


def test_one_call_equals_split_batches(jsim):
    """The rows do not depend on the batching: events [0, 384) in one call
    equal [0, 100) and [100, 384)."""
    rng = np.random.default_rng(9)
    events = [descending_event(rng, int(n))
              for n in rng.integers(0, 60, 384)]
    packed, counts = pool(events)
    whole = _plain(jsim, packed, counts, np.arange(384), SEED)
    cut = int(counts[:100].sum())
    parts = [_plain(jsim, packed[:cut], counts[:100], np.arange(100), SEED),
             _plain(jsim, packed[cut:], counts[100:], np.arange(100, 384),
                    SEED)]
    _assert_same(whole, tuple(np.concatenate([p[i] for p in parts])
                              for i in range(2)))


# ----------------------------------------------------------------------- #
# the port's io package


def test_io_reexports_the_kinematics_file_without_h5py():
    """``attpc_engine_tpu_torch.io`` re-exports KinematicsWriter and
    KinematicsReader, as the JAX package's io does, and imports with h5py
    blocked (the card's Python has none)."""
    code = ("import sys; sys.modules['h5py'] = None\n"
            "import attpc_engine_tpu_torch.io as io\n"
            "from attpc_engine_tpu_torch.io.kinematics_file import "
            "KinematicsReader, KinematicsWriter\n"
            "assert io.KinematicsWriter is KinematicsWriter\n"
            "assert io.KinematicsReader is KinematicsReader\n"
            "assert set(io.__all__) == {'KinematicsWriter', "
            "'KinematicsReader'}\n"
            "assert 'jax' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parents[1])
