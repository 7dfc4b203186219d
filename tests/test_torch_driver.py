"""The port's driver, ``run_simulation`` and its batch loop ``run_reader``,
against the JAX driver and against itself, on the CPU.

The events are the committed flagship kinematics (12C(d,p) at 120 MeV,
``attpc_engine_tpu_torch/data/smoke_kinematics.npz``), whose tracks live
~330 steps: a 250-step probe climbs the "steps" ladder to 1,000 steps,
and the tuned window is 500. What must hold:

- a tuned run writes the untuned run's Spyral files bit for bit (every
  draw is keyed by the event and by the chunk, and padding lanes add
  nothing), also off the batch grid, on a short tail batch and for the
  decay chain 10B(3He,a)9B* -> a + 5Li -> a + p;
- the tuned point and steps budgets equal the JAX driver's on the same
  file (both come from transport alone); uniq and out follow the JAX rule
  on the port's own first-batch metadata;
- the writer thread keeps batches in order, raises the writer's first
  exception on the caller's thread and writes nothing after it;
- the reference-protocol path hands each event its merged cloud, also
  after a "cloud" overflow retry;
- the writers' compression and striping leave the files' values alone.

The loop on the card is held by tests/test_torch_cuda.py::
test_run_reader_on_the_card (that file runs where jax and h5py do not).
"""

import dataclasses
import glob
import json
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from attpc_engine_tpu_torch.detector import (
    DetectorSimulator,
    EngineParams,
    SpyralWriter,
    SpyralWriterProc,
    run_simulation,
    simulate,
)
from attpc_engine_tpu_torch.detector import simulator as tsimulator
from attpc_engine_tpu_torch.io.kinematics_file import KinematicsWriter
from tests.test_torch_host import DET, ELEC, torch_config

REPO = Path(__file__).resolve().parents[1]
SMOKE = np.load(REPO / "attpc_engine_tpu_torch" / "data"
                / "smoke_kinematics.npz")
Z, A = SMOKE["proton_numbers"], SMOKE["mass_numbers"]
N_EVENTS = 8
SEED = 2


def _engine(**kw) -> EngineParams:
    base = dict(n_time_steps=1000, chunk_steps=250, events_per_batch=4)
    return EngineParams(**{**base, **kw})


@pytest.fixture(scope="module")
def kine(tmp_path_factory):
    """The first 8 committed events in a kinematics file."""
    path = tmp_path_factory.mktemp("kine") / "k.h5"
    w = KinematicsWriter(path, N_EVENTS, Z, A)
    w.write_batch(SMOKE["vertices"][:N_EVENTS], SMOKE["momenta"][:N_EVENTS])
    w.close()
    return path


def _run(kine, outdir: Path, writer_cls=SpyralWriter, engine=None,
         writer_kw=None, **kw) -> dict:
    outdir.mkdir()
    config = torch_config()
    return run_simulation(config, kine,
                          writer_cls(outdir, config, **(writer_kw or {})),
                          engine=engine or _engine(), seed=SEED,
                          show_progress=False, device="cpu", **kw)


def _read(outdir: Path) -> dict:
    """{file name: {"attrs": group attrs, dataset: (values, attrs)}}."""
    files = {}
    for path in sorted(glob.glob(str(outdir / "run_*.h5"))):
        with h5py.File(path, "r") as f:
            g = f["cloud"]
            d = {"attrs": dict(g.attrs)}
            for name in g:
                d[name] = (g[name][()], dict(g[name].attrs))
            files[Path(path).name] = d
    return files


def _assert_same_files(a: dict, b: dict) -> None:
    assert a.keys() == b.keys() and a
    for fname in a:
        assert a[fname].keys() == b[fname].keys(), fname
        assert a[fname]["attrs"] == b[fname]["attrs"], fname
        for name in a[fname]:
            if name == "attrs":
                continue
            va, aa = a[fname][name]
            vb, ab = b[fname][name]
            assert va.dtype == vb.dtype and aa == ab, name
            np.testing.assert_array_equal(va, vb, err_msg=name)


def _events(files: dict) -> dict:
    """{event: (cloud, labels)} over all files."""
    out = {}
    for d in files.values():
        for name, (values, _) in d.items():
            if name.startswith("cloud_"):
                ev = int(name.split("_")[1])
                out[ev] = (values, d[f"labels_{ev}"][0])
    return out


def _manifest(outdir: Path) -> dict:
    (path,) = glob.glob(str(outdir / "run_manifest_*.json"))
    with open(path) as f:
        return json.load(f)


# ----------------------------------------------------------------------- #
# auto-tuning


@pytest.mark.parametrize("chunk_steps", [250, 500],
                         ids=["steps_ladder", "probe_fits"])
def test_tuned_run_writes_the_untuned_files(kine, tmp_path, chunk_steps):
    """auto_tune=True writes the files of auto_tune=False bit for bit. At
    chunk_steps=250 the probe's tracks outlive it: the first batch climbs
    to the 1,000-step window before the budgets are retightened."""
    engine = _engine(chunk_steps=chunk_steps)
    tuned = _run(kine, tmp_path / "tuned", engine=engine)
    pinned = _run(kine, tmp_path / "pinned", engine=engine, auto_tune=False)
    assert tuned["events"] == pinned["events"] == N_EVENTS
    assert tuned["rows"] == pinned["rows"] > 0
    assert tuned["budgets"]["steps"] == 500
    assert pinned["budgets"]["steps"] == 1000
    for k in ("point", "out"):
        assert tuned["budgets"][k] < pinned["budgets"][k], k
    _assert_same_files(_read(tmp_path / "tuned"), _read(tmp_path / "pinned"))
    assert _manifest(tmp_path / "tuned")["budgets"] == tuned["budgets"]


def _jax_rule(meta: np.ndarray, n: int, eb: int, engine: EngineParams,
              pinned_steps: int) -> dict:
    """The JAX driver's retightening (simulator.py:1415-1430) of one
    batch's meta_i32 in the port's layout (stride n)."""
    r = tsimulator._round_up
    return {
        "point": min(engine.point_budget, r(meta[n:2 * n].max() * 1.3, 64)),
        "uniq": min(engine.uniq_budget, r(meta[-1] * 1.3, 1024)),
        "out": min(engine.out_budget, r(meta[:n].sum() / eb * 1.3, 1024)),
        "steps": min(r(meta[-2] * 1.3, engine.chunk_steps), pinned_steps),
    }


@pytest.mark.parametrize("stop_event", [None, 3], ids=["two_batches",
                                                       "short_first_batch"])
def test_tuned_budgets_follow_the_jax_driver(kine, tmp_path, stop_event):
    """The port's final budgets against the JAX run_simulation's manifest
    on the same file: point and steps equal; uniq and out equal the JAX
    rule on the port's own first batch (for a short first batch too: out
    divides the kept rows by events_per_batch, as the JAX driver does)."""
    from attpc_engine_tpu.detector import EngineParams as JaxEngine
    from attpc_engine_tpu.detector import SpyralWriter as JaxWriter
    from attpc_engine_tpu.detector import run_simulation as jax_run
    from tests.test_torch_host import jax_config

    engine = _engine()
    stats = _run(kine, tmp_path / "port", engine=engine,
                 stop_event=stop_event)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jcfg = jax_config()
    jax_run(jcfg, kine, JaxWriter(jdir, jcfg),
            engine=JaxEngine(**{f.name: getattr(engine, f.name)
                                for f in dataclasses.fields(engine)
                                if f.name not in ("merge", "lookup")}),
            seed=SEED, show_progress=False, stop_event=stop_event,
            use_mesh=False)
    jb = _manifest(jdir)["budgets"]
    assert {k: stats["budgets"][k] for k in ("point", "steps")} == {
        k: jb[k] for k in ("point", "steps")}

    n = min(stop_event or 4, 4)
    sim = DetectorSimulator(torch_config(), Z, A, engine=engine, device="cpu")
    meta = sim.simulate_batch(SMOKE["vertices"][:n], SMOKE["momenta"][:n],
                              seed=SEED, assemble=False)["meta_i32"].numpy()
    rule = _jax_rule(meta, n, engine.events_per_batch, engine, 1000)
    assert rule["steps"] == 500 and rule["point"] < engine.point_budget
    assert {k: stats["budgets"][k] for k in rule} == rule
    assert stats["budgets"]["cloud"] == jb["cloud"] == engine.cloud_cap


def test_resume_off_the_grid_reproduces_one_shot(kine, tmp_path):
    """A run resumed at event 3 (not on the 4-event grid), tuned anew from
    its own first batch, writes events 3-7 as the one-shot run did."""
    _run(kine, tmp_path / "full")
    _run(kine, tmp_path / "part", start_event=3,
         writer_kw={"first_run_number": 1})
    full, part = _events(_read(tmp_path / "full")), _events(
        _read(tmp_path / "part"))
    assert set(part) == {e for e in full if e >= 3} and len(part) >= 4
    for ev, (cloud, labels) in part.items():
        np.testing.assert_array_equal(cloud, full[ev][0], err_msg=str(ev))
        np.testing.assert_array_equal(labels, full[ev][1], err_msg=str(ev))


def test_tail_batch_matches_full_batch(kine, tmp_path):
    """stop_event=6 leaves a 2-event tail batch; its events equal the same
    events run in a full batch."""
    stats = _run(kine, tmp_path / "tail", stop_event=6)
    assert stats["events"] == 6
    _run(kine, tmp_path / "full")
    tail = _events(_read(tmp_path / "tail"))
    full = _events(_read(tmp_path / "full"))
    assert {4, 5} <= set(tail) and set(tail) == {e for e in full if e < 6}
    for ev in tail:
        np.testing.assert_array_equal(tail[ev][0], full[ev][0])
        np.testing.assert_array_equal(tail[ev][1], full[ev][1])


# ----------------------------------------------------------------------- #
# the writer thread


class _PoolWriter:
    """An in-memory write_spyral_pool writer; raises ``fail`` on its
    ``fail_on``-th batch."""

    def __init__(self, fail_on: int | None = None):
        self.batches = []
        self.closed = False
        self.fail_on = fail_on

    def write_spyral_pool(self, spyral, labels, counts, event_numbers,
                          raw_counts=None):
        if len(self.batches) + 1 == self.fail_on:
            self.batches.append(None)
            raise _WriterFault("disk full")
        self.batches.append((spyral.copy(), labels.copy(), counts.copy(),
                             np.asarray(event_numbers).copy()))

    def close(self):
        self.closed = True


class _WriterFault(OSError):
    pass


def test_writer_thread_keeps_batch_order(kine):
    writer = _PoolWriter()
    stats = run_simulation(torch_config(), kine, writer,
                           engine=_engine(events_per_batch=2), seed=SEED,
                           show_progress=False, device="cpu")
    assert writer.closed and stats["events"] == N_EVENTS
    events = np.concatenate([b[3] for b in writer.batches])
    np.testing.assert_array_equal(events, np.arange(N_EVENTS))
    assert [len(b[3]) for b in writer.batches] == [2, 2, 2, 2]
    assert sum(len(b[0]) for b in writer.batches) == stats["rows"]


def test_writer_exception_reaches_the_caller(kine):
    """A writer that raises on its second batch: run_simulation raises
    that exception, closes the writer, and writes no later batch."""
    writer = _PoolWriter(fail_on=2)
    with pytest.raises(_WriterFault, match="disk full"):
        run_simulation(torch_config(), kine, writer,
                       engine=_engine(events_per_batch=2), seed=SEED,
                       show_progress=False, device="cpu")
    assert writer.closed
    assert len(writer.batches) == 2 and writer.batches[1] is None


# ----------------------------------------------------------------------- #
# the reference-protocol writer path


class _ProtocolWriter:
    """A SimulationWriter: write(), get_directory_name(), close()."""

    def __init__(self, directory):
        self.directory = directory
        self.events = {}
        self.closed = False

    def write(self, data, labels, config, event_number):
        self.events[event_number] = (data.copy(), labels.copy())

    def get_directory_name(self):
        return self.directory

    def close(self):
        self.closed = True


@pytest.mark.parametrize("cloud_cap", [12288, 2048],
                         ids=["cloud_cap_12288", "cloud_cap_2048_retried"])
def test_protocol_writer_gets_each_events_merged_cloud(kine, tmp_path,
                                                       cloud_cap):
    """Each event's [pad, tb, electrons] rows and labels equal
    simulate_batch's merged cloud of that event (compact=True); a
    cloud_cap below the events' merged counts retries and then matches."""
    writer = _ProtocolWriter(tmp_path)
    engine = _engine(cloud_cap=cloud_cap)
    stats = run_simulation(torch_config(), kine, writer, engine=engine,
                           seed=SEED, show_progress=False, device="cpu")
    assert writer.closed and len(writer.events) == N_EVENTS
    if cloud_cap == 2048:
        assert stats["budgets"]["cloud"] > 2048
    sim = DetectorSimulator(torch_config(), Z, A, engine=_engine(),
                            device="cpu")
    for start in (0, 4):
        out = sim.simulate_batch(SMOKE["vertices"][start:start + 4],
                                 SMOKE["momenta"][start:start + 4],
                                 seed=SEED, event_start=start,
                                 assemble=False, compact=True)
        assert int(out["cloud_overflow"]) == 0
        offsets = np.concatenate([[0], np.cumsum(out["counts"].numpy())])
        for i in range(4):
            lo, hi = offsets[i], offsets[i + 1]
            ref = torch.stack([out[k][lo:hi].double() for k in
                               ("pads", "tbs", "charges")], dim=-1).numpy()
            data, labels = writer.events[start + i]
            np.testing.assert_array_equal(data, ref)
            np.testing.assert_array_equal(labels,
                                          out["labels"][lo:hi].numpy())
            assert ((data[:, 1] >= np.floor(data[:, 1]))
                    & (data[:, 1] < np.floor(data[:, 1]) + 1)).all()
    assert _manifest(tmp_path)["budgets"]["cloud"] == stats["budgets"]["cloud"]


def test_spyral_writer_write_protocol(tmp_path):
    """SpyralWriter.write (the reference protocol) thresholds, z-sorts and
    stores one event's raw cloud as convert_to_spyral computes it."""
    from attpc_engine_tpu_torch.detector import (
        convert_to_spyral,
        get_response,
    )

    config = torch_config()
    rng = np.random.default_rng(3)
    # electrons around the ADC threshold
    q_thr = config.elec_params.adc_threshold / np.max(get_response(config))
    data = np.stack([rng.integers(0, 10240, 50).astype(np.float64),
                     rng.uniform(0, 511, 50), rng.uniform(0, 2 * q_thr, 50)],
                    -1)
    labels = rng.integers(2, 4, 50)
    w = SpyralWriter(tmp_path, config)
    w.write(data, labels, config, 7)
    w.close()
    spyral = convert_to_spyral(
        data, config.elec_params.windows_edge,
        config.elec_params.micromegas_edge, config.det_params.length,
        w.response, config.pad_centers, config.pad_sizes)
    keep = spyral[:, 3] > config.elec_params.adc_threshold
    order = np.argsort(spyral[keep][:, 2], kind="stable")
    got = _read(tmp_path)["run_0000.h5"]
    np.testing.assert_array_equal(got["cloud_7"][0], spyral[keep][order])
    np.testing.assert_array_equal(got["labels_7"][0], labels[keep][order])
    assert 0 < keep.sum() < 50


def test_host_copies_take_a_free_buffer_by_position():
    """The pinned-copy pool hands out the first free buffer that is large
    enough and takes it out of the list by position: with buffers of two
    sizes free, taking the second once raised in ``list.remove``, which
    compares tensors elementwise (a driver run on the card of 16 batches
    crashed so)."""
    copies = tsimulator._HostCopies(torch.device("cpu"))
    small, large, other = (torch.zeros(65536, 2), torch.zeros(131072, 2),
                           torch.zeros(65536, 2))
    copies.free = [small, large, other]
    assert copies.take_free(70_000) is large
    assert [id(b) for b in copies.free] == [id(small), id(other)]
    assert copies.take_free(10) is small
    assert copies.take_free(200_000) is None
    assert len(copies.free) == 1 and copies.free[0] is other


# ----------------------------------------------------------------------- #
# the writers' compression and striping


@pytest.fixture(scope="module")
def batch():
    """One 8-event batch's packed rows and their host assembly."""
    sim = DetectorSimulator(torch_config(), Z, A, engine=_engine(),
                            device="cpu")
    out = sim.simulate_batch(SMOKE["vertices"][:N_EVENTS],
                             SMOKE["momenta"][:N_EVENTS], seed=SEED,
                             assemble=False)
    meta = out["meta_i32"].numpy()
    counts = meta[:N_EVENTS]
    packed = out["packed"][:counts.sum()].numpy()
    raw = meta[2 * N_EVENTS:3 * N_EVENTS]
    spyral, labels = sim.assemble_spyral_ordered(
        packed, counts, np.arange(N_EVENTS), SEED)
    return packed, counts, raw, spyral, labels


def _write(writer, batch, n_batches: int = 2) -> None:
    packed, counts, raw, spyral, labels = batch
    rows = np.concatenate([[0], np.cumsum(counts)])
    step = N_EVENTS // n_batches
    for b in range(n_batches):
        lo, hi = b * step, (b + 1) * step
        ev = np.arange(lo, hi)
        if isinstance(writer, SpyralWriterProc):
            writer.write_packed(packed[rows[lo]:rows[hi]], counts[lo:hi], ev,
                                raw_counts=raw[lo:hi], wiggle_seed=SEED)
        else:
            writer.write_spyral_pool(spyral[rows[lo]:rows[hi]],
                                     labels[rows[lo]:rows[hi]],
                                     counts[lo:hi], ev, raw_counts=raw[lo:hi])
    writer.close()


@pytest.mark.parametrize("writer_cls", [SpyralWriter, SpyralWriterProc])
@pytest.mark.parametrize("compression", ["lzf", "gzip"])
def test_compressed_files_read_back_equal(batch, tmp_path, writer_cls,
                                          compression):
    config = torch_config()
    for comp in (None, compression):
        d = tmp_path / str(comp)
        d.mkdir()
        _write(writer_cls(d, config, compression=comp), batch)
    plain, packed = _read(tmp_path / "None"), _read(tmp_path / compression)
    _assert_same_files(plain, packed)
    with h5py.File(tmp_path / compression / "run_0000.h5") as f:
        assert f["cloud/cloud_0"].compression == compression


def test_striped_writer_files_equal_one_child(batch, tmp_path):
    """n_shards=2 writes the files of n_shards=1: the same names and
    values, each a contiguous range of events (3 events a file, so that
    both batches straddle file boundaries)."""
    config = torch_config()
    for name, shards in (("one", 1), ("two", 2)):
        d = tmp_path / name
        d.mkdir()
        _write(SpyralWriterProc(d, config, 3, n_shards=shards), batch)
    one, two = _read(tmp_path / "one"), _read(tmp_path / "two")
    assert len(one) >= 3
    _assert_same_files(one, two)
    _assert_same_files(one, _read_in_process(batch, tmp_path / "ref", 3))


def _read_in_process(batch, d: Path, mepf: int) -> dict:
    d.mkdir()
    _write(SpyralWriter(d, torch_config(), mepf), batch)
    return _read(d)


# ----------------------------------------------------------------------- #
# the run manifest and simulate()


def test_manifest_written_without_jax(kine, tmp_path):
    """A process where jax cannot be imported runs run_simulation on the
    CPU; its manifest holds the torch device fields and the final
    budgets."""
    code = (
        "import sys, json\n"
        "sys.modules['jax'] = None\n"
        "import attpc_engine_tpu_torch as p\n"
        "from attpc_engine_tpu_torch.detector import (Config, "
        "DetectorParams, ElectronicsParams, EngineParams, PadParams, "
        "SpyralWriter, run_simulation)\n"
        "from attpc_engine_tpu_torch.nuclear import GasTarget\n"
        "gas = GasTarget([(1, 2, 2)], 300.0, p.nuclear_map)\n"
        f"c = Config(DetectorParams(gas_target=gas, **{DET!r}), "
        f"ElectronicsParams(**{ELEC!r}), PadParams())\n"
        f"s = run_simulation(c, {str(kine)!r}, SpyralWriter({str(tmp_path)!r},"
        " c), engine=EngineParams(n_time_steps=1000, chunk_steps=500, "
        "events_per_batch=4), seed=5, stop_event=4, show_progress=False, "
        "device='cpu')\n"
        "bad = [k for k in sys.modules if sys.modules[k] is not None and "
        "(k == 'jax' or k.startswith(('jax.', 'attpc_engine_tpu.')))]\n"
        "assert not bad, bad\n"
        "print(json.dumps(s['budgets']))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    budgets = json.loads(res.stdout.strip().splitlines()[-1])
    m = _manifest(tmp_path)
    assert m["engine"] == "attpc_engine_tpu_torch" and m["stage"] == "detector"
    assert m["budgets"] == budgets and budgets["steps"] == 500
    assert m["backend"]["platform"] == "cpu"
    assert m["backend"]["torch_version"] == torch.__version__
    assert "cuda_version" in m["backend"] and m["backend"]["n_devices"] == 1
    assert m["seed"] == 5 and m["event_range"] == [0, 4]
    assert m["config"]["input"] == str(kine)
    assert {"read", "dispatch", "pull-meta", "pull-start", "pull-packed",
            "assemble", "h5py-write"} <= set(m["phase_seconds"])


def test_simulate_returns_the_batch_cloud_and_caches_by_content():
    engine = EngineParams(n_time_steps=1000, chunk_steps=500)
    mom, vert = SMOKE["momenta"][5], SMOKE["vertices"][5]
    cloud, labels = simulate(mom, vert, Z, A, torch_config(),
                             np.random.default_rng(7), [2, 3], engine=engine,
                             device="cpu")
    seed = int(np.random.default_rng(7).integers(0, 2**63 - 1))
    sim = DetectorSimulator(torch_config(), Z, A, indices=[2, 3],
                            engine=engine, device="cpu")
    out = sim.simulate_batch(vert[None], mom[None], seed=seed,
                             event_start=0, assemble=False, compact=True)
    n = int(out["counts"][0])
    assert n > 100 and cloud.shape == (n, 3) and cloud.dtype == np.float64
    np.testing.assert_array_equal(cloud[:, 0], out["pads"][:n].numpy())
    np.testing.assert_array_equal(cloud[:, 1], out["tbs"][:n].numpy())
    np.testing.assert_array_equal(cloud[:, 2], out["charges"][:n].numpy())
    np.testing.assert_array_equal(labels, out["labels"][:n].numpy())
    # a new but equal Config reuses the cached simulator; a new engine not
    (cached,) = tsimulator._SIMULATE_CACHE.values()
    simulate(mom, vert, Z, A, torch_config(), np.random.default_rng(8),
             [2, 3], engine=EngineParams(n_time_steps=1000, chunk_steps=500),
             device="cpu")
    assert next(iter(tsimulator._SIMULATE_CACHE.values())) is cached
    simulate(mom, vert, Z, A, torch_config(), np.random.default_rng(8),
             [2, 3], engine=dataclasses.replace(engine, point_budget=2048),
             device="cpu")
    assert len(tsimulator._SIMULATE_CACHE) == 1
    assert next(iter(tsimulator._SIMULATE_CACHE.values())) is not cached


# ----------------------------------------------------------------------- #
# the decay chain through the driver


def test_decay_chain_tuned_run_writes_the_untuned_files(tmp_path):
    """10B(3He,a)9B* -> a + 5Li -> a + p, four charged tracks an event,
    sampled by the JAX pipeline: the tuned run's files equal the untuned
    run's bit for bit."""
    from tests.test_torch_slice import chain_kinematics

    vert, mom, z, a = chain_kinematics(4)
    path = tmp_path / "chain.h5"
    w = KinematicsWriter(path, len(vert), z, a)
    w.write_batch(vert, mom)
    w.close()
    engine = _engine(point_budget=2048)
    tuned = _run(path, tmp_path / "tuned", engine=engine)
    pinned = _run(path, tmp_path / "pinned", engine=engine, auto_tune=False)
    assert tuned["budgets"]["point"] < pinned["budgets"]["point"]
    assert tuned["rows"] == pinned["rows"] > 0
    _assert_same_files(_read(tmp_path / "tuned"), _read(tmp_path / "pinned"))
