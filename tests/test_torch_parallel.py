"""The port's one-process-per-GPU driver, ``parallel.multihost``, against
the JAX package's and against a single-process run, on the CPU.

- ``process_plan`` gives every process the slice, the first run number
  and the return value that the JAX package's ``run_simulation_multihost``
  computes, over a sweep of event counts, process counts and ids, on
  resume directories (closed files, an under-full closed file, a crash
  partial, an unclosed HDF5 file, orphans beyond it, a complete slice),
  and raises where it raises. The JAX driver runs with its simulation,
  writer and reader replaced by stubs that record their arguments, so
  nothing compiles. ``_scan_resume_block`` returns JAX's triple.
- The port's ``run_simulation_multihost`` on the CPU: the union of 2 or 3
  processes' run files equals one process's event for event, bit for
  bit; an interrupted run resumed equals an uninterrupted one and its
  stale files are deleted.
- ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` resolve to the ids and the
  card (tests/test_torch_device.py holds the default without a card).
"""

import glob
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

import attpc_engine_tpu.detector.simulator as jsimulator
import attpc_engine_tpu.detector.writer as jwriter
import attpc_engine_tpu.io.kinematics_file as jkinematics_file
from attpc_engine_tpu.parallel import multihost as jmultihost
from attpc_engine_tpu_torch.detector import (
    EngineParams,
    SpyralWriterProc,
    run_simulation,
)
from attpc_engine_tpu_torch.io.kinematics_file import KinematicsWriter
from attpc_engine_tpu_torch.parallel import (
    multihost,
    process_plan,
    resolve_process,
    run_simulation_multihost,
)
from tests.test_torch_host import torch_config

REPO = Path(__file__).resolve().parents[1]
SMOKE = np.load(REPO / "attpc_engine_tpu_torch" / "data"
                / "smoke_kinematics.npz")
N_EVENTS = 8
SEED = 5
ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


# ----------------------------------------------------------------------- #
# the plan against the JAX driver


def _jax_driver(monkeypatch, n_events: int, pid: int, nproc: int,
                outdir: Path, **kw):
    """The JAX ``run_simulation_multihost`` with stubs for its reader,
    writer and simulation. Returns (its return value, the writer's
    keyword arguments, the simulation's keyword arguments); the last two
    are None where it simulated nothing."""
    seen = {}

    class Reader:
        def __init__(self, path):
            self.n_events = n_events

        def close(self):
            pass

    class Writer:
        def __init__(self, output_dir, config, **kwargs):
            seen["writer"] = kwargs

    def run(config, input_path, writer, **kwargs):
        seen["run"] = kwargs

    monkeypatch.setattr(jkinematics_file, "KinematicsReader", Reader)
    monkeypatch.setattr(jwriter, "SpyralWriterProc", Writer)
    monkeypatch.setattr(jsimulator, "run_simulation", run)
    ret = jmultihost.run_simulation_multihost(
        None, "kine.h5", outdir, seed=1, process_id=pid,
        num_processes=nproc, **kw)
    return ret, seen.get("writer"), seen.get("run")


def _assert_plan_matches(plan, ret, writer_kw, run_kw) -> None:
    assert (plan.start, plan.stop) == ret
    if run_kw is None:
        assert writer_kw is None and plan.start == plan.stop
        return
    assert (run_kw["start_event"], run_kw["stop_event"]) == (plan.start,
                                                             plan.stop)
    assert writer_kw["first_run_number"] == plan.first_run
    assert plan.start < plan.stop


@pytest.mark.parametrize("n_events", [1, 7, 1536])
@pytest.mark.parametrize("nproc", [1, 2, 3, 5])
def test_plan_matches_the_jax_driver(monkeypatch, tmp_path, n_events, nproc):
    union = []
    for pid in range(nproc):
        ret, writer_kw, run_kw = _jax_driver(
            monkeypatch, n_events, pid, nproc, tmp_path,
            max_events_per_file=2, run_number_stride=1000)
        plan = process_plan(n_events, pid, nproc, max_events_per_file=2,
                            run_number_stride=1000)
        _assert_plan_matches(plan, ret, writer_kw, run_kw)
        assert plan.stale == []
        union.extend(range(plan.start, plan.stop))
    assert union == list(range(n_events))


def _closed(path: Path, min_event: int, max_event: int) -> None:
    with h5py.File(path, "w") as f:
        g = f.create_group("cloud")
        g.attrs["min_event"] = min_event
        g.attrs["max_event"] = max_event


def _unclosed(path: Path) -> None:
    with h5py.File(path, "w") as f:
        f.create_group("cloud")


def _partial(path: Path) -> None:
    path.write_bytes(b"a crash partial, not HDF5")


# 12 events over 2 processes (6 each), 2 events a file, run-number blocks
# of 10: process 0 writes runs 0-9, process 1 runs 10-19
RESUME = dict(n_events=12, nproc=2, max_events_per_file=2,
              run_number_stride=10)
LAYOUTS = {
    "empty": [],
    "closed": [(0, _closed, 0, 1), (1, _closed, 2, 3), (10, _closed, 6, 7)],
    "under_full": [(0, _closed, 0, 1), (1, _closed, 2, 2),
                   (2, _closed, 3, 4)],
    "crash": [(0, _closed, 0, 1), (1, _partial), (2, _closed, 4, 5),
              (4, _partial), (10, _unclosed), (11, _closed, 8, 9)],
    "complete": [(0, _closed, 0, 1), (1, _closed, 2, 3), (2, _closed, 4, 5),
                 (10, _closed, 6, 11)],
}


def _layout(d: Path, name: str) -> Path:
    d.mkdir()
    for run, make, *events in LAYOUTS[name]:
        make(d / f"run_{run:04d}.h5", *events)
    return d


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_resume_plan_matches_the_jax_driver(monkeypatch, tmp_path, layout):
    n, nproc = RESUME["n_events"], RESUME["nproc"]
    kw = {k: RESUME[k] for k in ("max_events_per_file", "run_number_stride")}
    for pid in range(nproc):
        first_run = pid * kw["run_number_stride"]
        jdir = _layout(tmp_path / f"jax{pid}", layout)
        tdir = _layout(tmp_path / f"torch{pid}", layout)
        j = jmultihost._scan_resume_block(jdir, first_run,
                                          kw["run_number_stride"])
        t = multihost._scan_resume_block(tdir, first_run,
                                         kw["run_number_stride"])
        assert j[:2] == t[:2]
        assert [p.name for p in j[2]] == [p.name for p in t[2]]
        ret, writer_kw, run_kw = _jax_driver(monkeypatch, n, pid, nproc,
                                             jdir, resume=True, **kw)
        plan = process_plan(n, pid, nproc, resume_dir=tdir, **kw)
        _assert_plan_matches(plan, ret, writer_kw, run_kw)
        # the JAX driver deleted what the plan lists; the plan deleted
        # nothing
        if run_kw is not None:
            assert sorted(p.name for p in plan.stale) == sorted(
                set(p.name for p in tdir.iterdir())
                - set(p.name for p in jdir.iterdir()))
        else:
            assert plan.stale == []
        assert len(list(tdir.iterdir())) == len(LAYOUTS[layout])
    if layout == "crash":
        assert [p.name for p in process_plan(
            n, 0, nproc, resume_dir=tdir.parent / "torch0", **kw).stale] == [
            "run_0001.h5", "run_0002.h5", "run_0004.h5"]


@pytest.mark.parametrize("case", ["pid_high", "pid_negative",
                                  "stride_too_small", "block_used_up"])
def test_plan_guards_match_the_jax_driver(monkeypatch, tmp_path, case):
    """Both raise ValueError with one message: a process id outside
    [0, nproc), a run-number block smaller than the slice's files, and a
    block that under-full closed files used up on resume."""
    n, pid, nproc = 12, 0, 2
    kw = dict(max_events_per_file=2, run_number_stride=10)
    if case == "pid_high":
        pid = nproc
    elif case == "pid_negative":
        pid = -1
    elif case == "stride_too_small":
        nproc, kw["run_number_stride"] = 1, 3
    else:
        _closed(tmp_path / "run_0000.h5", 0, 0)
        kw.update(run_number_stride=3, resume=True)
    with pytest.raises(ValueError) as jerr:
        _jax_driver(monkeypatch, n, pid, nproc, tmp_path, **kw)
    resume_dir = tmp_path if kw.pop("resume", False) else None
    with pytest.raises(ValueError) as terr:
        process_plan(n, pid, nproc, resume_dir=resume_dir, **kw)
    assert str(terr.value) == str(jerr.value)


# ----------------------------------------------------------------------- #
# the port's driver on the CPU


@pytest.fixture(scope="module")
def kine(tmp_path_factory):
    """The first 8 committed flagship events in a kinematics file."""
    path = tmp_path_factory.mktemp("kine") / "k.h5"
    w = KinematicsWriter(path, N_EVENTS, SMOKE["proton_numbers"],
                         SMOKE["mass_numbers"])
    w.write_batch(SMOKE["vertices"][:N_EVENTS], SMOKE["momenta"][:N_EVENTS])
    w.close()
    return path


@pytest.fixture
def no_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


ENGINE = dict(n_time_steps=1000, chunk_steps=250, events_per_batch=4)


def _multihost(kine, outdir: Path, **kw) -> tuple[int, int]:
    return run_simulation_multihost(
        torch_config(), kine, outdir, seed=SEED, engine=EngineParams(**ENGINE),
        max_events_per_file=3, run_number_stride=10, device="cpu", **kw)


def _events(outdir: Path) -> dict:
    """{event: (cloud, labels, cloud attrs less orig_run)} over the run
    files: the contents that do not depend on the file an event is in."""
    out = {}
    for path in sorted(glob.glob(str(outdir / "run_*.h5"))):
        with h5py.File(path, "r") as f:
            g = f["cloud"]
            for name in g:
                if name.startswith("cloud_"):
                    ev = int(name.split("_")[1])
                    attrs = {k: v for k, v in g[name].attrs.items()
                             if k != "orig_run"}
                    assert ev not in out
                    out[ev] = (g[name][()], g[f"labels_{ev}"][()], attrs)
    return out


def _assert_same_events(a: dict, b: dict) -> None:
    assert a.keys() == b.keys() and a
    for ev in a:
        (ca, la, aa), (cb, lb, ab) = a[ev], b[ev]
        assert ca.dtype == cb.dtype and la.dtype == lb.dtype
        np.testing.assert_array_equal(ca, cb, err_msg=f"cloud_{ev}")
        np.testing.assert_array_equal(la, lb, err_msg=f"labels_{ev}")
        assert aa == ab


@pytest.fixture(scope="module")
def single(kine, tmp_path_factory):
    """One process's run files."""
    outdir = tmp_path_factory.mktemp("single")
    assert _multihost(kine, outdir, process_id=0,
                      num_processes=1) == (0, N_EVENTS)
    return _events(outdir)


@pytest.mark.parametrize("nproc", [2, 3])
def test_union_of_processes_equals_one_process(kine, tmp_path, single,
                                               no_env, nproc):
    """P processes, ids given explicitly and no RANK/WORLD_SIZE set, off
    the 4-event batch grid at P = 3 (3 events a process): the union of
    their files equals one process's, and each wrote its own run-number
    block."""
    slices = [_multihost(kine, tmp_path, process_id=pid, num_processes=nproc)
              for pid in range(nproc)]
    per = -(-N_EVENTS // nproc)
    assert slices == [(p * per, min(N_EVENTS, (p + 1) * per))
                      for p in range(nproc)]
    runs = sorted(int(Path(p).name[4:8])
                  for p in glob.glob(str(tmp_path / "run_*.h5")))
    assert {r // 10 for r in runs} == set(range(nproc))
    _assert_same_events(_events(tmp_path), single)


def test_ids_from_the_environment(kine, tmp_path, single, monkeypatch):
    """RANK and WORLD_SIZE pick the slice where no id is passed."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    for rank in ("1", "0"):
        monkeypatch.setenv("RANK", rank)
        _multihost(kine, tmp_path)
    assert sorted(Path(p).name for p in glob.glob(
        str(tmp_path / "run_*.h5"))) == ["run_0000.h5", "run_0001.h5",
                                         "run_0010.h5", "run_0011.h5"]
    _assert_same_events(_events(tmp_path), single)


def test_resume_after_interruption(kine, tmp_path, single, no_env):
    """A run interrupted after event 5 (run_0000 full, run_0001 closed
    under-full, a crash partial run_0002 and an orphan run_0004) resumes
    at event 5 with run 2, deletes the partial and the orphan, and then
    holds the uninterrupted run's events; resuming again does nothing."""
    config = torch_config()
    writer = SpyralWriterProc(tmp_path, config, max_events_per_file=3)
    run_simulation(config, kine, writer, engine=EngineParams(**ENGINE),
                   seed=SEED, show_progress=False, stop_event=5,
                   device="cpu")
    _partial(tmp_path / "run_0002.h5")
    _closed(tmp_path / "run_0004.h5", 0, 99)
    assert _multihost(kine, tmp_path, process_id=0, num_processes=1,
                      resume=True) == (5, N_EVENTS)
    assert sorted(p.name for p in tmp_path.glob("run_*.h5")) == [
        "run_0000.h5", "run_0001.h5", "run_0002.h5"]
    with h5py.File(tmp_path / "run_0002.h5", "r") as f:
        assert f["cloud"].attrs["max_event"] == N_EVENTS - 1
    _assert_same_events(_events(tmp_path), single)
    before = sorted((p.name, p.stat().st_mtime_ns)
                    for p in tmp_path.iterdir())
    assert _multihost(kine, tmp_path, process_id=0, num_processes=1,
                      resume=True) == (N_EVENTS, N_EVENTS)
    assert sorted((p.name, p.stat().st_mtime_ns)
                  for p in tmp_path.iterdir()) == before


def test_empty_slice_touches_nothing(kine, tmp_path, no_env):
    """5 processes over 8 events: process 4 owns nothing."""
    assert _multihost(kine, tmp_path, process_id=4,
                      num_processes=5) == (8, 8)
    assert list(tmp_path.iterdir()) == []


def test_environment_resolves_ids_and_card(monkeypatch):
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_process(device="cpu") == (2, 3, torch.device("cpu"))
    assert resolve_process(0, 1, "cpu") == (0, 1, torch.device("cpu"))
    # where torch finds a card, the default is cuda:{LOCAL_RANK}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_process() == (2, 3, torch.device("cuda:1"))
    for k in ENV:
        monkeypatch.delenv(k)
    assert resolve_process() == (0, 1, torch.device("cuda:0"))
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="outside"):
        resolve_process()
