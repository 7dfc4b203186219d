"""The port's detector step as a whole against the JAX package's, and its
run_simulation writing Spyral HDF5; the fused-merge configurations (K5
with K6, one-stage lookup, or K2, two-stage) against the JAX package's,
and the one-stage one against the port's default configuration.

Both simulators run on the CPU (the JAX one with its default flags and no
mesh: tests/conftest.py gives JAX 8 virtual devices, and a mesh would
shard it), from identical tables (``from_jax_state``), on the same
kinematics and the same JAX Fano draws.

What must agree, and how closely:

- every integer of the merged cloud (pads, tbs, labels, validity, event
  ids, merged and deposit-point counts), the overflow counters, uniq_max
  and steps_alive: exactly;
- charges: each within 2^-16 of its event's total charge. A run's charge
  is a difference of an f32 prefix over the event's window
  (attpc_engine_tpu/detector/deposition.py:45-50), and the two sides
  round a few inputs differently (XLA's CPU code contracts some of the
  electron-count arithmetic, and its exp differs from PyTorch's by ulps),
  which moves that prefix by ulps of the event's total;
- the kept rows (ADC threshold): equal, except rows whose amplitude lies
  within that charge bound of the threshold (PARITY.md:19, hazard (c) of
  ROADMAP.md). Those are counted and bounded at 1 in 1,000 rows.
"""

import glob

import h5py
import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_setup
from attpc_engine_tpu.detector.deposition import event_keys
from attpc_engine_tpu.detector.simulator import DetectorSimulator as JaxSim
from attpc_engine_tpu.detector.simulator import EngineParams as JaxEngine
from attpc_engine_tpu_torch.detector import (
    EngineParams,
    SpyralWriter,
    SpyralWriterProc,
    run_simulation,
)
from attpc_engine_tpu_torch.detector.simulator import (
    DetectorSimulator,
    split_packed,
)
from tests.test_torch_deposit import _jax_fano_noise
from tests.test_torch_host import torch_config

E, T, CHUNK = 6, 500, 250
Z, A = np.array([1, 6, 1, 6]), np.array([2, 12, 1, 13])
ENGINE = dict(n_time_steps=T, chunk_steps=CHUNK, point_budget=1024,
              uniq_budget=12288, out_budget=8192, events_per_batch=E)


def jax_state(sim) -> dict:
    dev = sim.config.device_arrays()
    return {
        "mass": np.asarray(sim.species.mass),
        "charge": np.asarray(sim.species.charge),
        "dedx": np.asarray(sim.species.dedx),
        "log_ke_lo": sim.species.log_ke_lo,
        "dlog_ke": sim.species.dlog_ke,
        "key_grid_mm": dev["key_grid_mm"],
        "plane_hi": dev["plane_hi"],
        "plane_lo": dev["plane_lo"],
        "labels": np.asarray(sim._labels),
        "resp_max": sim._resp_max,
    }


@pytest.fixture(scope="module",
                params=[("flagship", 1024), ("flagship", 4096),
                        ("chain", 2048)],
                ids=["point_budget_1024", "point_budget_4096",
                     "chain_point_budget_2048"])
def both(request):
    """Both steps on the same batch, at the flagship's point budget and at
    4,096, the overflow retry's second doubling: merge rows of 409,600,
    which K3 sorts on its wide route on the card and the JAX package with
    lax.sort (rows padded past 2^18 fail fits_invmem); and the decay chain
    (``chain_kinematics``: four charged tracks an event, rank_bits 2) at
    2,048 point slots and 32,768 uniq slots, which hold its four tracks'
    deposits and merged entries (up to ~21,100 an event)."""
    reaction, point_budget = request.param
    engine = {**ENGINE, "point_budget": point_budget}
    if reaction == "chain":
        engine["uniq_budget"] = 32768
    pipeline, tiny = _tiny_setup(events_per_batch=E, n_time_steps=T)
    if reaction == "chain":
        vert, mom, z, a = chain_kinematics(E)
    else:
        vert, mom = (np.asarray(x) for x in
                     pipeline.run_batch(E, key=jax.random.PRNGKey(5)))
        z, a = Z, A
    jsim = JaxSim(tiny.config, z, a, engine=JaxEngine(**engine))
    key = jax.random.PRNGKey(11)
    jout = jsim.simulate_batch(key, vert, mom, assemble=False)
    keys_e = jax.vmap(jax.random.split)(event_keys(key, E, 0))[:, 0]
    noise = _jax_fano_noise(keys_e, T, E * jsim.k_tracks, CHUNK)
    tsim = DetectorSimulator(torch_config(), z, a,
                             engine=EngineParams(**engine), device="cpu")
    assert tsim.k_tracks == (4 if reaction == "chain" else 2)
    tsim.from_jax_state(jax_state(jsim))
    tout = tsim.simulate_batch(vert, mom, noise=noise, assemble=False)
    jnp_out = {k: np.asarray(v) for k, v in jout.items()}
    tnp_out = {k: v.numpy() for k, v in tout.items()}
    return jnp_out, tnp_out, tsim


def _charge_bound(q):
    """Per row: 2^-16 of its event's total charge."""
    per_event = np.abs(q.reshape(E, -1)).astype(np.float64).sum(axis=1)
    return np.repeat(per_event * 2.0**-16, q.shape[0] // E)


def _moved_pixel_rows(j, t, sim) -> set:
    """Merged rows of the decay chain whose charge is out of the per-row
    bound because a mesh pixel fell on the neighbouring pad: the two
    sides' transport positions differ by an ulp (XLA's CPU code and
    PyTorch's round differently; identical positions and electrons hold the
    deposit stage to rtol 1e-5, test_fused_merge_deposit_matches_jax), and
    a pixel at an mm cell edge changes cell. Such rows come in (event, tb)
    groups of two or more whose differences cancel within the bound, and
    are at most 1 in 10,000 rows. Empty for the flagship cases, which must
    hold the bound on every row."""
    if sim.k_tracks != 4:
        return set()
    qj, qt = j["charges"], t["charges"]
    bound = _charge_bound(qj)
    diff = qt.astype(np.float64) - qj
    out = np.nonzero(np.abs(diff) > bound)[0]
    u = len(qj) // E
    groups = {}
    for i in out:
        groups.setdefault((int(i) // u, int(j["tbs_i"][i])), []).append(i)
    for (ev, tb), rows in groups.items():
        assert len(rows) >= 2, (ev, tb)
        same_tb = np.nonzero((j["tbs_i"][ev * u:(ev + 1) * u] == tb)
                             & j["cloud_valid"][ev * u:(ev + 1) * u])[0]
        assert abs(diff[ev * u + same_tb].sum()) <= bound[ev * u], (ev, tb)
    assert len(out) <= max(2, int(j["cloud_valid"].sum()) // 10000)
    return set(groups)


def test_merged_cloud_integers_exact(both):
    j, t, _ = both
    for name in ("pads", "tbs_i", "labels", "cloud_valid", "events",
                 "counts", "n_points"):
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)
    assert j["counts"].sum() > 0


def test_meta_exact_except_near_threshold_rows(both):
    j, t, _ = both
    jm, tm = j["meta_i32"], t["meta_i32"]
    np.testing.assert_array_equal(tm[E:], jm[E:])  # counts, overflows ...
    assert (jm[-5:-2] == 0).all()
    assert np.abs(tm[:E] - jm[:E]).sum() <= max(1, jm[:E].sum() // 1000)


def test_charges_within_event_prefix_bound(both):
    j, t, sim = both
    qj, qt = j["charges"], t["charges"]
    bound = _charge_bound(qj)
    moved = _moved_pixel_rows(j, t, sim)
    u = len(qj) // E
    in_moved = np.array([(i // u, int(tb)) in moved
                         for i, tb in enumerate(j["tbs_i"])])
    assert (np.abs(qt.astype(np.float64) - qj) <= bound)[~in_moved].all()
    exact = (qt == qj).mean()
    assert exact > 0.5  # most runs are bit-identical


def test_packed_rows_exact_but_near_threshold(both):
    j, t, sim = both
    thr = float(sim.config.elec_params.adc_threshold)
    resp_max = sim._resp_max
    per_event_bound = _charge_bound(j["charges"]).reshape(E, -1)[:, 0]
    moved = _moved_pixel_rows(j, t, sim)
    rows = {}
    for name, out in (("jax", j), ("port", t)):
        counts = out["spyral_counts"]
        q, tb, pad, lab = split_packed(out["packed"][:counts.sum()])
        ev = np.repeat(np.arange(E), counts)
        rows[name] = {(int(e), int(m)): float(x) for e, m, x in
                      zip(ev, out["packed"][:counts.sum(), 1], q)}
    n_rows = len(rows["jax"])
    only = set(rows["jax"]) ^ set(rows["port"])
    for key in only:
        q = rows["jax"].get(key, rows["port"].get(key))
        if (key[0], key[1] >> 22) in moved:
            continue
        assert abs(resp_max * q - thr) <= resp_max * per_event_bound[key[0]]
    assert len(only) <= max(1, n_rows // 1000)
    both_keys = set(rows["jax"]) & set(rows["port"])
    same = sum(rows["jax"][k] == rows["port"][k] for k in both_keys)
    for k in both_keys:
        if (k[0], k[1] >> 22) not in moved:
            assert (abs(rows["jax"][k] - rows["port"][k])
                    <= per_event_bound[k[0]])
    assert same / len(both_keys) > 0.5
    # within each event, rows descend in integer tb, as the JAX pool does
    for name, out in (("jax", j), ("port", t)):
        counts = out["spyral_counts"]
        _, tb, _, _ = split_packed(out["packed"][:counts.sum()])
        for seg in np.split(tb, np.cumsum(counts)[:-1]):
            assert (np.diff(seg) <= 0).all(), name


# ----------------------------------------------------------------------- #
# run_simulation and the writers


@pytest.fixture(scope="module")
def kine_file(tmp_path_factory):
    from attpc_engine_tpu.kinematics import run_kinematics_pipeline

    pipeline, _ = _tiny_setup(events_per_batch=4)
    path = tmp_path_factory.mktemp("kine") / "k.h5"
    run_kinematics_pipeline(pipeline, 8, path, batch_size=8, seed=8,
                            show_progress=False, use_mesh=False)
    return path


def _run(kine, outdir, writer_cls, point_budget=1024, engine_kw=None, **kw):
    outdir.mkdir()
    config = torch_config()
    engine = EngineParams(n_time_steps=T, chunk_steps=CHUNK,
                          point_budget=point_budget, events_per_batch=4,
                          **(engine_kw or {}))
    stats = run_simulation(config, kine, writer_cls(outdir, config),
                           engine=engine, seed=2, device="cpu", **kw)
    return stats


def _read(outdir):
    clouds = {}
    for path in sorted(glob.glob(str(outdir / "run_*.h5"))):
        with h5py.File(path, "r") as f:
            g = f["cloud"]
            clouds["attrs"] = (int(g.attrs["min_event"]),
                               int(g.attrs["max_event"]))
            for name in g:
                clouds[name] = (g[name][()], dict(g[name].attrs))
    return clouds


def test_run_simulation_writes_spyral_files(kine_file, tmp_path):
    stats = _run(kine_file, tmp_path / "a", SpyralWriter, point_budget=64)
    # 64 point slots overflow: the batch reran with the budget doubled
    assert stats["budgets"]["point"] > 64 and stats["events"] == 8
    clouds = _read(tmp_path / "a")
    names = [n for n in clouds if n.startswith("cloud_")]
    assert len(names) >= 3 and clouds["attrs"][0] == 0
    rows = 0
    for name in names:
        data, attrs = clouds[name]
        labels, _ = clouds["labels_" + name.split("_")[1]]
        assert data.dtype == np.float64 and data.shape[1] == 8
        assert len(labels) == len(data)
        assert (np.diff(data[:, 2]) >= 0).all()  # z ascending
        assert ((data[:, 3] > 40) & (data[:, 3] <= 4095)).all()
        assert ((data[:, 5] >= 0) & (data[:, 5] < 10240)).all()
        assert ((data[:, 6] >= 0) & (data[:, 6] < 512)).all()
        for ic in ("ic_amplitude", "ic_integral", "ic_multiplicity",
                   "ic_centroid"):
            assert attrs[ic] == -1.0
        rows += len(data)
    assert rows == stats["rows"]


def test_writer_proc_and_retry_and_resume_agree(kine_file, tmp_path):
    """The child-process writer, a run that needed no retry, and a run
    resumed at event 4 write the same clouds as the in-process writer
    after a retry."""
    _run(kine_file, tmp_path / "a", SpyralWriter, point_budget=64)
    _run(kine_file, tmp_path / "b", SpyralWriterProc)
    _run(kine_file, tmp_path / "c", SpyralWriter, start_event=4)
    a, b, c = (_read(tmp_path / d) for d in "abc")
    assert a.keys() == b.keys()
    for name in a:
        if name == "attrs":
            assert a[name] == b[name]
            continue
        np.testing.assert_array_equal(a[name][0], b[name][0], err_msg=name)
    resumed = [n for n in c if n != "attrs"]
    assert resumed and all(int(n.split("_")[1]) >= 4 for n in resumed)
    for name in resumed:
        np.testing.assert_array_equal(c[name][0], a[name][0], err_msg=name)


def test_device_default_and_cuda_tensor_routing():
    """A CPU simulator runs the plain versions: no kernel is launched."""
    from attpc_engine_tpu_torch.detector import (
        deposit_cuda,
        sort_cuda,
        transport_cuda,
    )

    before = (transport_cuda.launches, deposit_cuda.launches,
              sort_cuda.launches)
    sim = DetectorSimulator(torch_config(), Z, A,
                            engine=EngineParams(n_time_steps=50,
                                                chunk_steps=50,
                                                point_budget=64),
                            device="cpu")
    pipeline, _ = _tiny_setup(events_per_batch=2)
    vert, mom = (np.asarray(x) for x in
                 pipeline.run_batch(2, key=jax.random.PRNGKey(1)))
    out = sim.simulate_batch(vert, mom, seed=3)
    assert out["spyral"].shape[1] == 8
    assert out["packed"].device == torch.device("cpu")
    assert (transport_cuda.launches, deposit_cuda.launches,
            sort_cuda.launches) == before


# ----------------------------------------------------------------------- #
# the fused-merge configurations (K5 with K6 or K2)

FUSED = dict(merge="fused", lookup="one_stage")
INTEGERS = ("pads", "tbs_i", "tbs", "labels", "events", "cloud_valid",
            "counts", "n_points", "pool_overflow", "uniq_overflow",
            "uniq_max")


def _random_walk_tracks():
    """The tracks of tests/test_sort_pallas.py:191-202."""
    rng = np.random.default_rng(43)
    e, k, t = 2, 2, 30
    b = e * k
    positions = np.zeros((t, b, 3), np.float32)
    positions[:, :, 0] = np.cumsum(rng.normal(0, 0.004, (t, b)), 0)
    positions[:, :, 1] = 0.08 + np.cumsum(rng.normal(0, 0.004, (t, b)), 0)
    positions[:, :, 2] = rng.uniform(0.1, 0.99, (t, b))
    electrons = rng.integers(0, 2000, (t, b)).astype(np.int32)
    valid = rng.random((t, b)) < 0.9
    labels = np.tile(np.arange(k, dtype=np.int32) + 2, e)
    return dict(positions=positions, electrons=electrons, valid=valid,
                track_labels=labels, n_events=e, tracks_per_event=k)


def chain_kinematics(e: int):
    """``e`` events of the decay chain of tests/test_end_to_end.py:182-216,
    10B(3He,a)9B* -> a + 5Li -> a + p, sampled by the JAX pipeline: (vertices,
    momenta, proton numbers, mass numbers)."""
    from attpc_engine_tpu import nuclear_map
    from attpc_engine_tpu.kinematics import (
        Decay,
        ExcitationGaussian,
        KinematicsPipeline,
        KinematicsTargetMaterial,
        PolarUniform,
        Reaction,
    )
    from attpc_engine_tpu.nuclear import GasTarget

    gas = GasTarget([(1, 2, 2)], 300.0, nuclear_map)
    get = nuclear_map.get_data
    pipeline = KinematicsPipeline(
        [Reaction(target=get(5, 10), projectile=get(2, 3), ejectile=get(2, 4)),
         Decay(parent=get(5, 9), residual_1=get(2, 4)),
         Decay(parent=get(3, 5), residual_1=get(2, 4))],
        [ExcitationGaussian(16.8, 0.2), ExcitationGaussian(0.0, 1.25),
         ExcitationGaussian(0.0, 0.0)],
        [PolarUniform(0.0, np.pi)] * 3,
        24.0,
        target_material=KinematicsTargetMaterial(
            material=gas, z_range=(0.2, 0.8), rho_sigma=0.005),
    )
    vert, mom = (np.asarray(x) for x in
                 pipeline.run_batch(e, key=jax.random.PRNGKey(31)))
    return vert, mom, pipeline.get_proton_numbers(), pipeline.get_mass_numbers()


def _chain_tracks():
    """The decay chain (``chain_kinematics``): four charged tracks per
    event (rank_bits 2), transported by the port on the CPU; the deposit
    stage's inputs are taken from the port's step."""
    from attpc_engine_tpu_torch.detector import simulator

    vert, mom, z, a = chain_kinematics(2)
    sim = DetectorSimulator(torch_config(), z, a, device="cpu",
                            engine=EngineParams(n_time_steps=T,
                                                chunk_steps=CHUNK,
                                                point_budget=128))
    assert sim.k_tracks == 4
    seen = {}
    real = simulator.deposit_and_merge

    def spy(positions, electrons, valid, track_labels, pad_table, **kw):
        seen.update(positions=positions.numpy(), electrons=electrons.numpy(),
                    valid=valid.numpy(), track_labels=track_labels.numpy(),
                    n_events=kw["n_events"],
                    tracks_per_event=kw["tracks_per_event"])
        return real(positions, electrons, valid, track_labels, pad_table,
                    **kw)

    simulator.deposit_and_merge = spy
    try:
        sim.simulate_batch(vert, mom, seed=4, assemble=False)
    finally:
        simulator.deposit_and_merge = real
    return seen


@pytest.mark.parametrize("tracks", [_random_walk_tracks, _chain_tracks],
                         ids=["flagship", "chain"])
@pytest.mark.parametrize("lookup", ["one_stage", "two_stage"])
def test_fused_merge_deposit_matches_jax(lookup, tracks):
    """The port's deposit_and_merge(merge="fused", lookup=...) against the
    JAX one with pallas_lookup=True, pallas_sort="fused" and
    lookup_two_stage=False (K6) or True (K2) (interpret mode), on the same
    electrons and wiggle: every integer exact; charges (gain 1) within
    rtol 1e-5 / atol 1e-2, the bound of tests/test_sort_pallas.py:171-173."""
    from attpc_engine_tpu.detector.deposition import deposit_and_merge as jdm
    from tests.test_torch_host import jax_config

    config = jax_config()
    dev = config.device_arrays()
    tr = tracks()
    e = tr["n_events"]
    kw = dict(grid_lo_mm=dev["grid_lo_mm"], grid_n_mm=dev["grid_n_mm"],
              diffusion=config.det_params.diffusion,
              efield=config.det_params.efield,
              drift_velocity=config.drift_velocity, micromegas_edge=10.0,
              length=1.0, mpgd_gain=1.0, n_events=e,
              tracks_per_event=tr["tracks_per_event"], point_budget=128,
              uniq_budget=4096)
    args = [tr[k] for k in ("positions", "electrons", "valid",
                            "track_labels")]
    keys = event_keys(jax.random.PRNGKey(47), e)
    ref = jdm(keys, *args, dev["key_grid_mm"], pallas_lookup=True,
              pallas_sort="fused", lookup_two_stage=lookup == "two_stage",
              plane_hi=dev["plane_hi"], plane_lo=dev["plane_lo"], **kw)
    u = ref["pads"].shape[0] // e
    wiggle = np.asarray(jax.vmap(
        lambda kk: jax.random.uniform(kk, (u,), dtype=jax.numpy.float32))(
            keys))
    table = torch.from_numpy(
        (dev["plane_hi"] * 128 + dev["plane_lo"]).astype(np.int32))
    from attpc_engine_tpu_torch.detector.deposition import deposit_and_merge

    got = deposit_and_merge(*(torch.from_numpy(np.asarray(a)) for a in args),
                            table, wiggle=torch.from_numpy(wiggle),
                            merge="fused", lookup=lookup, **kw)
    for name in INTEGERS:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(ref[name]), err_msg=name)
    np.testing.assert_allclose(got["charges"].numpy(),
                               np.asarray(ref["charges"]), rtol=1e-5,
                               atol=1e-2)
    assert int(got["counts"].sum()) > 0


def _smoke_sims(n_events, **engine):
    from tests.test_torch_cuda import SMOKE

    data = np.load(SMOKE)
    sims = [DetectorSimulator(torch_config(), data["proton_numbers"],
                              data["mass_numbers"], device="cpu",
                              engine=EngineParams(
                                  n_time_steps=T, events_per_batch=n_events,
                                  **cfg, **engine))
            for cfg in ({}, FUSED)]
    return sims, data["vertices"][:n_events], data["momenta"][:n_events]


def test_step_fused_configuration_matches_default():
    """8 flagship events at full width through simulate_batch in both
    configurations: the merged cloud's integers exact, charges within
    rtol 1e-5 with a one-electron floor (tests/test_sort_pallas.py:221-230),
    meta_i32 exact apart from rows near the ADC threshold (1 in 1,000)."""
    n = 8
    sims, vert, mom = _smoke_sims(n)
    d, f = (s.simulate_batch(vert, mom, seed=1, assemble=False)
            for s in sims)
    for name in ("pads", "tbs_i", "labels", "events", "cloud_valid",
                 "counts", "n_points"):
        torch.testing.assert_close(f[name], d[name], rtol=0, atol=0,
                                   msg=name)
    gain = float(sims[0].config.det_params.mpgd_gain)
    np.testing.assert_allclose(f["charges"].numpy() / gain,
                               d["charges"].numpy() / gain, rtol=1e-5,
                               atol=1.0)
    dm, fm = d["meta_i32"].numpy(), f["meta_i32"].numpy()
    np.testing.assert_array_equal(fm[n:], dm[n:])
    assert np.abs(fm[:n] - dm[:n]).sum() <= max(1, dm[:n].sum() // 1000)
    assert dm[:n].sum() > 0 and d["packed"].shape[1] == 2


def test_step_at_retry_point_budget_matches_flagship_budget():
    """16 flagship events through simulate_batch at point budget 4,096 (the
    overflow retry's second doubling; merge rows of 409,600, K3's wide
    route on the card) and at 1,024: meta_i32 and the packed rows equal bit
    for bit, since the padding lanes sort last and add nothing."""
    from tests.test_torch_cuda import SMOKE

    data = np.load(SMOKE)
    sim = DetectorSimulator(torch_config(), data["proton_numbers"],
                            data["mass_numbers"], device="cpu",
                            engine=EngineParams(n_time_steps=T,
                                                events_per_batch=16))
    outs = [sim.simulate_batch(data["vertices"][:16], data["momenta"][:16],
                               seed=1, assemble=False, point_budget=pb)
            for pb in (1024, 4096)]
    for o in outs:
        assert o["meta_i32"][:16].sum() > 0
    assert torch.equal(outs[0]["meta_i32"], outs[1]["meta_i32"])
    assert torch.equal(outs[0]["packed"], outs[1]["packed"])


def test_run_simulation_fused_writes_spyral_files(kine_file, tmp_path):
    """The fused configuration through run_simulation and SpyralWriter
    writes the default configuration's clouds: the same events, and rows
    equal apart from near-threshold rows (1 in 1,000); amplitudes in
    electrons within rtol 1e-5 with a one-electron floor."""
    from attpc_engine_tpu_torch.detector import get_response

    config = torch_config()
    per_electron = (float(get_response(config).max())
                    * float(config.det_params.mpgd_gain))
    _run(kine_file, tmp_path / "d", SpyralWriter)
    stats = _run(kine_file, tmp_path / "f", SpyralWriter, engine_kw=FUSED)
    assert stats["events"] == 8
    d, f = _read(tmp_path / "d"), _read(tmp_path / "f")
    assert d.keys() == f.keys() and d["attrs"] == f["attrs"]
    names = [n for n in d if n.startswith("cloud_")]
    n_rows = sum(len(d[n][0]) for n in names)
    assert n_rows == stats["rows"] or abs(n_rows - stats["rows"]) <= max(
        1, n_rows // 1000)
    for name in names:
        dd, ff = d[name][0], f[name][0]
        if len(dd) == len(ff):
            np.testing.assert_array_equal(ff[:, 5:], dd[:, 5:], err_msg=name)
            np.testing.assert_allclose(ff[:, 3] / per_electron,
                                       dd[:, 3] / per_electron, rtol=1e-5,
                                       atol=1.0)
