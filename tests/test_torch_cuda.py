"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc: marked ``cuda``, each skips
where ``torch.cuda.is_available()`` is false. This file imports nothing of
the JAX package (the card's Python needs neither jax nor h5py for it):

    python -m pytest -q tests/test_torch_cuda.py

Bounds: K1 alive flags exact, positions within 1e-6 m, |dKE| within
1e-4 MeV (tests/test_transport_pallas.py); K2 and K7 (one quad kernel), K3
(its three routes: the live route of the default step's merge sort
against torch.sort of the whole row), K6, the deposit-rows kernel and the
run-end compaction bit-exact; K5 (both routes) key2 and n_uniq exact and
c2 bit-exact; the Spyral assembly
(``csrc/assemble.cu``) bit-exact against its plain version and the C++
library; the Fano kernel (``csrc/fano.cu``) bit-exact against
``generate_electrons`` of ``fano_noise``, on one card and on two; K1's
window gate as its plain version's; the default step's CUDA graph
(``step_graph.py``): its replays bit-exact against the eager step at the
benchmark cells' tuned budgets, on one card thread and on two. A
wrapper given a CUDA tensor it cannot take raises: nothing falls back.
"""

import importlib.util
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
)
from attpc_engine_tpu_torch.detector import (
    assemble_cuda,
    compact_cuda,
    deposit_cuda,
    deposition,
    fano_cuda,
    merge_cuda,
    sort_cuda,
    transport_cuda,
)
from attpc_engine_tpu_torch.detector import transport as T
from attpc_engine_tpu_torch.nuclear import GasTarget

pytestmark = pytest.mark.cuda

SMOKE = (Path(__file__).resolve().parents[1] / "attpc_engine_tpu_torch"
         / "data" / "smoke_kinematics.npz")


def _load_cases(name):
    """tests/<name>.py by its path: the card's Python has a package named
    ``tests`` of its own, which ``tests.<name>`` would find."""
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).with_name(f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_cases = _load_cases("assemble_cases")
edge_events, forged_tie, pool = (_cases.edge_events, _cases.forged_tie,
                                 _cases.pool)
_merge_cases = _load_cases("merge_cases")
merge_rows, live_rows = _merge_cases.merge_rows, _merge_cases.live_rows
LIVE_EDGES, live_plan = _merge_cases.LIVE_EDGES, _merge_cases.live_plan
CONFIGS = Path(__file__).resolve().parents[1] / "port_bench" / "configs"
SENT = 2**31 - 1


@pytest.fixture
def cuda_device():
    """The card; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _simulator(device, **engine):
    gas = GasTarget([(1, 2, 2)], 300.0, nuclear_map)
    config = Config(
        DetectorParams(1.0, 45000.0, 2.85, 175000, gas, 0.277, 0.2, 34.0),
        ElectronicsParams(6.25, 900, 1000, 10, 560, 40),
        PadParams(),
    )
    data = np.load(SMOKE)
    sim = DetectorSimulator(config, data["proton_numbers"],
                            data["mass_numbers"],
                            engine=EngineParams(**engine), device=device)
    return sim, data["vertices"], data["momenta"]


def test_transport_kernel_matches_plain(cuda_device):
    sim, vert, mom = _simulator(cuda_device)
    e, k, steps = 64, sim.k_tracks, 500
    p3 = mom[:e, sim.sim_indices, :3]
    gv0 = torch.from_numpy((p3 / sim.track_masses[None, :, None])
                           .astype(np.float32).reshape(-1, 3)).cuda()
    pos0 = torch.from_numpy(np.repeat(vert[:e].astype(np.float32), k,
                                      axis=0)).cuda()
    s_idx = torch.arange(k, dtype=torch.int32).repeat(e).cuda()
    mass, q_m = T.track_constants(sim.species, s_idx)
    dp = sim.config.det_params
    kc = T.Rk4Constants.make(sim.species, float(dp.gas_target.density),
                             float(dp.bfield), float(dp.efield), 1e-10)
    outs = []
    for fn in (T.rk4_window_plain, transport_cuda.rk4_window_cuda):
        state = (pos0.clone(), gv0.clone(), T.initial_alive(pos0, gv0, mass))
        out = (torch.zeros((steps, e * k, 3), device="cuda"),
               torch.zeros((steps, e * k), device="cuda"),
               torch.zeros((steps, e * k), dtype=torch.bool, device="cuda"))
        gate = torch.tensor([1, 0], dtype=torch.int32, device="cuda")
        fn(*state, s_idx, mass, q_m, sim.species.dedx, *out, kc, gate)
        outs.append(out + state + (gate,))
    (pr, dr, ar, *cr), (pg, dg, ag, *cg) = outs
    assert torch.equal(ar, ag) and ar.any()
    assert float((pr - pg).abs()[ar].max()) < 1e-6
    assert float((dr - dg).abs()[ar].max()) < 1e-4
    assert torch.equal(cr[2], cg[2])  # the carried alive flags
    # the next window's gate: some lane is alive at this one's end
    assert cr[3].tolist() == cg[3].tolist() == [1, int(cr[2].any())]


def test_transport_gate_closes_and_passes_on(cuda_device):
    """K1's gate on the card as in its plain version: a closed gate
    (word 0 is 0) writes nothing, neither rows nor carry nor the next
    word; an open one over all-dead lanes writes the frozen rows and
    leaves the next word 0."""
    sim, vert, mom = _simulator(cuda_device)
    e, k, steps = 64, sim.k_tracks, 100
    p3 = mom[:e, sim.sim_indices, :3]
    gv0 = torch.from_numpy((p3 / sim.track_masses[None, :, None])
                           .astype(np.float32).reshape(-1, 3)).cuda()
    pos0 = torch.from_numpy(np.repeat(vert[:e].astype(np.float32), k,
                                      axis=0)).cuda()
    s_idx = torch.arange(k, dtype=torch.int32).repeat(e).cuda()
    mass, q_m = T.track_constants(sim.species, s_idx)
    dp = sim.config.det_params
    kc = T.Rk4Constants.make(sim.species, float(dp.gas_target.density),
                             float(dp.bfield), float(dp.efield), 1e-10)
    for word0, dead in ((0, False), (1, True)):
        got = []
        for fn in (T.rk4_window_plain, transport_cuda.rk4_window_cuda):
            alive = T.initial_alive(pos0, gv0, mass)
            if dead:
                alive[:] = False
            state = [pos0.clone(), gv0.clone(), alive]
            out = [torch.full((steps, e * k, 3), 7.0, device="cuda"),
                   torch.full((steps, e * k), 7.0, device="cuda"),
                   torch.ones((steps, e * k), dtype=torch.bool,
                              device="cuda")]
            gate = torch.tensor([word0, 0], dtype=torch.int32,
                                device="cuda")
            before = [t.clone() for t in state + out]
            fn(*state, s_idx, mass, q_m, sim.species.dedx, *out, kc, gate)
            if word0 == 0:
                assert all(torch.equal(a, b)
                           for a, b in zip(before, state + out))
            got.append(state + out + [gate])
        for a, b in zip(*got):
            assert torch.equal(a, b)
        assert got[1][-1].tolist() == [word0, 0]
        if dead:
            assert not got[1][5].any() and not got[1][4].any()


def test_transport_fast_paths_equal_ieee_operators(cuda_device):
    """K1's branch-free division and square-root fast paths against the
    same window with every step through the compiler's IEEE operators
    (force_ieee): positions, |dKE|, flags and the carry bit for bit."""
    sim, vert, mom = _simulator(cuda_device)
    e, k, steps = 64, sim.k_tracks, 500
    p3 = mom[:e, sim.sim_indices, :3]
    gv0 = torch.from_numpy((p3 / sim.track_masses[None, :, None])
                           .astype(np.float32).reshape(-1, 3)).cuda()
    pos0 = torch.from_numpy(np.repeat(vert[:e].astype(np.float32), k,
                                      axis=0)).cuda()
    s_idx = torch.arange(k, dtype=torch.int32).repeat(e).cuda()
    mass, q_m = T.track_constants(sim.species, s_idx)
    dp = sim.config.det_params
    kc = T.Rk4Constants.make(sim.species, float(dp.gas_target.density),
                             float(dp.bfield), float(dp.efield), 1e-10)
    outs = []
    for force_ieee in (False, True):
        state = (pos0.clone(), gv0.clone(), T.initial_alive(pos0, gv0, mass))
        out = (torch.zeros((steps, e * k, 3), device="cuda"),
               torch.zeros((steps, e * k), device="cuda"),
               torch.zeros((steps, e * k), dtype=torch.bool, device="cuda"))
        gate = torch.tensor([1, 0], dtype=torch.int32, device="cuda")
        transport_cuda.rk4_window_cuda(*state, s_idx, mass, q_m,
                                       sim.species.dedx, *out, kc, gate,
                                       force_ieee=force_ieee)
        outs.append(out + state)
    assert outs[0][2].any()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _sort_rows(w: int) -> torch.Tensor:
    """Nine int64 rows of width ``w``: pack64 merge pairs with sentinel
    lanes (rows 0 and 3), a row of sentinels (1) and the hazards of the
    cluster route: (d) signed keys (2, 7, 8), (a) many elements sharing a
    low digit and differing in higher ones (4), (e) a row of one value
    (5, and 1) and a row where only the top digit varies (6)."""
    rng = np.random.default_rng(w)
    hi = rng.integers(0, 7, (4, w)).astype(np.int32) * 1000
    hi[rng.random((4, w)) < 0.3] = SENT
    lo = np.float32(rng.random((4, w)) * 100)
    x = sort_cuda.pack64(torch.from_numpy(hi), torch.from_numpy(lo)).numpy()
    x[1] = 2**63 - 1
    x[2] = -x[2]
    low_digit = (rng.integers(-2**47, 2**47, w) << 8) | rng.integers(0, 2, w)
    one_value = np.full(w, -12345)
    top_digit = (rng.integers(-128, 128, w) << 56) | 0x0123456789ABCD
    mixed = rng.integers(-2**63, 2**63 - 1, w, endpoint=True)
    mixed[:4] = [-2**63, -1, 0, 2**63 - 1][:w]
    convert = np.where(rng.random(w) < 0.6,
                       rng.integers(0, 2**62, w) | -2**63, 2**63 - 1)
    return torch.from_numpy(np.concatenate(
        [x, np.stack([low_digit, one_value, top_digit, mixed, convert])]))


@pytest.mark.parametrize("w", [1, 2, 300, 12288, 12289, 16384, 40000,
                               102400, 204803, 262145, 409600, 819200])
def test_sort_kernel_matches_torch_sort(cuda_device, w):
    """Bit-exact on both routes: one CTA (1-12,289; 12,289 ragged), 2-8
    CTAs (16,384-102,400), 16 CTAs with a ragged last chunk (204,803) and
    the wide route (262,145 with a ragged last chunk; 409,600 and 819,200,
    the merge rows at point budgets 4,096 and 8,192)."""
    x = _sort_rows(w).to(cuda_device)
    got = sort_cuda.sort_rows(x)
    assert torch.equal(got, torch.sort(x, dim=1).values)


@pytest.mark.parametrize("w", [12288, 102400])
def test_sort_kernel_many_rows(cuda_device, w):
    """(b): 384 rows, many more clusters than the card holds at once, so
    clusters start while others finish; merge-like rows."""
    g = torch.Generator(device=cuda_device).manual_seed(w)
    key = torch.randint(0, 6000, (384, w), generator=g, device=cuda_device)
    dead = torch.rand((384, w), generator=g, device=cuda_device) < 0.4
    key = torch.where(dead, SENT, key << 1)
    q = torch.rand((384, w), generator=g, device=cuda_device) * 100
    x = sort_cuda.pack64(key, torch.where(dead, 0.0, q))
    assert torch.equal(sort_cuda.sort_rows(x), torch.sort(x, dim=1).values)


@pytest.mark.parametrize("w", [213761, 409600])
def test_wide_sort_of_heavy_duplicates(cuda_device, w):
    """The wide route's tie rule: rows of one value, of two values, of
    INT64_MAX runs, of the merge rows' sentinel with zero charge beside
    zero-charge pixels, and of negative keys with long equal runs; every
    merge tile edge falls inside a run of equal elements."""
    rng = np.random.default_rng(w)
    two = np.where(rng.random(w) < 0.5, 7, 9)
    runs = np.where(rng.random(w) < 0.7, 2**63 - 1, rng.integers(0, 50, w))
    merge = sort_cuda.pack64(
        torch.from_numpy(np.where(rng.random(w) < 0.6, SENT,
                                  rng.integers(0, 3, w) * 2).astype(np.int32)),
        torch.zeros(w)).numpy()
    negative = -rng.integers(1, 4, w)
    x = torch.from_numpy(np.stack([np.full(w, 5), two, runs, merge,
                                   negative])).to(cuda_device)
    assert torch.equal(sort_cuda.sort_rows(x), torch.sort(x, dim=1).values)


def test_sort_routes_by_width(cuda_device):
    """The flagship's merge width launches only the cluster route, a row
    wider than 16 CTAs hold only the wide route, on the plan ``route``
    gives (chunks of at most ``WIDE_CHUNK``, each on the cluster route);
    ``launches`` is their sum, and the wide route allocates no more than
    its output, one scratch of the rows' size and its split table."""
    for w, name in ((102400, "cluster"), (262145, "wide"), (409600, "wide")):
        x = torch.zeros((2, w), dtype=torch.int64, device=cuda_device)
        before = (sort_cuda.launches_cluster, sort_cuda.launches_wide,
                  sort_cuda.launches)
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        sort_cuda.sort_rows(x)
        extra = torch.cuda.max_memory_allocated() - allocated
        after = (sort_cuda.launches_cluster, sort_cuda.launches_wide,
                 sort_cuda.launches)
        delta = tuple(a - b for a, b in zip(after, before))
        r = sort_cuda.route(w)
        assert r.name == name
        if name == "cluster":
            assert delta == (1, 0, 1) and extra <= x.numel() * 8 + (1 << 20)
            continue
        assert delta == (0, 1, 1)
        assert r.chunks >= 2 and r.chunks & (r.chunks - 1) == 0
        assert r.chunk_w <= sort_cuda.WIDE_CHUNK < r.chunk_w * 2 or (
            r.chunks == 2)
        assert sort_cuda.route(r.chunk_w)[:3] == ("cluster", r.n_cta,
                                                  r.chunk)
        assert extra <= 2 * x.numel() * 8 + (1 << 20)


def test_sort_kernel_rejects_what_it_cannot_take(cuda_device):
    with pytest.raises(ValueError):
        sort_cuda.sort_rows(torch.zeros((2, 8), dtype=torch.int32,
                                        device=cuda_device))
    with pytest.raises(ValueError):
        sort_cuda.sort_rows(torch.zeros((8, 2), dtype=torch.int64,
                                        device=cuda_device).t())


def _config_events(name, n: int = 384):
    """The first ``n`` events of the benchmark's configuration ``name`` (its
    JSON under port_bench/configs, read as data: the detector, the
    kinematics and its seed, the physics window), sampled on the card by
    the port's kinematics pipeline: (Config, proton numbers, mass numbers,
    vertices, momenta, the configuration's engine section)."""
    import json

    from attpc_engine_tpu_torch.kinematics import (
        Decay,
        ExcitationGaussian,
        KinematicsPipeline,
        KinematicsTargetMaterial,
        PolarUniform,
        Reaction,
    )

    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    d, kin, e = cfg["detector"], cfg["kinematics"], cfg["engine"]
    gas = GasTarget([tuple(c) for c in d["gas_components"]],
                    float(d["gas_pressure_torr"]), nuclear_map)
    config = Config(
        DetectorParams(length=d["length"], efield=d["efield"],
                       bfield=d["bfield"], mpgd_gain=d["mpgd_gain"],
                       gas_target=gas, diffusion=d["diffusion"],
                       fano_factor=d["fano_factor"], w_value=d["w_value"]),
        ElectronicsParams(**cfg["electronics"]), PadParams())
    nucleus = lambda za: nuclear_map.get_data(*za)  # noqa: E731
    steps = [Reaction(*(nucleus(s["reaction"][k]) for k in
                        ("target", "projectile", "ejectile")))
             if "reaction" in s else
             Decay(nucleus(s["decay"]["parent"]),
                   nucleus(s["decay"]["residual_1"]))
             for s in kin["steps"]]
    tm = kin["target_material"]
    pipe = KinematicsPipeline(
        steps, [ExcitationGaussian(s["excitation"]["centroid"],
                                   s["excitation"]["width"])
                for s in kin["steps"]],
        [PolarUniform(s["polar"]["min"], s["polar"]["max"])
         for s in kin["steps"]], kin["beam_energy"],
        target_material=KinematicsTargetMaterial(
            gas, tuple(tm["z_range"]), tm["rho_sigma"]), device="cuda")
    batch = pipe.sample_events(n, int(kin["seed"]))
    assert bool(batch.accepted.all())
    return (config, pipe.get_proton_numbers(), pipe.get_mass_numbers(),
            batch.vertices.cpu().numpy(), batch.momenta.cpu().numpy(), e)


def _config_step(name, point_budget, monkeypatch):
    """The first 384 events of the benchmark's configuration ``name``
    (``_config_events``) run through the port's default step at
    ``point_budget``: the rows and prefixes the step hands its merge sort
    (K3's live route), and the step's outputs."""
    config, z, a, vertices, momenta, e = _config_events(name)
    sim = DetectorSimulator(
        config, z, a,
        engine=EngineParams(events_per_batch=384, point_budget=point_budget,
                            n_time_steps=int(e["n_time_steps"]),
                            dt=float(e["dt"]),
                            chunk_steps=int(e["chunk_steps"])),
        device="cuda")
    seen = []
    real = deposition.sort_rows_live

    def spy(rows, lanes):
        seen.append((rows.clone(), lanes.clone()))
        return real(rows, lanes)

    monkeypatch.setattr(deposition, "sort_rows_live", spy)
    out = sim.simulate_batch(vertices, momenta, seed=5, assemble=False)
    monkeypatch.setattr(deposition, "sort_rows_live", real)
    return sim, (vertices, momenta), seen, out


def _cell_like(w, lanes, seed):
    """int64 rows [len(lanes), w] on the card, merge-like inside each
    prefix (a fifth of the lanes dead), the sentinel past it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lanes = lanes.to("cuda")
    shape = (len(lanes), w)
    inside = torch.arange(w, device="cuda")[None, :] < lanes[:, None]
    live = inside & (torch.rand(shape, generator=g, device="cuda") > 0.2)
    key = torch.randint(0, 2**23, shape, generator=g, device="cuda")
    q = torch.rand(shape, generator=g, device="cuda") * 100
    return sort_cuda.pack64(torch.where(live, key, SENT).to(torch.int32),
                            torch.where(live, q, 0.0))


@pytest.mark.parametrize("name,point_budget", [
    ("c16dd_d2_184MeV", 1920), ("b10_3he_chain_24MeV", 8192)])
def test_live_sort_of_the_default_steps_rows(cuda_device, monkeypatch, name,
                                             point_budget):
    """K3's live route on the rows the default step hands it for the
    first 384 events of each benchmark configuration at its tuned point
    budget ([384, 192000] and [384, 819200]): the rows of torch.sort of
    the whole row (the plain version) bit for bit, one live call
    (launches and launches_live each up by one, no generic route), and the
    step's merged cloud, converted rows and metadata are those of the same
    step with its merge sort done by torch.sort at full width."""
    sim, (vertices, momenta), seen, out = _config_step(name, point_budget,
                                                       monkeypatch)
    ((rows, lanes),) = seen
    assert rows.shape == (384, point_budget * 100)
    before = (sort_cuda.launches, sort_cuda.launches_live,
              sort_cuda.launches_cluster, sort_cuda.launches_wide)
    got = sort_cuda.sort_rows_live(rows.clone(), lanes)
    after = (sort_cuda.launches, sort_cuda.launches_live,
             sort_cuda.launches_cluster, sort_cuda.launches_wide)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0, 0)
    assert torch.equal(got, sort_cuda.sort_rows_plain(rows))
    sites = sort_cuda.live_sites(lanes.cpu().numpy())
    assert sum(sites.values()) == 384
    if point_budget == 8192:
        assert sites.get("wide", 0) > 0  # the chain's widest events

    monkeypatch.setattr(deposition, "sort_rows_live",
                        lambda r, la: sort_cuda.sort_rows_plain(r))
    full = sim.simulate_batch(vertices, momenta, seed=5, assemble=False)
    for key in ("pads", "tbs_i", "charges", "labels", "events", "counts",
                "n_points", "packed", "spyral_counts", "meta_i32"):
        a, b = out[key], full[key]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), key


@pytest.mark.parametrize("w", [192000, 512000, 819200])
def test_live_sort_edge_rows(cuda_device, w):
    """K3's live route against torch.sort of the whole row on 384 rows:
    the edge prefixes (0, 1, a cluster of 1, 4, 8 and 16 CTAs' 13,360
    lanes and one either side, the whole row) with scattered sentinels,
    none, only sentinels and equal keys of different charges, then
    merge-like rows of random prefixes; at c16dd's and the chain's widths
    and at point budget 5,120, whose fourth merge pass needs more split
    entries than its first. Allocates no more than one scratch like the
    rows and its small tables where a prefix can pass 8 CTAs, else
    < 1 MiB."""
    edges = [v for v in LIVE_EDGES if v <= w] + [w]
    parts = [live_rows(w, edges, case, seed=w)
             for case in ("scattered", "no_sentinel", "all_sentinel",
                          "equal_keys")]
    x = torch.cat(parts).to(cuda_device)
    lanes = torch.tensor(edges * len(parts), dtype=torch.int32)
    n = 384 - len(lanes)
    extra = torch.randint(0, w + 1, (n,), generator=torch.Generator()
                          .manual_seed(w), dtype=torch.int32)
    x = torch.cat([x, _cell_like(w, extra, w)])
    lanes = torch.cat([lanes, extra]).to(cuda_device)
    ref = sort_cuda.sort_rows_plain(x)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = sort_cuda.sort_rows_live(x, lanes)
    more = torch.cuda.max_memory_allocated() - allocated
    assert got.data_ptr() == x.data_ptr()  # in place
    assert torch.equal(got, ref)
    wide = w > sort_cuda.LIVE_CLUSTER_LANES
    assert more <= (x.numel() * 8 if wide else 0) + (1 << 20)


def test_live_sort_launches_by_route(cuda_device, monkeypatch):
    """The live route launches, on a stream, the cluster routes a row of
    the width could need and, past 8 CTAs, the wide route's chunk sort
    and its merge passes (a partition and a tile kernel each), each
    launch's kernel named as K3's kernels are (radix_cluster_kernel,
    merge_partition_kernel, merge_tile_kernel), so that the benchmark's
    share of K3's bound times every launch."""
    from torch.profiler import ProfilerActivity, profile

    for w in (100000, 192000, 819200):
        plan = live_plan(w)
        n_launches = sum(1 + 2 * p.passes for p in plan)
        lanes = torch.full((8,), w // 2, dtype=torch.int32)
        x = _cell_like(w, lanes, 3)
        sort_cuda.sort_rows_live(x.clone(), lanes.to(cuda_device))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sort_cuda.sort_rows_live(x.clone(), lanes.to(cuda_device))
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "kernel" in e.name.lower()]
        ours = [n for n in names if "radix_cluster_kernel" in n
                or "merge_partition_kernel" in n or "merge_tile_kernel" in n]
        clone = [n for n in names if n not in ours]
        assert len(ours) == n_launches, names
        assert not clone, names
        assert [p.site for p in plan] == ["cluster-1", "cluster-2",
                                          "cluster-4", "cluster-8"] + (
            ["wide"] if w > sort_cuda.LIVE_CLUSTER_LANES else [])


def test_deposit_kernel_matches_plain(cuda_device):
    sim, _, _ = _simulator(cuda_device)
    rng = np.random.default_rng(1)
    p = 5000
    ix = rng.integers(-5, 565, (p, 10)).astype(np.int32)
    iy = rng.integers(-5, 645, (p, 10)).astype(np.int32)
    ix[rng.random((p, 10)) < 0.1] = 559
    iy[rng.random((p, 10)) < 0.1] = 639
    tbr = rng.integers(0, 1024, p).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (ix, iy, tbr)]
    ref = deposit_cuda.packed_key_lookup_plain(*args, sim.pad_table, 1, SENT)
    got = deposit_cuda.packed_key_lookup(*args, sim.pad_table, 1, SENT)
    assert torch.equal(got, ref)
    with pytest.raises(ValueError):  # wrong dtype: raise, no fallback
        deposit_cuda.packed_key_lookup(args[0].long(), *args[1:],
                                       sim.pad_table, 1, SENT)


def _rows_points(e: int, pb: int, seed: int):
    """Compacted points [E, pb] with every edge case of the deposit rows
    mixed in: sigma == 0 (tb_f 0), empty slots with junk values, points off
    the pad plane, tb_f in (-1, 0)."""
    rng = np.random.default_rng(seed)
    shape = (e, pb)
    px = rng.normal(0.0, 0.12, shape)
    py = rng.normal(0.02, 0.12, shape)
    ptbf = rng.uniform(0.0, 511.9, shape)
    pne = rng.integers(1, 4000, shape).astype(np.float64)
    taken = rng.random(shape) < 0.85
    case = rng.integers(0, 4, shape)
    ptbf[case == 0] = 0.0
    pne[~taken] = rng.integers(-50, 2, (~taken).sum())
    px[case == 2] = rng.uniform(0.27, 0.4, (case == 2).sum())
    ptbf[case == 3] = rng.uniform(-0.999, -1e-6, (case == 3).sum())
    ptbf = ptbf.astype(np.float32)
    tbr = (ptbf.astype(np.int32) << 1) | rng.integers(0, 2, shape).astype(
        np.int32)
    return [px.astype(np.float32), py.astype(np.float32), ptbf,
            pne.astype(np.float32), tbr, taken]


def test_deposit_rows_kernel_matches_plain(cuda_device):
    """The deposit-rows kernel against its plain version on the card, bit
    for bit, with every edge case and P not a multiple of the block."""
    sim, _, _ = _simulator(cuda_device)
    dp = sim.config.det_params
    pts = [torch.from_numpy(a).to(cuda_device)
           for a in _rows_points(7, 1003, 3)]
    args = (*pts, sim.pad_table, sim._grid_lo_mm, sim._grid_n_mm,
            dp.diffusion, dp.efield, sim.config.drift_velocity, 1)
    before = deposit_cuda.launches_deposit_rows
    got = deposition.deposit_rows(*args)
    assert deposit_cuda.launches_deposit_rows == before + 1
    ref = deposition.deposit_rows_plain(*args)
    assert torch.equal(got, ref)
    keys = got >> 32
    assert (keys == SENT).any() and (keys != SENT).any()
    with pytest.raises(ValueError):  # wrong dtype: raise, no fallback
        deposition.deposit_rows(*pts[:4], pts[4].long(), *args[5:])


def test_default_step_takes_the_rows_kernel(cuda_device):
    """The default configuration launches the deposit-rows kernel and not
    K2; the fused-merge, two-stage one launches K2 and K5's cluster route
    once, and not K6 or the rows kernel."""
    def counts():
        return (deposit_cuda.launches_deposit_rows, deposit_cuda.launches,
                merge_cuda.launches_cluster, deposit_cuda.launches_rows)

    for cfg, expect in (({}, (1, 0, 0, 0)),
                        (dict(merge="fused", lookup="two_stage"),
                         (0, 1, 1, 0))):
        sim, vert, mom = _simulator(cuda_device, n_time_steps=1000,
                                    events_per_batch=8, **cfg)
        before = counts()
        sim.simulate_batch(vert[:8], mom[:8], seed=1, assemble=False)
        assert tuple(a - b for a, b in zip(counts(), before)) == expect


def test_default_step_compacts_runs_in_one_kernel(cuda_device):
    """The default step sorts its merge rows once with K3 and compacts the
    run ends with one call of the compaction kernel, where the TPU path
    sorts them a second time: K3 twice a step (the merge sort and the
    convert sort), the compaction once. The fused step launches no
    compaction (K5 merges) and K3 once, for the convert."""
    def counts():
        return compact_cuda.launches, sort_cuda.launches

    for cfg, expect in (({}, (1, 2)),
                        (dict(merge="fused", lookup="two_stage"), (0, 1))):
        sim, vert, mom = _simulator(cuda_device, n_time_steps=1000,
                                    events_per_batch=8, **cfg)
        for start in (0, 8):
            before = counts()
            sim.simulate_batch(vert[start:start + 8], mom[start:start + 8],
                               seed=1, event_start=start, assemble=False)
            assert tuple(a - b for a, b in zip(counts(), before)) == expect


def _same_bits(got, ref):
    for g, r in zip(got, ref):
        r = r.to(g.device)
        assert g.dtype == r.dtype and g.shape == r.shape
        if g.is_floating_point():
            g, r = g.view(torch.int32), r.view(torch.int32)
        assert torch.equal(g, r)


@pytest.mark.parametrize("w", [1, 16, 17, 4103, 12288, 192000, 213761,
                               819200, 1638400])
def test_compaction_kernel_matches_plain(cuda_device, w):
    """The run-end compaction against its plain version, bit for bit in
    key2, c2 and n_uniq, and ``_merge_rows`` on the card (K3 then the
    kernel, one launch a call) against ``_merge_rows`` on the CPU in key2,
    sums, valid2 and n_uniq: widths of one lane, one and two blocks of 16,
    ragged tiles, c16dd's and the chain's merge rows and the chain's first
    retry doubling; a row of dead lanes only, runs across every tile
    boundary, caps below and above n_uniq, rank_bits 1 and 2."""
    for rank_bits in (1, 2):
        rows = merge_rows(w, rank_bits)
        srt = torch.sort(rows, dim=1).values
        rows_dev, srt_dev = rows.to(cuda_device), srt.to(cuda_device)
        for cap in (max(1, w // 7), w):
            got = deposition.compact_runs(srt_dev, cap, rank_bits)
            ref = deposition.compact_runs_plain(srt, cap, rank_bits)
            _same_bits(got, ref)
            assert int(ref[2][1]) == 0 and int(ref[2][3]) > 0
            if cap < w and w > 16:
                assert int(ref[2].max()) > cap
            before = compact_cuda.launches
            got = deposition._merge_rows(rows_dev, cap, rank_bits)
            assert compact_cuda.launches == before + 1
            _same_bits(got, deposition._merge_rows(rows, cap, rank_bits))


def test_compaction_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.zeros((3, 40), dtype=torch.int64, device=cuda_device)
    for bad in ((x.int(), 4, 1), (x, 41, 1), (x, -1, 1), (x, 4, 31),
                (x[:, ::2], 4, 1), (x[0], 4, 1)):
        with pytest.raises(ValueError):
            compact_cuda.compact_runs_cuda(*bad)


def test_rows_and_pad_lookup_kernels_match_plain(cuda_device):
    """K6 against its plain version and K2; K7 against its plain version,
    out-of-plane pixels included; P not a multiple of the block."""
    sim, _, _ = _simulator(cuda_device)
    rng = np.random.default_rng(2)
    p = 5003
    ix = rng.integers(-5, 565, (p, 10)).astype(np.int32)
    iy = rng.integers(-5, 645, (p, 10)).astype(np.int32)
    tbr = rng.integers(0, 2048, p).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (ix, iy, tbr)]
    ref = deposit_cuda.packed_key_lookup_plain(*args, sim.pad_table, 2, SENT)
    got = deposit_cuda.packed_key_lookup_rows(*args, sim.pad_table, 2, SENT)
    assert torch.equal(got, ref)
    assert torch.equal(got, deposit_cuda.packed_key_lookup_cuda(
        *args, sim.pad_table, 2, SENT))
    pads = deposit_cuda.pad_lookup(args[0], args[1], sim.pad_table)
    assert torch.equal(pads, deposit_cuda.pad_lookup_plain(
        args[0], args[1], sim.pad_table))
    with pytest.raises(ValueError):
        deposit_cuda.pad_lookup(args[0][:, :9].contiguous(), args[1],
                                sim.pad_table)


@pytest.mark.parametrize("e,w,cap,rank_bits", [
    (3, 700, 100, 2), (4, 12800, 4096, 1), (2, 102400, 12288, 1),
    (2, 2**18, 12288, 2),
])
def test_fused_merge_kernel_matches_plain(cuda_device, e, w, cap, rank_bits):
    """K5 against its plain version: key2 and n_uniq exact, c2 bit-exact;
    a row of sentinels, widths that are not powers of two, caps that are
    not multiples of 128 or lie below n_uniq."""
    rng = np.random.default_rng(w)
    space = np.sort(rng.integers(0, w // 4, (e, w)), axis=1).astype(np.int32)
    packed = (space << rank_bits) | rng.integers(
        0, 1 << rank_bits, (e, w)).astype(np.int32)
    qv = np.abs(rng.normal(100.0, 30.0, (e, w))).astype(np.float32)
    dead = rng.random((e, w)) < 0.3
    packed[dead] = SENT
    qv[dead] = 0.0
    packed[1] = SENT
    qv[1] = 0.0
    args = (torch.from_numpy(packed).to(cuda_device),
            torch.from_numpy(qv).to(cuda_device), cap, rank_bits)
    got = merge_cuda.merge_runs_fused(*args)
    ref = merge_cuda.merge_runs_fused_plain(*args)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])
    assert torch.equal(got[1].view(torch.int32), ref[1].view(torch.int32))
    assert int(got[2][1]) == 0 and int(got[2][0]) > 0


@pytest.mark.parametrize("p", [1, 3, 5003, 40_001])
def test_rows_lookup_kernel_ragged_points(cuda_device, p):
    """K6's staged 16-byte stores where P * 10 is not a multiple of 32 (the
    last warp holds fewer than 32 rows): bit-exact against its plain
    version and K2."""
    sim, _, _ = _simulator(cuda_device)
    rng = np.random.default_rng(p)
    ix = rng.integers(-5, 565, (p, 10)).astype(np.int32)
    iy = rng.integers(-5, 645, (p, 10)).astype(np.int32)
    tbr = rng.integers(0, 1024, p).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (ix, iy, tbr)]
    before = deposit_cuda.launches_rows
    got = deposit_cuda.packed_key_lookup_rows(*args, sim.pad_table, 1, SENT)
    assert deposit_cuda.launches_rows == before + 1
    assert torch.equal(got, deposit_cuda.packed_key_lookup_plain(
        *args, sim.pad_table, 1, SENT))
    assert torch.equal(got, deposit_cuda.packed_key_lookup_cuda(
        *args, sim.pad_table, 1, SENT))


@pytest.mark.parametrize("p", [1, 3, 5003, 40_001])
def test_quad_lookup_kernels_ragged_points(cuda_device, p):
    """K2 and K7, one quad kernel, where the last block holds fewer quads
    than threads: bit-exact against their plain versions, one launch a call,
    with out-of-plane cells (clamped onto the table's edges) and cells
    aliased onto its sentinel padding (row 0 of point 0 wholly); also on
    inputs that start one point into their allocation."""
    sim, _, _ = _simulator(cuda_device)
    rng = np.random.default_rng(p)
    ix = rng.integers(-5, 565, (p + 1, 10)).astype(np.int32)
    iy = rng.integers(-5, 645, (p + 1, 10)).astype(np.int32)
    ix[rng.random((p + 1, 10)) < 0.1] = 559
    iy[rng.random((p + 1, 10)) < 0.1] = 639
    ix[:, 0] = 559
    tbr = rng.integers(0, 1024, p + 1).astype(np.int32)
    full = [torch.from_numpy(a).to(cuda_device) for a in (ix, iy, tbr)]
    table = sim.pad_table
    for args in ([a[:p] for a in full], [a[1:] for a in full]):
        before = deposit_cuda.launches
        keys = deposit_cuda.packed_key_lookup(*args, table, 1, SENT)
        assert deposit_cuda.launches == before + 1
        assert torch.equal(keys, deposit_cuda.packed_key_lookup_plain(
            *args, table, 1, SENT))
        before = deposit_cuda.launches_pad_lookup
        pads = deposit_cuda.pad_lookup(args[0], args[1], table)
        assert deposit_cuda.launches_pad_lookup == before + 1
        assert torch.equal(pads, deposit_cuda.pad_lookup_plain(
            args[0], args[1], table))
        assert (keys[:, 0] == SENT).all() and (pads[:, 0] == 10240).all()
        assert (keys != SENT).any()


def _merge_edge_rows(w: int, rank_bits: int):
    """Merge rows [6, w]: sentinels only (0), no sentinel (1), one live
    lane (2), runs of ~w / 20 equal keys across every CTA boundary (3),
    and rows with 30 % dead lanes and whole charges, so that equal (key,
    charge) elements occur (4, 5)."""
    rng = np.random.default_rng(w)
    e = 6
    space = rng.integers(0, max(1, w // 4), (e, w)).astype(np.int32)
    space[3] = rng.integers(0, 20, w)
    packed = (space << rank_bits) | rng.integers(
        0, 1 << rank_bits, (e, w)).astype(np.int32)
    qv = np.floor(rng.uniform(0.0, 300.0, (e, w))).astype(np.float32)
    dead = rng.random((e, w)) < 0.3
    dead[0] = True
    dead[1] = False
    dead[2] = True
    dead[2, w // 2] = False
    packed[dead] = SENT
    qv[dead] = 0.0
    return packed, qv


@pytest.mark.parametrize("w,n_cta", [
    (1, 1), (700, 1), (12289, 1), (25600, 2), (51200, 4), (100003, 8),
    (204800, 16), (213760, 16),
])
def test_cluster_merge_kernel_edge_cases(cuda_device, w, n_cta):
    """K5's cluster route against its plain version at each cluster size:
    key2 and n_uniq exact, c2 bit-exact; rows of sentinels only, of no
    sentinel (the widest fills 16 CTAs of 13,440), of one live lane, runs
    across CTA boundaries, widths not multiples of 128, a cap below n_uniq
    that is not a multiple of 128 and the cap 12,288; one launch a call,
    counted on its route."""
    assert merge_cuda.route(w)[:2] == ("cluster", n_cta)
    for cap, rank_bits in ((100, 2), (12288, 1)):
        packed, qv = _merge_edge_rows(w, rank_bits)
        args = (torch.from_numpy(packed).to(cuda_device),
                torch.from_numpy(qv).to(cuda_device), cap, rank_bits)
        before = (merge_cuda.launches_cluster, merge_cuda.launches_two_launch)
        got = merge_cuda.merge_runs_fused(*args)
        after = (merge_cuda.launches_cluster, merge_cuda.launches_two_launch)
        assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
        ref = merge_cuda.merge_runs_fused_plain(*args)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])
        assert torch.equal(got[1].view(torch.int32), ref[1].view(torch.int32))
        assert int(got[2][0]) == 0 and int(got[2][2]) == 1


def test_merge_routes_by_width(cuda_device):
    """Rows past 16 x 13,360 lanes take the two-launch route (pack64, K3 on
    its wide route, the tail kernel), bit-exact; the cluster route raises
    on what it cannot take."""
    packed, qv = _merge_edge_rows(250_000, 1)
    args = (torch.from_numpy(packed[:3]).to(cuda_device),
            torch.from_numpy(qv[:3]).to(cuda_device), 12288, 1)
    before = (merge_cuda.launches_cluster, merge_cuda.launches_two_launch)
    got = merge_cuda.merge_runs_fused(*args)
    after = (merge_cuda.launches_cluster, merge_cuda.launches_two_launch)
    assert (after[0] - before[0], after[1] - before[1]) == (0, 1)
    ref = merge_cuda.merge_runs_fused_plain(*args)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[2], ref[2])
    assert torch.equal(got[1].view(torch.int32), ref[1].view(torch.int32))
    with pytest.raises(ValueError):
        merge_cuda.merge_runs_fused(args[0].long(), *args[1:])


def test_fused_step_builds_no_int64_merge_rows(cuda_device, monkeypatch):
    """The fused step's K5 call runs the cluster kernel on its int32 keys
    and f32 charges: no pack64, and nothing allocated but its outputs (an
    [E, W] int64 buffer would be 8 x 102,400 x 8 B)."""
    sim, vert, mom = _simulator(cuda_device, n_time_steps=1000,
                                events_per_batch=8, merge="fused",
                                lookup="one_stage")

    def no_pack64(*args):
        raise AssertionError("pack64 on K5's cluster route")

    monkeypatch.setattr(merge_cuda, "pack64", no_pack64)
    seen = []
    real = deposition.merge_runs_fused

    def spy(packed, qv, cap, rank_bits):
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = real(packed, qv, cap, rank_bits)
        seen.append((torch.cuda.max_memory_allocated() - allocated,
                     packed.shape, cap))
        return out

    monkeypatch.setattr(deposition, "merge_runs_fused", spy)
    before = merge_cuda.launches_cluster
    sim.simulate_batch(vert[:8], mom[:8], seed=1, assemble=False)
    assert merge_cuda.launches_cluster == before + 1
    (extra, (e, w), cap), = seen
    assert extra <= e * cap * 8 + e * 4 + (1 << 20) < e * w * 8


def test_step_on_card_agrees_with_cpu(cuda_device):
    """Eight flagship events through the kernels and through the plain
    versions on the CPU: the devices round logf differently, so per event
    the kept and merged row counts agree within 2 % and the total kept
    charge within 1 %."""
    kw = dict(n_time_steps=1000, events_per_batch=8)
    outs = []
    for device in (cuda_device, "cpu"):
        sim, vert, mom = _simulator(device, **kw)
        out = sim.simulate_batch(vert[:8], mom[:8], seed=1)
        outs.append((out["meta_i32"].cpu().numpy(),
                     out["spyral"][:, 4].sum()))
    (mg, qg), (mc, qc) = outs
    np.testing.assert_allclose(mg[:8], mc[:8], rtol=0.02)
    np.testing.assert_allclose(mg[16:24], mc[16:24], rtol=0.02)
    assert abs(qg - qc) <= 0.01 * qc


def test_fused_step_on_card_agrees_with_default(cuda_device):
    """Eight flagship events on the card in the fused, one-stage
    configuration against the default one: the merged cloud's integers
    exact, charges within rtol 1e-5 with a one-electron floor."""
    outs = []
    for cfg in ({}, dict(merge="fused", lookup="one_stage")):
        sim, vert, mom = _simulator(cuda_device, n_time_steps=1000,
                                    events_per_batch=8, **cfg)
        outs.append(sim.simulate_batch(vert[:8], mom[:8], seed=1,
                                       assemble=False))
    d, f = outs
    for name in ("pads", "tbs_i", "labels", "cloud_valid", "counts"):
        assert torch.equal(d[name], f[name]), name
    gain = float(sim.config.det_params.mpgd_gain)
    torch.testing.assert_close(f["charges"] / gain, d["charges"] / gain,
                               rtol=1e-5, atol=1.0)


class _ArrayReader:
    """A kinematics reader over the committed events in memory (the card
    has no h5py)."""

    def __init__(self, n_events: int):
        data = np.load(SMOKE)
        self.vertices = data["vertices"][:n_events]
        self.momenta = data["momenta"][:n_events]
        self.proton_numbers = data["proton_numbers"]
        self.mass_numbers = data["mass_numbers"]
        self.n_events = n_events

    def read_range(self, start, stop):
        return self.vertices[start:stop], self.momenta[start:stop]

    def close(self):
        pass


class _PoolWriter:
    def __init__(self):
        self.batches = []

    def write_spyral_pool(self, spyral, labels, counts, event_numbers,
                          raw_counts=None):
        self.batches.append((spyral, labels, counts, event_numbers))

    def close(self):
        pass


def test_run_reader_on_the_card(cuda_device):
    """run_simulation's batch loop on the card (probe, tuning, the pinned
    copy in flight, the writer thread): the tuned run's assembled rows
    equal an untuned run's bit for bit, and its kept rows the CPU run's
    within 2 % (the devices round logf differently)."""
    from attpc_engine_tpu_torch.detector.simulator import run_reader

    sim, _, _ = _simulator("cpu")
    engine = EngineParams(n_time_steps=1000, chunk_steps=250,
                          events_per_batch=8)
    runs = {}
    for name, device, auto in (("tuned", cuda_device, True),
                               ("pinned", cuda_device, False),
                               ("cpu", "cpu", True)):
        writer = _PoolWriter()
        stats = run_reader(sim.config, _ArrayReader(24), writer,
                           engine=engine, seed=3, show_progress=False,
                           auto_tune=auto, device=device)
        runs[name] = (stats, writer.batches)
    assert runs["tuned"][0]["budgets"]["steps"] == 500
    assert runs["pinned"][0]["budgets"]["steps"] == 1000
    assert len(runs["tuned"][1]) == len(runs["pinned"][1]) == 3
    for a, b in zip(runs["tuned"][1], runs["pinned"][1]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    kept_gpu, kept_cpu = runs["tuned"][0]["rows"], runs["cpu"][0]["rows"]
    assert kept_gpu > 0 and abs(kept_gpu - kept_cpu) <= 0.02 * kept_cpu


@pytest.mark.parametrize("n_sources", [1, 2],
                         ids=["one_source", "two_sources"])
def test_host_copies_reuse_buffers_of_two_sizes(cuda_device, n_sources):
    """The driver's pinned copies with buffers of two sizes in the pool:
    a copy that fits only the second takes it (once a crash in
    ``list.remove``), and every copy, of one shard's rows or of two
    shards' end to end, reads back its rows, each shard's wait counted at
    its site."""
    from attpc_engine_tpu_torch.detector.driver import _HostCopies

    copies = _HostCopies(cuda_device)
    q = copies.ROWS_QUANTUM
    # the fifth copy finds [q rows, 2q rows] free and takes the second
    rows = [q + 10, 10, 10, q + 10, q + 10, 10]
    sites = [f"copy-finish.card-{k}" for k in range(n_sources)]
    srcs = [[torch.full((len(part), 2), i, dtype=torch.int32,
                        device=cuda_device)
             for part in np.array_split(np.arange(n), n_sources)]
            for i, n in enumerate(rows)]
    pending = None
    for i, src in enumerate(srcs):
        handle = copies.start(src, sites)
        if pending is not None:
            j, h = pending
            assert np.array_equal(copies.finish(h),
                                  torch.cat(srcs[j]).cpu().numpy())
        pending = (i, handle)
    j, h = pending
    assert np.array_equal(copies.finish(h), torch.cat(srcs[j]).cpu().numpy())
    assert len(copies.free) >= 2
    assert copies.times.counters["syncs"] == {site: len(rows)
                                              for site in sites}


def test_host_copies_lend_pinned_rows(cuda_device):
    """The driver's copies of assembled rows lent to the writer: the views
    hold the rows, a buffer whose array the writer kept leaves the pool,
    and the next copy into a recycled buffer leaves the kept rows alone."""
    from attpc_engine_tpu_torch.detector.driver import _HostCopies

    copies = _HostCopies(cuda_device)
    kept = []
    srcs = [torch.full((1000, 8), float(i), dtype=torch.float64,
                       device=cuda_device) for i in range(4)]
    for i, src in enumerate(srcs):
        handle = copies.start([src], ["copy-finish"])

        def use(rows, i=i):
            assert rows.shape == (1000, 8) and (rows == i).all()
            if i == 1:
                kept.append(rows)

        copies.lend([handle], use)
    assert (kept[0] == 1).all()
    assert len(copies.free) == 1  # the kept buffer left the pool


@pytest.mark.parametrize("chain", ["chain", "resample"])
def test_kinematics_on_the_card_equals_cpu(cuda_device, chain):
    """The kinematics stage on the card against the CPU on the same seed:
    accepted lanes and the draw that accepted each exact, momenta within
    1e-9 MeV, vertices within 1e-12 m (the devices round the transcendental
    functions differently by an ulp; the Philox words are the same)."""
    from attpc_engine_tpu_torch.kinematics import (
        Decay,
        ExcitationGaussian,
        ExcitationUniform,
        KinematicsPipeline,
        PolarUniform,
        Reaction,
    )

    d = nuclear_map.get_data
    if chain == "chain":
        steps = [Reaction(d(5, 10), d(2, 3), d(2, 4)),
                 Decay(d(5, 9), d(2, 4)), Decay(d(3, 5), d(2, 4))]
        exc = [ExcitationGaussian(16.8, 0.2), ExcitationGaussian(0.0, 1.25),
               ExcitationGaussian(0.0, 0.0)]
        beam = 24.0
    else:
        steps = [Reaction(d(6, 12), d(1, 2), d(1, 1))]
        exc = [ExcitationUniform(0.0, 30.0)]
        beam = 16.0
    pipe = KinematicsPipeline(steps, exc,
                              [PolarUniform(0.0, np.pi) for _ in steps], beam,
                              device=cuda_device)
    gpu = pipe.sample_events(8192, seed=19)
    cpu = pipe.sample_events(8192, seed=19, device="cpu")
    assert gpu.draws == cpu.draws
    assert torch.equal(gpu.accepted.cpu(), cpu.accepted)
    assert torch.equal(gpu.accepted_at.cpu(), cpu.accepted_at)
    assert bool(cpu.accepted.all())
    torch.testing.assert_close(gpu.momenta.cpu(), cpu.momenta, rtol=0,
                               atol=1e-9)
    torch.testing.assert_close(gpu.vertices.cpu(), cpu.vertices, rtol=0,
                               atol=1e-12)


def test_concurrent_first_users_run_one_build(cuda_device, tmp_path):
    """Two processes that call ``kernels.library()`` at once on a fresh
    build directory: one compiles, the other waits on the lock and loads
    the same library without compiling."""
    import json
    import subprocess
    import sys

    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        f"sys.path.insert(0, {str(Path(__file__).resolve().parents[1])!r})\n"
        "from attpc_engine_tpu_torch import kernels\n"
        "kernels.BUILD_DIR = Path(sys.argv[1])\n"
        "kernels.library()\n"
        "print(json.dumps(kernels.build_seconds()))\n"
    )
    build = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=900)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    builds = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert sorted(b["built"] for b in builds) == [False, True]
    assert builds[0]["library"] == builds[1]["library"]
    assert [p.name for p in build.glob("*.so")] == [builds[0]["library"]]


def _bits(x: torch.Tensor | np.ndarray) -> np.ndarray:
    x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
    return np.ascontiguousarray(x).view(np.int64)


def _assemble_args(packed, counts, events):
    return (torch.from_numpy(packed).cuda(),
            torch.from_numpy(counts).to("cuda", torch.int32),
            torch.from_numpy(np.asarray(events, np.int64)).cuda())


def test_assemble_kernel_matches_plain_and_the_cpp_library(cuda_device):
    """The assembly kernel against its plain version on the card and the
    C++ library (``native_assemble_batch``) on the host, bit for bit: the
    step's rows of 16 flagship events and every edge case of
    tests/assemble_cases.py, seeds 0 and past 2^63, event ids from 0 and
    past 2^32; one launch a call."""
    from attpc_engine_tpu_torch.detector.assemble import assemble_plain
    from attpc_engine_tpu_torch.native import native_assemble_batch

    sim, vert, mom = _simulator(cuda_device, n_time_steps=1000,
                                events_per_batch=16)
    out = sim.simulate_batch(vert[:16], mom[:16], seed=1, assemble=False)
    counts = out["spyral_counts"].cpu().numpy().astype(np.int64)
    step = (out["packed"][:counts.sum()].cpu().numpy(), counts)
    edge = pool(edge_events(sim._native_tables(), np.random.default_rng(4)))
    tables = sim._assemble_tables()
    for packed, counts in (step, edge):
        assert counts.sum() > 100
        for seed, first in ((0, 0), (2**63 + 12345, 2**32 + 9)):
            events = np.arange(first, first + len(counts))
            args = _assemble_args(packed, counts, events)
            before = assemble_cuda.launches
            got = assemble_cuda.assemble_cuda(*args, seed, tables)
            torch.cuda.synchronize()
            assert assemble_cuda.launches == before + 1
            plain = assemble_plain(*args, seed, tables)
            ref = native_assemble_batch(packed, counts, first, seed,
                                        sim._native_tables())
            assert ref is not None
            for g, p, r in zip(got, plain, ref):
                np.testing.assert_array_equal(_bits(g), _bits(p))
                np.testing.assert_array_equal(_bits(g), _bits(r))


def test_assemble_kernel_keeps_ties_of_a_rounded_wiggle(cuda_device):
    """A forged wiggle that rounds tb + w up to the next integer tb: the
    kernel keeps the stable order over the whole event, as its plain
    version does."""
    from attpc_engine_tpu_torch.detector.assemble import assemble_plain

    sim, _, _ = _simulator(cuda_device)
    packed, counts, wiggle, n = forged_tie()
    args = _assemble_args(packed, counts, np.arange(2))
    w = torch.from_numpy(wiggle).cuda()
    tables = sim._assemble_tables()
    got = assemble_cuda.assemble_cuda(*args, 3, tables, wiggle=w)
    plain = assemble_plain(*args, 3, tables, wiggle=w)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(_bits(g), _bits(p))
    order = got[0][:n, 5].long().cpu().numpy() - 100
    assert order[:4].tolist() == [0, 2, 1, 3]


def test_assemble_kernel_rejects_what_it_cannot_take(cuda_device):
    sim, _, _ = _simulator(cuda_device)
    packed, counts, _, _ = forged_tie()
    args = _assemble_args(packed, counts, np.arange(2))
    tables = sim._assemble_tables()
    with pytest.raises(ValueError):
        assemble_cuda.assemble_cuda(args[0].cpu(), *args[1:], 1, tables)
    with pytest.raises(ValueError):
        assemble_cuda.assemble_cuda(args[0], args[1].long(), args[2], 1,
                                    tables)
    with pytest.raises(ValueError):
        assemble_cuda.assemble_cuda(args[0][:, :1].contiguous(), *args[1:],
                                    1, tables)


def test_run_reader_assembles_on_the_card(cuda_device, monkeypatch):
    """The driver's in-process path on the card: one assembly launch a
    batch, no host assembly, and rows equal to the host assembly of the
    same packed rows."""
    from attpc_engine_tpu_torch import native
    from attpc_engine_tpu_torch.detector import simulator
    from attpc_engine_tpu_torch.detector.simulator import run_reader

    engine = EngineParams(n_time_steps=1000, chunk_steps=250,
                          events_per_batch=8)
    sim, vert, mom = _simulator(cuda_device, n_time_steps=1000,
                                chunk_steps=250, events_per_batch=8)
    refs = []
    for start in range(0, 24, 8):
        out = sim.simulate_batch(vert[start:start + 8], mom[start:start + 8],
                                 seed=3, event_start=start, assemble=False)
        counts = out["spyral_counts"].cpu().numpy()
        refs.append(sim.assemble_spyral_ordered(
            out["packed"][:counts.sum()].cpu().numpy(), counts,
            np.arange(start, start + 8), 3))

    def host_assembly(*args, **kw):
        raise AssertionError("the host assembly ran")

    monkeypatch.setattr(native, "native_assemble_batch", host_assembly)
    monkeypatch.setattr(simulator.DetectorSimulator,
                        "assemble_spyral_ordered", host_assembly)
    writer = _PoolWriter()
    before = assemble_cuda.launches
    stats = run_reader(sim.config, _ArrayReader(24), writer, engine=engine,
                       seed=3, show_progress=False, auto_tune=False,
                       device=cuda_device)
    assert assemble_cuda.launches == before + 3
    assert "assemble-device" in stats["phase_seconds"]
    assert "assemble" not in stats["phase_seconds"]
    assert len(writer.batches) == 3
    for (spyral, labels, _, _), (rs, rl) in zip(writer.batches, refs):
        np.testing.assert_array_equal(_bits(spyral), _bits(rs))
        np.testing.assert_array_equal(labels, rl)


FANO = (34.0, 0.2)  # w_value, fano_factor


def _fano_dke(n_steps: int, width: int, seed: int, device) -> torch.Tensor:
    """Deposits in MeV, 30 % of them 0 and every step of the second half
    0, as a window's dead tracks and steps are."""
    g = torch.Generator(device=device).manual_seed(seed & 0xFFFFFFFF)
    dke = torch.rand((n_steps, width), generator=g, device=device) * 0.05
    dke[torch.rand(dke.shape, generator=g, device=device) < 0.3] = 0.0
    dke[n_steps // 2:] = 0.0
    return dke


def _fano_words(seed, event_start, device) -> torch.Tensor:
    return torch.from_numpy(fano_cuda.fano_words(seed, event_start)).to(
        device)


def _fano_plain(dke, seed, event_start, n_events, tracks, chunk_steps):
    noise = deposition.fano_noise(seed, event_start, n_events, tracks,
                                  dke.shape[0], chunk_steps,
                                  device=dke.device)
    return deposition.generate_electrons(dke, noise, *FANO)


@pytest.mark.parametrize("tracks,chunk_steps,n_steps,n_events,event_start,"
                         "seed", [
    (2, 500, 2000, 384, 0, 11),  # c16dd's window
    (4, 500, 10000, 384, 384, 12),  # the chain's
    (3, 7, 21, 5, 9, 13),  # cs * K not a multiple of 4
    (4, 500, 300, 384, 0, 14),  # a window shorter than a chunk
    (2, 500, 2000, 384, 2**32 - 100, 15),  # the event id wraps
    (4, 500, 1000, 384, 1, (0xC0FFEE << 40) | 0x12345678),  # high word
    (1, 30, 90, 7, 5, 16),  # one track
])
def test_fano_kernel_matches_plain(cuda_device, tracks, chunk_steps, n_steps,
                                   n_events, event_start, seed):
    dke = _fano_dke(n_steps, n_events * tracks, seed, cuda_device)
    before = fano_cuda.launches
    got = fano_cuda.fano_electrons_cuda(
        dke, _fano_words(seed, event_start, cuda_device), n_events, tracks,
        chunk_steps, *FANO)
    assert fano_cuda.launches == before + 1
    ref = _fano_plain(dke, seed, event_start, n_events, tracks, chunk_steps)
    bad = got != ref
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.numel()} counts differ, largest by "
        f"{int((got.long() - ref.long()).abs().max())}")
    assert int(ref.max()) > 0


def test_fano_kernel_on_two_cards(cuda_device):
    """Each shard's electrons on its own card, launched from one thread:
    the plain version's on that card, and the one-card batch's columns."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    k, cs, n_steps, e = 4, 500, 2000, 384
    dke = _fano_dke(n_steps, e * k, 21, "cuda:0")
    whole = fano_cuda.fano_electrons_cuda(dke, _fano_words(21, 0, "cuda:0"),
                                          e, k, cs, *FANO)
    for card, (lo, hi) in enumerate(((0, e // 2), (e // 2, e))):
        dev = torch.device("cuda", card)
        part = dke[:, lo * k:hi * k].to(dev).contiguous()
        got = fano_cuda.fano_electrons_cuda(part, _fano_words(21, lo, dev),
                                            hi - lo, k, cs, *FANO)
        assert got.device == dev
        assert torch.equal(got, _fano_plain(part, 21, lo, hi - lo, k, cs))
        assert torch.equal(got.cpu(), whole[:, lo * k:hi * k].cpu())


def test_fano_stage_on_the_card(cuda_device):
    """``_core`` on the card: the kernel, counted at "kernel"; with the
    same draws given as noise, the plain version, counted at "plain"; the
    two steps' outputs equal bit for bit."""
    from attpc_engine_tpu_torch.utils import profiling

    sim, vert, mom = _simulator(cuda_device, n_time_steps=1000,
                                chunk_steps=250, events_per_batch=8)
    e, k = 8, sim.k_tracks
    noise = deposition.fano_noise(3, 16, e, k, 1000, 250,
                                  device=cuda_device).cpu().numpy()
    outs, counters = [], []
    for given in (None, noise):
        rec = profiling.PhaseTimes()
        token = profiling.begin_run(rec)
        before = fano_cuda.launches
        try:
            outs.append(sim.simulate_batch(vert[:e], mom[:e], seed=3,
                                           event_start=16, noise=given,
                                           assemble=False))
        finally:
            profiling.end_run(token)
        counters.append((rec.counters["fano.draws"],
                         fano_cuda.launches - before))
    assert counters == [({"kernel": 1000 * e * k}, 1),
                        ({"plain": 1000 * e * k}, 0)]
    for name in ("meta_i32", "packed", "spyral_counts"):
        assert torch.equal(outs[0][name], outs[1][name]), name


# ----------------------------------------------------------------------- #
# the default step as one CUDA graph a budget key (step_graph.py)

# the benchmark cells' tuned budgets (the result lines' driver.budgets)
TUNED = {
    "c16dd_d2_184MeV": dict(point_budget=1920, uniq_budget=24576,
                            out_budget=2048, n_steps=2000),
    "b10_3he_chain_24MeV": dict(point_budget=8192, uniq_budget=34816,
                                out_budget=5120, n_steps=10000),
}
GRAPH_OUTPUTS = ("packed", "spyral_counts", "meta_i32")


def _graph_sims(name, n_batches):
    """A simulator of configuration ``name`` that graphs its step, one that
    runs every step eagerly, and ``n_batches`` batches of 384 events."""
    config, z, a, vertices, momenta, e = _config_events(name, 384 * n_batches)
    sims = []
    for graphed in (True, False):
        sim = DetectorSimulator(
            config, z, a, engine=EngineParams(
                events_per_batch=384, n_time_steps=int(e["n_time_steps"]),
                dt=float(e["dt"]), chunk_steps=int(e["chunk_steps"])),
            device="cuda")
        if not graphed:
            sim._graphs = None
        sims.append(sim)
    return sims, vertices, momenta


def _graph_batch(sim, vertices, momenta, start, n=384, seed=2**40 + 7,
                 **budgets):
    """One batch's compared outputs, copied to the host before the next
    call overwrites a graph's."""
    out = sim.simulate_batch(vertices[start:start + n],
                             momenta[start:start + n], seed=seed,
                             event_start=start, assemble=False, **budgets)
    return {name: out[name].cpu() for name in GRAPH_OUTPUTS}


@pytest.mark.parametrize("name", sorted(TUNED))
def test_step_graph_replays_equal_the_eager_step(cuda_device, name):
    """Four consecutive batches at a cell's tuned budgets (eager, capture,
    replay, replay, each with its own first event id): packed rows, counts
    and metadata bit for bit the eager step's; ``step.graph`` counts each
    way, ``fano.draws`` and the kernels' launches every batch (K1 every
    window of the physics window, gated on the card)."""
    from attpc_engine_tpu_torch.utils import profiling

    (sim, ref), vertices, momenta = _graph_sims(name, 4)
    budgets = TUNED[name]
    rec = profiling.PhaseTimes()
    token = profiling.begin_run(rec)
    k1, fano = transport_cuda.launches, fano_cuda.launches
    try:
        got = [_graph_batch(sim, vertices, momenta, start, **budgets)
               for start in range(0, 4 * 384, 384)]
    finally:
        profiling.end_run(token)
    windows = budgets["n_steps"] // sim.engine.chunk_steps
    assert transport_cuda.launches - k1 == 4 * windows
    assert fano_cuda.launches - fano == 4
    assert rec.counters["step.graph"] == {"eager": 1, "capture": 1,
                                          "replay": 2}
    assert rec.counters["fano.draws"] == {
        "kernel": 4 * budgets["n_steps"] * 384 * sim.k_tracks}
    assert sim._graphs.held is not None
    for i, start in enumerate(range(0, 4 * 384, 384)):
        want = _graph_batch(ref, vertices, momenta, start, **budgets)
        for out in GRAPH_OUTPUTS:
            assert torch.equal(got[i][out], want[out]), (start, out)
        assert int(want["spyral_counts"].sum()) > 384 * 100


def test_step_graph_recaptures_at_new_budgets_and_skips_a_short_batch(
        cuda_device):
    """c16dd's tuned budgets, then the point budget doubled (a retry's): the
    new key runs eagerly and drops the graph, its second batch captures;
    a short batch runs eagerly. Each batch's rows the eager step's."""
    from attpc_engine_tpu_torch.utils import profiling

    name = "c16dd_d2_184MeV"
    (sim, ref), vertices, momenta = _graph_sims(name, 5)
    tuned = TUNED[name]
    wide = {**tuned, "point_budget": 2 * tuned["point_budget"]}
    plan = [(0, 384, tuned), (384, 384, tuned), (768, 384, tuned),
            (1152, 384, wide), (0, 384, wide), (384, 384, wide),
            (1536, 200, wide)]
    rec = profiling.PhaseTimes()
    token = profiling.begin_run(rec)
    held = []
    try:
        got = []
        for start, n, budgets in plan:
            got.append(_graph_batch(sim, vertices, momenta, start, n,
                                    **budgets))
            h = sim._graphs.held
            held.append(None if h is None else h.key[2])
    finally:
        profiling.end_run(token)
    assert held == [None, 1920, 1920, None, 3840, 3840, None]
    assert rec.counters["step.graph"] == {"eager": 3, "capture": 2,
                                          "replay": 2}
    for g, (start, n, budgets) in zip(got, plan):
        want = _graph_batch(ref, vertices, momenta, start, n, **budgets)
        for out in GRAPH_OUTPUTS:
            assert torch.equal(g[out], want[out]), (start, n, out)


def test_step_graph_stages_are_timed_on_every_replay(cuda_device):
    """Under a profiler, each run of the graph gives the five stage spans
    of its batch, each timed on the stream by the graph's own events."""
    from attpc_engine_tpu_torch.utils import profiling

    (sim, _), vertices, momenta = _graph_sims("c16dd_d2_184MeV", 4)
    budgets = TUNED["c16dd_d2_184MeV"]
    rec = profiling.PhaseTimes(cuda=torch.device("cuda"))
    token = profiling.begin_run(rec)
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            for start in range(0, 4 * 384, 384):
                with profiling.phase_timer(rec, "dispatch", start):
                    out = sim.simulate_batch(
                        vertices[start:start + 384],
                        momenta[start:start + 384], seed=1,
                        event_start=start, assemble=False, **budgets)
                out["meta_i32"].cpu()
                rec.resolve()
    finally:
        profiling.end_run(token)
    assert rec.counters["step.graph"] == {"eager": 1, "capture": 1,
                                          "replay": 2}
    stages = ("step.transport", "step.fano", "step.deposit", "step.merge",
              "step.convert")
    for name in stages:
        spans = [s for s in rec.spans if s.name == name]
        assert sorted(s.batch for s in spans) == [0, 384, 768, 1152], name
        assert all(s.device_s is not None and s.device_s > 0
                   for s in spans), name
    assert rec._pending == []


def test_step_graph_on_two_threads_gives_the_one_card_rows(cuda_device):
    """``run_reader`` over two shards (two cards, or two card threads on
    one card), each thread capturing and replaying its own graph on its
    own stream, at fixed budgets: the one-card run's rows bit for bit,
    with replays on every shard."""
    from attpc_engine_tpu_torch.detector.simulator import run_reader

    config, z, a, vertices, momenta, e = _config_events("c16dd_d2_184MeV",
                                                        5 * 384)

    class Reader:
        n_events, proton_numbers, mass_numbers = 5 * 384, z, a

        def read_range(self, lo, hi):
            return vertices[lo:hi], momenta[lo:hi]

        def close(self):
            pass

    class Writer:
        def __init__(self):
            self.seen = []

        def write_spyral_pool(self, spyral, labels, counts, event_numbers,
                              raw_counts=None):
            self.seen.append((spyral.copy(), labels.copy(),
                              np.asarray(counts).copy()))

        def close(self):
            pass

    tuned = TUNED["c16dd_d2_184MeV"]
    engine = EngineParams(events_per_batch=384, point_budget=1920,
                          uniq_budget=tuned["uniq_budget"],
                          out_budget=tuned["out_budget"], n_time_steps=2000,
                          chunk_steps=500)
    n = min(torch.cuda.device_count(), 2)
    runs = []
    for devices in ("cuda:0", [f"cuda:{k % n}" for k in range(2)]):
        writer = Writer()
        stats = run_reader(config, Reader(), writer, engine=engine, seed=9,
                           show_progress=False, auto_tune=False,
                           device=devices)
        runs.append((writer.seen, stats["counters"]["step.graph"]))
    (one, graphs_one), (two, graphs_two) = runs
    assert graphs_one == {"eager": 1, "capture": 1, "replay": 3}
    # each shard's simulator: one eager, one capture, three replays
    assert graphs_two == {"eager": 2, "capture": 2, "replay": 6}
    assert len(one) == len(two) == 5
    for (s1, l1, c1), (s2, l2, c2) in zip(one, two):
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(s1.view(np.int64), s2.view(np.int64))


# ----------------------------------------------------------------------- #
# the driver with one batch in flight (driver.py)


@pytest.mark.parametrize("threads", [1, 2], ids=["one_card", "card_threads"])
def test_run_reader_keeps_a_batch_in_flight_on_the_card(cuda_device,
                                                        threads):
    """``run_reader`` over twelve batches of c16dd's events at its tuned
    budgets, each batch dispatched (a replay of the step's graph from the
    third) before the batch before it is pulled: every batch's assembled
    rows bit for bit the eager step's of that batch (assembled by the
    same kernel with the batch's global event ids), in order, and 11 of
    the 12 batches counted ``queued`` at ``driver.ahead`` (the first has
    nothing in flight). With ``card_threads`` two card threads (two
    cards, or both on one card) share each batch."""
    from attpc_engine_tpu_torch.detector.simulator import run_reader

    name, n_batches, seed = "c16dd_d2_184MeV", 12, 2**40 + 7
    config, z, a, vertices, momenta, e = _config_events(name,
                                                        n_batches * 384)

    class Reader:
        n_events, proton_numbers, mass_numbers = n_batches * 384, z, a

        def read_range(self, lo, hi):
            return vertices[lo:hi], momenta[lo:hi]

        def close(self):
            pass

    class Writer:
        def __init__(self):
            self.seen = []

        def write_spyral_pool(self, spyral, labels, counts, event_numbers,
                              raw_counts=None):
            self.seen.append((spyral.copy(), labels.copy(),
                              np.asarray(counts).copy(),
                              np.asarray(event_numbers).copy()))

        def close(self):
            pass

    tuned = TUNED[name]
    engine = EngineParams(events_per_batch=384, n_time_steps=2000,
                          dt=float(e["dt"]), chunk_steps=500,
                          point_budget=tuned["point_budget"],
                          uniq_budget=tuned["uniq_budget"],
                          out_budget=tuned["out_budget"])
    n = min(torch.cuda.device_count(), 2)
    devices = ("cuda:0" if threads == 1
               else [f"cuda:{k % n}" for k in range(threads)])
    writer = Writer()
    stats = run_reader(config, Reader(), writer, engine=engine, seed=seed,
                       show_progress=False, auto_tune=False, device=devices)
    c = stats["counters"]
    assert c["driver.ahead"] == {"serial": 1, "queued": n_batches - 1}
    assert c["driver.ahead"]["queued"] / n_batches >= 0.9
    assert c["retries"] == {} and c["step.graph"]["replay"] >= 9
    ref = DetectorSimulator(config, z, a, engine=engine, device="cuda")
    ref._graphs = None
    assert len(writer.seen) == n_batches
    for b, (spyral, labels, counts, events) in enumerate(writer.seen):
        lo = b * 384
        out = ref.simulate_batch(vertices[lo:lo + 384],
                                 momenta[lo:lo + 384], seed=seed,
                                 event_start=lo, assemble=False, **tuned)
        total = int(out["spyral_counts"].sum())
        rs, rl = ref.assemble_device(
            out["packed"][:total], out["spyral_counts"],
            torch.arange(lo, lo + 384, device="cuda"), seed)
        np.testing.assert_array_equal(events, np.arange(lo, lo + 384))
        np.testing.assert_array_equal(counts,
                                      out["spyral_counts"].cpu().numpy())
        np.testing.assert_array_equal(_bits(spyral), _bits(rs.cpu().numpy()))
        np.testing.assert_array_equal(labels, rl.cpu().numpy())
