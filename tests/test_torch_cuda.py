"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc: marked ``cuda``, each skips
where ``torch.cuda.is_available()`` is false. This file imports nothing of
the JAX package (the card's Python needs neither jax nor h5py for it):

    python -m pytest -q tests/test_torch_cuda.py

Bounds: K1 alive flags exact, positions within 1e-6 m, |dKE| within
1e-4 MeV (tests/test_transport_pallas.py); K2 and K7 (one quad kernel), K3
(both routes), K6 and the deposit-rows kernel bit-exact; K5 (both routes)
key2 and n_uniq exact and c2 bit-exact. A wrapper given a CUDA tensor it
cannot take raises: nothing falls back.
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
)
from attpc_engine_tpu_torch.detector import (
    deposit_cuda,
    deposition,
    merge_cuda,
    sort_cuda,
    transport_cuda,
)
from attpc_engine_tpu_torch.detector import transport as T
from attpc_engine_tpu_torch.nuclear import GasTarget

pytestmark = pytest.mark.cuda

SMOKE = (Path(__file__).resolve().parents[1] / "attpc_engine_tpu_torch"
         / "data" / "smoke_kinematics.npz")
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
        fn(*state, s_idx, mass, q_m, sim.species.dedx, *out, kc)
        outs.append(out + state)
    (pr, dr, ar, *cr), (pg, dg, ag, *cg) = outs
    assert torch.equal(ar, ag) and ar.any()
    assert float((pr - pg).abs()[ar].max()) < 1e-6
    assert float((dr - dg).abs()[ar].max()) < 1e-4
    assert torch.equal(cr[2], cg[2])  # the carried alive flags


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
        transport_cuda.rk4_window_cuda(*state, s_idx, mass, q_m,
                                       sim.species.dedx, *out, kc,
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


def test_host_copies_reuse_buffers_of_two_sizes(cuda_device):
    """The driver's pinned copies with buffers of two sizes in the pool:
    a copy that fits only the second takes it (once a crash in
    ``list.remove``), and every copy reads back its rows."""
    from attpc_engine_tpu_torch.detector.simulator import _HostCopies

    copies = _HostCopies(cuda_device)
    q = copies.ROWS_QUANTUM
    # the fifth copy finds [q rows, 2q rows] free and takes the second
    rows = [q + 10, 10, 10, q + 10, q + 10, 10]
    srcs = [torch.full((n, 2), i, dtype=torch.int32, device=cuda_device)
            for i, n in enumerate(rows)]
    pending = None
    for i, src in enumerate(srcs):
        handle = copies.start(src)
        if pending is not None:
            j, h = pending
            assert np.array_equal(copies.finish(h), srcs[j].cpu().numpy())
        pending = (i, handle)
    j, h = pending
    assert np.array_equal(copies.finish(h), srcs[j].cpu().numpy())
    assert len(copies.free) >= 2


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
