"""The port's deposition stage against the JAX package: the pad lookups
(the plain versions of K2, K6 and K7) against ``packed_key_lookup_2s_pallas``,
``packed_key_lookup_pallas`` and ``pad_lookup_pallas`` in interpret mode,
the deposit rows (the plain version of the default step's rows kernel)
against the code they were extracted from and against the JAX package's
mesh, K2 and charge expressions, and ``deposit_and_merge`` against the JAX
function fed the same electrons and raw-cloud wiggle.

The lookups and the deposit rows must be bit-exact. ``deposit_and_merge``'s integer outputs must
be bit-exact and its charges within rtol 1e-5 / atol 1e-2
(tests/test_sort_pallas.py:171-172); the gain is 1 here, so the atol is on
the scale of the f32 prefix the run sums are differences of.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attpc_engine_tpu.detector.deposit_pallas import (
    _NX,
    _NY,
    packed_key_lookup_2s_pallas,
    packed_key_lookup_pallas,
    pad_lookup_pallas,
)
from attpc_engine_tpu.detector.deposition import (
    _key_lookup as jax_key_lookup,
)
from attpc_engine_tpu.detector.deposition import deposit_and_merge as jax_dm
from attpc_engine_tpu.detector.deposition import event_keys
from attpc_engine_tpu_torch.detector import deposit_cuda
from attpc_engine_tpu_torch.detector import deposition as D
from attpc_engine_tpu_torch.detector.sort_cuda import pack64
from tests.test_torch_host import jax_config, torch_config

SENT = 2**31 - 1


def _lookup_inputs(p, seed, table_shape=(560, 640)):
    rng = np.random.default_rng(seed)
    ix = rng.integers(-5, 565, (p, 10)).astype(np.int32)
    iy = rng.integers(-5, 645, (p, 10)).astype(np.int32)
    # aliased invalid pixels, as deposit_and_merge passes them
    ix[rng.random((p, 10)) < 0.1] = table_shape[0] - 1
    iy[rng.random((p, 10)) < 0.1] = table_shape[1] - 1
    tbr = rng.integers(0, 512 << 1, p).astype(np.int32)
    return ix, iy, tbr


def test_plain_lookup_bit_exact_vs_pallas_2s():
    dev = jax_config().device_arrays()
    ix, iy, tbr = _lookup_inputs(300, 0)
    ref = packed_key_lookup_2s_pallas(
        jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(tbr), dev["plane_hi"],
        dev["plane_lo"], rank_bits=1, sentinel=SENT, interpret=True)
    table = torch.from_numpy(
        (dev["plane_hi"] * 128 + dev["plane_lo"]).astype(np.int32))
    got = deposit_cuda.packed_key_lookup(
        torch.from_numpy(ix), torch.from_numpy(iy), torch.from_numpy(tbr),
        table, 1, SENT)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() == SENT).any() and (got.numpy() != SENT).any()


def _table(dev):
    return torch.from_numpy(
        (dev["plane_hi"] * 128 + dev["plane_lo"]).astype(np.int32))


def test_plain_rows_lookup_bit_exact_vs_pallas_and_k2():
    """K6's plain version against the one-stage Pallas kernel and against
    K2's plain version, at a P that is not a multiple of the Pallas
    kernel's 64-point block, with aliased invalid pixels."""
    dev = jax_config().device_arrays()
    ix, iy, tbr = _lookup_inputs(300, 1)
    ref = packed_key_lookup_pallas(
        jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(tbr), dev["plane_hi"],
        dev["plane_lo"], rank_bits=1, sentinel=SENT, interpret=True)
    args = (torch.from_numpy(ix), torch.from_numpy(iy), torch.from_numpy(tbr),
            _table(dev), 1, SENT)
    got = deposit_cuda.packed_key_lookup_rows(*args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(),
                                  deposit_cuda.packed_key_lookup(*args).numpy())
    assert (got.numpy() == SENT).any() and (got.numpy() != SENT).any()


def test_plain_pad_lookup_bit_exact_vs_pallas_on_all_pixels():
    """K7's plain version against pad_lookup_pallas on every pixel,
    including those clipped onto the table's edges (the setup of
    tests/test_deposit_pallas.py:36-56 on the detector's own table)."""
    dev = jax_config().device_arrays()
    rng = np.random.default_rng(0)
    p = 300
    ix = rng.integers(-5, 565, (p, 10)).astype(np.int32)
    iy = rng.integers(-5, 645, (p, 10)).astype(np.int32)
    ref = np.asarray(pad_lookup_pallas(ix, iy, dev["plane_hi"],
                                       dev["plane_lo"], interpret=True))
    got = deposit_cuda.pad_lookup(torch.from_numpy(ix), torch.from_numpy(iy),
                                  _table(dev)).numpy()
    np.testing.assert_array_equal(got, ref)
    clipped = ((ix < 0) | (ix > 559))[:, :, None] | (
        (iy < 0) | (iy > 639))[:, None, :]
    assert clipped.any() and (got < 10240).any() and (got == 10240).any()


def test_key_lookup_matches_jax():
    dev = jax_config().device_arrays()
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.3, 0.3, (50, 10)).astype(np.float32)
    y = rng.uniform(-0.3, 0.3, (50, 10)).astype(np.float32)
    lo, n = dev["grid_lo_mm"], dev["grid_n_mm"]
    ref = jax.jit(lambda a, b: jax_key_lookup(
        jnp.asarray(dev["key_grid_mm"]).reshape(-1), lo, n, a, b))(x, y)
    got = D._key_lookup(torch.from_numpy(dev["key_grid_mm"]).reshape(-1), lo,
                        n, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_mesh_equals_jax_linspace_bits():
    """The mesh offsets equal jnp.linspace(-3, 3, 10, float32) as the JAX
    detector program computes it at run time, bit for bit."""
    f32 = jnp.float32
    ref = np.asarray(jax.jit(
        lambda z: z + jnp.linspace(-3.0, 3.0, D.MESH_STEPS, dtype=f32)
    )(np.zeros(D.MESH_STEPS, np.float32)))
    np.testing.assert_array_equal(D.MESH_1D.view(np.int32),
                                  ref.view(np.int32))


def _tracks(e, k, t, seed):
    rng = np.random.default_rng(seed)
    b = e * k
    positions = np.zeros((t, b, 3), np.float32)
    positions[:, :, 0] = np.cumsum(rng.normal(0, 0.004, (t, b)), 0)
    positions[:, :, 1] = 0.08 + np.cumsum(rng.normal(0, 0.004, (t, b)), 0)
    positions[:, :, 2] = rng.uniform(0.1, 0.99, (t, b))
    dke = rng.uniform(0.0, 0.05, (t, b)).astype(np.float32)
    valid = rng.random((t, b)) < 0.9
    labels = np.tile(np.arange(k, dtype=np.int32) + 2, e)
    return positions, dke, valid, labels


def _jax_fano_noise(keys_e, t, b, chunk):
    """The Fano draws of attpc_engine_tpu generate_electrons
    (deposition.py:128-137)."""
    e = keys_e.shape[0]
    k = b // e
    n_chunks = -(-t // chunk)

    def per_event(kk):
        ck = jax.vmap(lambda c: jax.random.fold_in(kk, c))(
            jnp.arange(n_chunks, dtype=jnp.int32))
        return jax.vmap(lambda key_c: jax.random.normal(
            key_c, (chunk, k), dtype=jnp.float32))(ck).reshape(-1, k)

    noise = jax.vmap(per_event)(keys_e)[:, :t]
    return np.asarray(jnp.transpose(noise, (1, 0, 2)).reshape(t, b))


@pytest.mark.parametrize("point_budget", [128, 24])
def test_deposit_and_merge_matches_jax(point_budget):
    """Fano noise and wiggle drawn as the JAX package draws them; with
    point_budget 24 the point pool overflows."""
    from attpc_engine_tpu.detector.deposition import generate_electrons

    config = jax_config()
    dev = config.device_arrays()
    e, k, t = 3, 2, 40
    positions, dke, valid, labels = _tracks(e, k, t, 7)
    keys = event_keys(jax.random.PRNGKey(3), e)
    noise = _jax_fano_noise(keys, t, e * k, 20)
    electrons = np.asarray(generate_electrons(
        keys, jnp.asarray(dke), 34.0, 0.2, chunk_steps=20))
    tel = D.generate_electrons(torch.from_numpy(dke), torch.from_numpy(noise),
                               34.0, 0.2)
    np.testing.assert_array_equal(tel.numpy(), electrons)

    kw = dict(grid_lo_mm=dev["grid_lo_mm"], grid_n_mm=dev["grid_n_mm"],
              diffusion=config.det_params.diffusion,
              efield=config.det_params.efield,
              drift_velocity=config.drift_velocity, micromegas_edge=10.0,
              length=1.0, mpgd_gain=1.0, n_events=e, tracks_per_event=k,
              point_budget=point_budget, uniq_budget=4096)
    ref = jax_dm(keys, positions, electrons, valid, labels,
                 dev["key_grid_mm"], **kw)
    u = ref["pads"].shape[0] // e
    wiggle = np.asarray(jax.vmap(
        lambda kk: jax.random.uniform(kk, (u,), dtype=jnp.float32))(keys))
    table = torch.from_numpy(
        (dev["plane_hi"] * 128 + dev["plane_lo"]).astype(np.int32))
    got = D.deposit_and_merge(
        torch.from_numpy(positions), tel, torch.from_numpy(valid),
        torch.from_numpy(labels), table, wiggle=torch.from_numpy(wiggle),
        **kw)
    for name in ("pads", "tbs_i", "labels", "events", "cloud_valid", "counts",
                 "n_points", "pool_overflow", "uniq_overflow", "uniq_max",
                 "tbs"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(ref[name]), err_msg=name)
    np.testing.assert_allclose(got["charges"].numpy(),
                               np.asarray(ref["charges"]), rtol=1e-5,
                               atol=1e-2)
    assert int(got["counts"].sum()) > 0
    assert (int(got["pool_overflow"]) > 0) == (point_budget == 24)


@pytest.mark.parametrize("point_budget", [128, 24])
def test_merge_rows_past_the_point_prefix_are_sentinels(point_budget,
                                                        monkeypatch):
    """The live merge sort's contract (``sort_cuda.sort_rows_live``): the
    default step hands it, as each event's prefix, min(n_points,
    point_budget) * 100 lanes, and every lane of its rows at or past that
    is pack64(KEY_SENTINEL, 0.0); at point budget 24 events overflow
    (n_points > point_budget), and their prefix is the whole row."""
    seen = []
    real = D.sort_rows_live

    def spy(rows, lanes):
        seen.append((rows.clone(), lanes.clone()))
        return real(rows, lanes)

    monkeypatch.setattr(D, "sort_rows_live", spy)
    config = torch_config()
    dev = config.device_arrays()
    e, k, t = 3, 2, 40
    positions, _, valid, labels = _tracks(e, k, t, 7)
    electrons = np.random.default_rng(5).integers(1, 500, (t, e * k))
    out = D.deposit_and_merge(
        torch.from_numpy(positions), torch.from_numpy(electrons).int(),
        torch.from_numpy(valid), torch.from_numpy(labels),
        torch.as_tensor(dev["pad_table"]), grid_lo_mm=dev["grid_lo_mm"],
        grid_n_mm=dev["grid_n_mm"], diffusion=config.det_params.diffusion,
        efield=config.det_params.efield,
        drift_velocity=config.drift_velocity, micromegas_edge=10.0,
        length=1.0, mpgd_gain=1.0, n_events=e, tracks_per_event=k,
        point_budget=point_budget, uniq_budget=4096)
    ((rows, lanes),) = seen
    n_points = out["n_points"]
    assert lanes.dtype == torch.int32 and torch.equal(
        lanes, torch.clamp(n_points, max=point_budget) * 100)
    assert rows.shape == (e, point_budget * 100)
    past = torch.arange(rows.shape[1])[None, :] >= lanes[:, None]
    assert bool((rows[past] == SENT << 32).all())
    live = (rows >> 32) != SENT
    assert torch.equal(live.any(dim=1), n_points > 0)
    assert bool((n_points > point_budget).any()) == (point_budget == 24)


# --- the deposit rows ------------------------------------------------------ #

ROWS_CASES = ("mixed", "sigma_zero", "untaken", "off_plane", "tb_negative")


def _rows_points(case, e=3, pb=100, seed=11):
    """Compacted points [E, pb] as deposit_and_merge hands them on, made
    from a seed with numpy: tracks over the pad plane, 10 % empty slots
    (whose values are whatever slot 0 of the batch held), and the edge
    case ``case`` on a third to a half of the points: ``sigma_zero``
    (tb_f == 0, so sigma == 0), ``untaken`` (empty slots with junk values,
    zero or negative electrons among them), ``off_plane`` (points beyond
    the 560-mm grid, all or some of their pixels off it) and
    ``tb_negative`` (tb_f in (-1, 0): sigma is NaN, tb 0)."""
    rng = np.random.default_rng(seed + ROWS_CASES.index(case))
    shape = (e, pb)
    px = rng.normal(0.0, 0.1, shape)
    py = rng.normal(0.02, 0.1, shape)
    ptbf = rng.uniform(0.0, 511.9, shape)
    pne = rng.integers(1, 4000, shape).astype(np.float64)
    taken = rng.random(shape) < 0.9
    some = rng.random(shape) < (0.5 if case == "untaken" else 0.35)
    if case == "sigma_zero":
        ptbf[some] = 0.0
    elif case == "untaken":
        taken[some] = False
        pne[some] = rng.integers(-50, 2, some.sum())
    elif case == "off_plane":
        px[some] = rng.choice([-1, 1], some.sum()) * rng.uniform(
            0.275, 0.4, some.sum())
        py[some[::-1]] = rng.uniform(-0.4, -0.275, some.sum())
    elif case == "tb_negative":
        ptbf[some] = rng.uniform(-0.999, -1e-6, some.sum())
    ptbf = ptbf.astype(np.float32)
    tbr = (ptbf.astype(np.int32) << 1) | rng.integers(0, 2, shape).astype(
        np.int32)
    return [a.astype(np.float32) for a in (px, py)] + [
        ptbf, pne.astype(np.float32), tbr, taken]


def _rows_scalars():
    config = jax_config()
    dev = config.device_arrays()
    return dev, (float(dev["grid_lo_mm"]), int(dev["grid_n_mm"]),
                 config.det_params.diffusion, config.det_params.efield,
                 config.drift_velocity)


def _rows_before_extraction(px, py, ptbf, pne, tbr, taken, table, grid_lo_mm,
                            grid_n_mm, diffusion, efield, drift_velocity,
                            rank_bits):
    """deposit_and_merge's mesh, lookup, charges and first pack64 as they
    stood before the deposit rows were drawn out of it, line for line."""
    e, pb = px.shape
    px, py, ptbf, pne, tbr, taken = (a.reshape(-1) for a in (
        px, py, ptbf, pne, tbr, taken))
    f32, i32 = torch.float32, torch.int32
    sigma = torch.sqrt(2.0 * diffusion * drift_velocity * ptbf / efield)
    has_diff = sigma > 0.0
    sigma_safe = torch.where(has_diff, sigma, torch.ones_like(sigma))
    mesh = torch.from_numpy(D.MESH_1D)
    x10 = px[:, None] + sigma_safe[:, None] * mesh[None, :]
    y10 = py[:, None] + sigma_safe[:, None] * mesh[None, :]
    x10 = torch.where(has_diff[:, None], x10, px[:, None])
    y10 = torch.where(has_diff[:, None], y10, py[:, None])
    step = 6.0 / (D.MESH_STEPS - 1)
    off2 = mesh[:, None] * mesh[:, None] + mesh[None, :] * mesh[None, :]
    pdf = (step * step / (2.0 * np.pi)) * torch.exp(-0.5 * off2)
    q_pix = pne[:, None, None] * pdf
    q_point = torch.zeros((D.MESH_STEPS, D.MESH_STEPS), dtype=f32)
    q_point[0, 0] = 1.0
    q_pix = torch.where(has_diff[:, None, None], q_pix,
                        pne[:, None, None] * q_point)
    ix = torch.floor(x10 * 1000.0 - grid_lo_mm).to(i32)
    iy = torch.floor(y10 * 1000.0 - grid_lo_mm).to(i32)
    bad_x = (ix < 0) | (ix >= grid_n_mm) | ~taken[:, None]
    bad_y = (iy < 0) | (iy >= grid_n_mm)
    ix = torch.where(bad_x, torch.full_like(ix, 559), ix)
    iy = torch.where(bad_y, torch.full_like(iy, 639), iy)
    packed3 = deposit_cuda.packed_key_lookup(
        ix.contiguous(), iy.contiguous(), tbr.contiguous(), table, rank_bits,
        D.KEY_SENTINEL)
    w = pb * D.MESH_STEPS * D.MESH_STEPS
    packed = packed3.reshape(e, w)
    qq_in = torch.where(packed3 != D.KEY_SENTINEL, q_pix,
                        torch.zeros_like(q_pix)).reshape(e, w)
    return pack64(packed, qq_in)


@pytest.mark.parametrize("case", ROWS_CASES)
def test_deposit_rows_plain_equals_code_before_extraction(case):
    dev, scalars = _rows_scalars()
    pts = [torch.from_numpy(a) for a in _rows_points(case)]
    args = (*pts, _table(dev), *scalars, 1)
    got = D.deposit_rows(*args)
    ref = _rows_before_extraction(*args)
    assert got.shape == ref.shape == (3, 100 * 100)
    assert torch.equal(got, ref)


def _jax_mesh(px, py, ptbf, pne, taken, grid_lo_mm, grid_n_mm, diffusion,
              efield, drift_velocity, pdf_area):
    """attpc_engine_tpu/detector/deposition.py:437-492, traced scalars as
    in the jitted deposit_and_merge; ``pdf_area`` replaces the in-graph
    table when given."""
    f32 = jnp.float32
    sigma = jnp.sqrt(2.0 * diffusion * drift_velocity * ptbf / efield).astype(f32)
    has_diff = sigma > 0.0
    sigma_safe = jnp.where(has_diff, sigma, 1.0)
    mesh_1d = jnp.linspace(-3.0, 3.0, D.MESH_STEPS, dtype=f32)
    step = 6.0 / (D.MESH_STEPS - 1)
    x10 = px[:, None] + sigma_safe[:, None] * mesh_1d[None, :]
    y10 = py[:, None] + sigma_safe[:, None] * mesh_1d[None, :]
    x10 = jnp.where(has_diff[:, None], x10, px[:, None])
    y10 = jnp.where(has_diff[:, None], y10, py[:, None])
    if pdf_area is None:
        pdf_area = (step * step / (2.0 * jnp.pi)) * jnp.exp(
            -0.5 * (mesh_1d[:, None] ** 2 + mesh_1d[None, :] ** 2))
    q_pix = pne[:, None, None] * pdf_area
    q_point = jnp.zeros((D.MESH_STEPS, D.MESH_STEPS), dtype=f32).at[0, 0].set(1.0)
    q_pix = jnp.where(has_diff[:, None, None], q_pix,
                      pne[:, None, None] * q_point)
    ix = jnp.floor(x10 * 1000.0 - grid_lo_mm).astype(jnp.int32)
    iy = jnp.floor(y10 * 1000.0 - grid_lo_mm).astype(jnp.int32)
    bad_x = (ix < 0) | (ix >= grid_n_mm) | ~taken[:, None]
    bad_y = (iy < 0) | (iy >= grid_n_mm)
    return jnp.where(bad_x, _NX - 1, ix), jnp.where(bad_y, _NY - 1, iy), q_pix


@pytest.mark.parametrize("case", ROWS_CASES)
def test_deposit_rows_plain_matches_jax(case):
    """The rows against the JAX package's packed3 (K2's Pallas kernel in
    interpret mode) and qq_in (deposition.py:437-503), packed the same way,
    bit for bit. The JAX side is given the port's pixel-weight table: XLA's
    exp rounds 9 of its 100 entries differently from torch's
    (test_pixel_weights_differ_from_jax_by_an_ulp_at_most)."""
    dev, scalars = _rows_scalars()
    pts = _rows_points(case)
    e, pb = pts[0].shape
    flat = [a.reshape(-1) for a in pts]
    px, py, ptbf, pne, tbr, taken = flat
    ix, iy, q_pix = jax.jit(_jax_mesh)(
        px, py, ptbf, pne, taken, *scalars,
        D.PDF_AREA.numpy())
    packed3 = packed_key_lookup_2s_pallas(
        ix, iy, jnp.asarray(tbr), dev["plane_hi"], dev["plane_lo"],
        rank_bits=1, sentinel=SENT, interpret=True)
    qq_in = jnp.where(packed3 != SENT, q_pix, 0.0)
    ref = (np.asarray(packed3).astype(np.int64).reshape(e, -1) << 32) | (
        np.asarray(qq_in).view(np.uint32).astype(np.int64).reshape(e, -1))
    got = D.deposit_rows(
        *(torch.from_numpy(a) for a in pts), _table(dev), *scalars, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    keys, q = got >> 32, (got & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
    assert (keys == SENT).any() and (keys != SENT).any()
    assert ((keys == SENT) <= (q == 0)).all()
    if case == "sigma_zero" or case == "tb_negative":
        # the point's whole charge on pixel (0, 0), a real key on all 100
        point = ptbf <= 0  # sigma is 0 or NaN
        live = point & taken & (keys.reshape(-1, 100)[:, 0] != SENT)
        assert live.any()
        pix = q.reshape(-1, 100)[live]
        np.testing.assert_array_equal(pix[:, 0], pne[live])
        assert (pix[:, 1:] == 0).all() and not np.signbit(pix[:, 1:]).any()
        k = keys.reshape(-1, 100)[live]
        assert (k == k[:, :1]).all()
    if case == "untaken":
        assert (keys.reshape(-1, 100)[~taken] == SENT).all()
        assert (got.reshape(-1, 100)[~taken] & 0xFFFFFFFF == 0).all()


def test_pixel_weights_differ_from_jax_by_an_ulp_at_most():
    """The port's pixel weights are torch's f32 exp on the CPU; the JAX
    program's are XLA's, which rounds some entries the other way (hazard
    (c)): at most one ulp apart, in 9 of 100 entries."""
    ref = np.asarray(jax.jit(
        lambda z: _jax_mesh(z, z, z, z, z > 0, 0.0, 1, 1.0, 1.0, 1.0, None)[2]
    )(np.ones(1, np.float32)))[0]
    got = D.PDF_AREA.numpy()
    ulps = np.abs(ref.view(np.int32) - got.view(np.int32))
    assert ulps.max() <= 1 and (ulps != 0).sum() == 9
