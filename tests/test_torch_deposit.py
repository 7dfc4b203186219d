"""The port's deposition stage against the JAX package: the pad lookups
(the plain versions of K2, K6 and K7) against ``packed_key_lookup_2s_pallas``,
``packed_key_lookup_pallas`` and ``pad_lookup_pallas`` in interpret mode,
and ``deposit_and_merge`` against the JAX function fed the same electrons
and raw-cloud wiggle.

The lookups must be bit-exact. ``deposit_and_merge``'s integer outputs must
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
from tests.test_torch_host import jax_config

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
