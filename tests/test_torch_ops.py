"""The port's copies of the framework-free utilities against the JAX
package's: Szudzik pairing bit for bit, ``ops.interp`` against
``jnp.interp``, and the kinematics parquet converter (where pyarrow is
installed) on one file of each schema."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attpc_engine_tpu.io import convert_kinematics as jconvert
from attpc_engine_tpu.io.kinematics_file import KinematicsWriter
from attpc_engine_tpu.ops import pairing as jpairing
from attpc_engine_tpu_torch.io import convert_kinematics as tconvert
from attpc_engine_tpu_torch.ops import interp
from attpc_engine_tpu_torch.ops import pairing as tpairing


def _keys() -> np.ndarray:
    """Random int64 keys (negatives included) and the perfect squares s^2
    and their neighbours where float sqrt rounds across s
    (pairing.py:49-51), up to s near sqrt(2^63)."""
    rng = np.random.default_rng(0)
    s = np.concatenate([np.arange(0, 70), rng.integers(2**20, 3037000499,
                                                        4000),
                        [2**26, 2**26 + 1, 2**31, 3037000499]]).astype(np.int64)
    squares = (s * s)[:, None] + np.array([-1, 0, 1])[None, :]
    rand = rng.integers(-2**40, 2**62, 20000, dtype=np.int64)
    return np.concatenate([squares.ravel(), rand])


# From this key up, the guard's (s + 1) * (s + 1) overflows int64 in both
# packages and unpair_arrays no longer inverts pair_arrays.
UNPAIR_OVERFLOW = 3037000499 * 3037000499 - 1


def test_unpair_arrays_matches_jax_bit_for_bit():
    keys = _keys()
    with np.errstate(invalid="ignore"):  # the sqrt of the negative keys
        jt, jp = jpairing.unpair_arrays(keys)
        tt, tp = tpairing.unpair_arrays(keys)
    assert np.array_equal(jt, tt) and np.array_equal(jp, tp)
    assert jt.dtype == tt.dtype == np.int64
    ok = (keys >= 0) & (keys < UNPAIR_OVERFLOW)
    assert np.array_equal(tpairing.pair_arrays(tt[ok], tp[ok]), keys[ok])


def test_pair_arrays_matches_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    tb = rng.integers(-5, 2**31, 20000, dtype=np.int64)
    pad = rng.integers(-5, 2**31, 20000, dtype=np.int64)
    tb[:100] = pad[:100]  # the tb == pad branch
    assert np.array_equal(jpairing.pair_arrays(tb, pad),
                          tpairing.pair_arrays(tb, pad))


@pytest.mark.parametrize("key", [-3, 0, 1, 2, 3, 8, 9, 10, 2**40, 2**52 + 1])
def test_scalar_pairing_matches_jax(key):
    assert jpairing.unpair(key) == tpairing.unpair(key)
    tb, pad = tpairing.unpair(key)
    assert jpairing.pair(tb, pad) == tpairing.pair(tb, pad)


def test_interp_matches_jnp_interp():
    """ops.interp against jnp.interp on the pipeline's 2,048-point grid: the
    same values at the grid points and outside the table, and within 2 ulp
    between (XLA's CPU code fuses ``fp[i-1] + (delta / dx) * df`` into one
    multiply-add; the port rounds the product first)."""
    rng = np.random.default_rng(2)
    xp = np.linspace(0.0, 0.8, 2048)
    fp = np.cumsum(rng.uniform(0.0, 1.0, 2048))
    fp[100:110] = fp[100]  # flat stretch
    x = np.concatenate([rng.uniform(-0.1, 0.9, 50000), xp, [-1.0, 0.0, 0.8, 2.0]])
    ref = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    got = interp(torch.as_tensor(x), torch.as_tensor(xp),
                 torch.as_tensor(fp)).numpy()
    exact = (x <= xp[0]) | (x >= xp[-1]) | np.isin(x, xp)
    assert exact.sum() > 2048
    assert np.array_equal(got[exact], ref[exact])
    assert np.all(np.abs(got - ref) <= 2 * np.spacing(np.abs(ref)))


@pytest.mark.parametrize("schema", ["columnar", "reference"])
def test_convert_kinematics_parquet_matches_jax(schema, tmp_path):
    pq = pytest.importorskip("pyarrow.parquet")
    rng = np.random.default_rng(3)
    n, z, a = 300, np.array([5, 2, 2, 5, 2, 3, 2, 1]), np.array(
        [10, 3, 4, 9, 4, 5, 4, 1])
    path = tmp_path / "k.h5"
    w = KinematicsWriter(path, n, z, a, schema=schema)
    w.write_batch(rng.normal(size=(n, 3)), rng.normal(size=(n, 8, 4)))
    w.close()
    jconvert.convert_kinematics_hdf5_to_parquet(path, tmp_path / "j.parquet",
                                                batch_size=128)
    tconvert.convert_kinematics_hdf5_to_parquet(path, tmp_path / "t.parquet",
                                                batch_size=128)
    jt = pq.read_table(tmp_path / "j.parquet")
    tt = pq.read_table(tmp_path / "t.parquet")
    assert jt.num_rows == n * 8
    assert jt.equals(tt)
