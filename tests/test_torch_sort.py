"""The port's row sort (K3's plain version) and per-event merge against the
JAX package's Pallas sort kernel (interpret mode on the CPU) and its
``_merge_runs``.

The sort must be exact: the port sorts the int64 ``pack64`` of the pair
the TPU kernel sorts as two int32 planes, and the convert key as a native
signed int64. ``_merge_runs`` must give the same integers and the same run
sums within rtol 1e-5 / atol 1e-2 (tests/test_sort_pallas.py:171-172).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attpc_engine_tpu.detector.deposition import _merge_runs as jax_merge
from attpc_engine_tpu.detector.sort_pallas import (
    sort_i64_pallas,
    sort_pairs_pallas,
)
from attpc_engine_tpu_torch.detector import sort_cuda
from attpc_engine_tpu_torch.detector.deposition import (
    KEY_SENTINEL,
    _merge_runs,
    _prefix_sum,
)
from attpc_engine_tpu_torch.detector.sort_cuda import pack64, unpack64


def _pairs(e, w, seed, sentinel_share=0.3):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 7, (e, w)).astype(np.int32) * 1000
    lo = np.float32(rng.random((e, w)) * 100).view(np.int32)
    sent = rng.random((e, w)) < sentinel_share
    hi[sent] = KEY_SENTINEL
    lo[sent] = 0
    return hi, lo


# one (rows, width) for every interpret-mode call, so they share one
# compilation; 300 is not a power of two (padded to 512)
E, W = 3, 300


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_sort_matches_pallas_pairs(seed):
    hi, lo = _pairs(E, W, seed)
    rh, rl = sort_pairs_pallas(jnp.asarray(hi), jnp.asarray(lo),
                               interpret=True, lane_mode="transpose")
    g = sort_cuda.sort_rows(pack64(torch.from_numpy(hi),
                                    torch.from_numpy(lo).view(torch.float32)))
    k, v = unpack64(g)
    np.testing.assert_array_equal(k.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(v.view(torch.int32).numpy(), np.asarray(rl))


def test_plain_sort_rows_of_sentinels():
    hi, lo = _pairs(E, W, 5, sentinel_share=0.0)
    hi[1] = KEY_SENTINEL
    lo[1] = 0
    rh, rl = sort_pairs_pallas(jnp.asarray(hi), jnp.asarray(lo),
                               interpret=True, lane_mode="transpose")
    g = sort_cuda.sort_rows(pack64(torch.from_numpy(hi),
                                    torch.from_numpy(lo).view(torch.float32)))
    k, v = unpack64(g)
    np.testing.assert_array_equal(k.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(v.view(torch.int32).numpy(), np.asarray(rl))


def test_plain_sort_matches_pallas_i64_convert_key():
    """Rows like _convert_to_spyral's key: kept rows negative (bit 63),
    dropped rows INT64_MAX, nonnegative charge bits in the low word."""
    rng = np.random.default_rng(2)
    e, w = E, W
    tb = rng.integers(0, 512, (e, w)).astype(np.int64)
    pad = rng.integers(0, 10240, (e, w)).astype(np.int64)
    lab = rng.integers(0, 4, (e, w)).astype(np.int64)
    q = np.float32(rng.random((e, w)) * 1e6).view(np.int32).astype(np.int64)
    key = ((511 - tb) << 54) | (pad << 40) | (lab << 32) | q
    keep = rng.random((e, w)) < 0.6
    key = np.where(keep, key | np.int64(-(2**63)), np.int64(2**63 - 1))
    ref = np.asarray(sort_i64_pallas(jnp.asarray(key), interpret=True,
                                     lane_mode="transpose"))
    got = sort_cuda.sort_rows(torch.from_numpy(key)).numpy()
    np.testing.assert_array_equal(got, ref)


def _merge_inputs(e, w, seed):
    rng = np.random.default_rng(seed)
    rank_bits = 1
    space = rng.integers(0, w // 3, (e, w)).astype(np.int32)
    packed = (space << rank_bits) | rng.integers(0, 2, (e, w)).astype(np.int32)
    qv = np.abs(rng.normal(100.0, 30.0, (e, w))).astype(np.float32)
    dead = rng.random((e, w)) < 0.25
    packed[dead] = KEY_SENTINEL
    qv[dead] = 0.0
    return packed, qv, rank_bits


@pytest.mark.parametrize("w,cap", [(1000, 400), (3000, 3000)])
def test_merge_runs_matches_jax(w, cap):
    packed, qv, rank_bits = _merge_inputs(3, w, w)
    ref = jax.jit(lambda p, q: jax_merge(p, q, cap, rank_bits))(packed, qv)
    got = _merge_runs(torch.from_numpy(packed), torch.from_numpy(qv), cap,
                      rank_bits)
    k_ref, s_ref, v_ref, n_ref = (np.asarray(x) for x in ref)
    k, s, v, n = (x.numpy() for x in got)
    np.testing.assert_array_equal(k, k_ref)
    np.testing.assert_array_equal(v, v_ref)
    np.testing.assert_array_equal(n, n_ref)
    np.testing.assert_allclose(s, s_ref, rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("w", [1, 16, 17, 255, 4096 + 7])
def test_prefix_sum_associates_as_jax_cumsum(w):
    """The charge prefix is bit-identical to jnp.cumsum on the CPU."""
    x = np.random.default_rng(w).random((3, w)).astype(np.float32) * 100
    ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1,
                                                  dtype=jnp.float32))(x))
    np.testing.assert_array_equal(_prefix_sum(torch.from_numpy(x)).numpy(),
                                  ref)


@pytest.mark.parametrize("w,name,n_cta", [
    (1, "cluster", 1), (12288, "cluster", 1), (102400, "cluster", 8),
    (204800, "cluster", 16), (409600, "wide", 0),
])
def test_sort_route_rule(w, name, n_cta):
    """K3's width rule: the smallest cluster whose CTAs hold the row, each
    an even chunk within a block's 232,448 B of shared memory, else the
    wide route."""
    r = sort_cuda.route(w)
    assert (r.name, r.n_cta) == (name, n_cta)
    if r.name == "cluster":
        assert r.chunk % 2 == 0 and r.n_cta * r.chunk >= w
        assert r.shared_bytes == 16 * r.chunk + sort_cuda.FIXED_BYTES
        assert r.shared_bytes <= sort_cuda.SHARED_BYTES == 232_448
        smaller = [n for n in sort_cuda.CLUSTER_SIZES if n < r.n_cta]
        assert not smaller or smaller[-1] * sort_cuda.CTA_CAPACITY < w
    else:
        assert w > sort_cuda.CLUSTER_SIZES[-1] * sort_cuda.CTA_CAPACITY
    assert sort_cuda.route(16 * sort_cuda.CTA_CAPACITY).shared_bytes <= (
        sort_cuda.SHARED_BYTES)


def test_sort_route_constants_match_the_kernel_source():
    """The wrapper's shared-memory arithmetic is the kernel's."""
    src = (Path(sort_cuda.__file__).resolve().parents[1] / "csrc"
           / "sort_cluster.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kThreads") == sort_cuda.CTA_THREADS
    assert const("kDigits") == sort_cuda.DIGITS
    assert const("kMaxShared") == sort_cuda.SHARED_BYTES
    assert const("kMaxCluster") == sort_cuda.CLUSTER_SIZES[-1]
    tail = re.search(r"constexpr int kFixedBytes = "
                     r"kWarps \* kDigits \* 2 \+ 2 \* kDigits \* 4 \+ (\d+);",
                     src)[1]
    warps = sort_cuda.CTA_THREADS // 32
    assert sort_cuda.FIXED_BYTES == (warps * sort_cuda.DIGITS * 2
                                     + 2 * sort_cuda.DIGITS * 4 + int(tail))
