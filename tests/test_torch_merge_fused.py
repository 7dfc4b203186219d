"""The port's fused merge (K5's plain version) against the JAX package's
``merge_runs_fused_pallas`` in interpret mode, and against the port's own
sorts path.

Against the Pallas kernel, key2 and n_uniq must be exact and the prefix c2
bit-exact: the plain version sorts the pack64 rows (the network's (key,
charge) order) and reproduces the kernel's prefix association
(``sort_pallas._cumsum_flat``). Against ``_merge_runs(merge="sorts")``,
whose prefix associates as XLA's CPU cumsum, the integers must be exact and
the run sums within rtol 1e-5 / atol 1e-2 (tests/test_sort_pallas.py:171-173).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attpc_engine_tpu.detector.sort_pallas import merge_runs_fused_pallas
from attpc_engine_tpu_torch.detector import merge_cuda
from attpc_engine_tpu_torch.detector.deposition import _merge_runs

SENT = 2**31 - 1


def _inputs(e, w, rank_bits, seed, n_space=150, dead_share=0.2):
    """The structured keys of tests/test_sort_pallas.py:137-146: runs of
    equal space keys, the rank in the low bits, dead lanes at the
    sentinel with zero charge."""
    rng = np.random.default_rng(seed)
    space = np.sort(rng.integers(0, n_space, (e, w)), axis=1).astype(np.int32)
    rank = rng.integers(0, 1 << rank_bits, (e, w)).astype(np.int32)
    packed = (space << rank_bits) | rank
    qv = np.abs(rng.normal(100.0, 30.0, (e, w))).astype(np.float32)
    dead = rng.random((e, w)) < dead_share
    packed[dead] = SENT
    qv[dead] = 0.0
    return packed, qv


def _check_against_pallas(packed, qv, cap, rank_bits):
    k_ref, c_ref, n_ref = (np.asarray(x) for x in merge_runs_fused_pallas(
        jnp.asarray(packed), jnp.asarray(qv), cap, rank_bits,
        interpret=True))
    k2, c2, n2 = (x.numpy() for x in merge_cuda.merge_runs_fused(
        torch.from_numpy(packed), torch.from_numpy(qv), cap, rank_bits))
    np.testing.assert_array_equal(k2, k_ref)
    np.testing.assert_array_equal(n2, n_ref)
    np.testing.assert_array_equal(c2.view(np.int32), c_ref.view(np.int32))
    return k2, c2, n2


@pytest.mark.parametrize("e,w,cap,rank_bits,n_space", [
    (3, 700, 256, 2, 150),
    (2, 12800, 4096, 1, 3000),
])
def test_plain_fused_merge_bit_exact_vs_pallas(e, w, cap, rank_bits, n_space):
    packed, qv = _inputs(e, w, rank_bits, seed=w, n_space=n_space)
    _, _, n2 = _check_against_pallas(packed, qv, cap, rank_bits)
    assert (n2 > 0).all()


def test_plain_fused_merge_edge_cases_vs_pallas():
    """A row of sentinels, a cap below n_uniq (truncation) and not a
    multiple of 128, and a width that is not a power of two."""
    e, w, cap, rank_bits = 3, 700, 100, 2
    packed, qv = _inputs(e, w, rank_bits, seed=3)
    packed[1] = SENT
    qv[1] = 0.0
    k2, c2, n2 = _check_against_pallas(packed, qv, cap, rank_bits)
    assert n2[1] == 0 and (k2[1] == SENT).all() and (c2[1] == 0).all()
    assert n2[0] > cap and (k2[0] != SENT).all()


def test_plain_fused_merge_matches_sorts_path():
    """At the shapes of tests/test_sort_pallas.py:137-173, where the bound
    is on the scale of the prefix's ulps (row totals ~5e4)."""
    e, w, cap, rank_bits = 3, 700, 256, 2
    packed, qv = _inputs(e, w, rank_bits, seed=9)
    args = (torch.from_numpy(packed), torch.from_numpy(qv), cap, rank_bits)
    k_s, s_s, v_s, n_s = (x.numpy() for x in _merge_runs(*args))
    k_f, s_f, v_f, n_f = (x.numpy() for x in _merge_runs(*args,
                                                         merge="fused"))
    np.testing.assert_array_equal(k_f, k_s)
    np.testing.assert_array_equal(v_f, v_s)
    np.testing.assert_array_equal(n_f, n_s)
    np.testing.assert_allclose(s_f, s_s, rtol=1e-5, atol=1e-2)


def test_width_rule_keeps_wide_rows_on_the_sorts_path(monkeypatch):
    """Rows padded past 2^18 never reach K5 (sort_pallas.fits_invmem); one
    budget doubling of the flagship's 102,400 stays fused, a second does
    not."""
    from attpc_engine_tpu.detector.sort_pallas import fits_invmem
    from attpc_engine_tpu_torch.detector import deposition

    for w in (102_400, 204_800, 409_600, 2**18, 2**18 + 1):
        assert merge_cuda.fits_fused(w) == fits_invmem(w)
    assert merge_cuda.fits_fused(204_800) and not merge_cuda.fits_fused(409_600)

    def boom(*a, **k):
        raise AssertionError("K5 called past the width rule")

    monkeypatch.setattr(deposition, "merge_runs_fused", boom)
    e, w, cap, rank_bits = 1, 2**18 + 1, 64, 2
    packed, qv = _inputs(e, w, rank_bits, seed=5, n_space=1000)
    args = (torch.from_numpy(packed), torch.from_numpy(qv), cap, rank_bits)
    for r, g in zip(_merge_runs(*args), _merge_runs(*args, merge="fused")):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    with pytest.raises(ValueError):
        _merge_runs(*args, merge="Fused")
