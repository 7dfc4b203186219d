"""K5's cluster route (``csrc/merge_cluster.cu``) on the CPU: its route rule,
and a numpy emulation of the kernel's decomposition held bit for bit
against the JAX package's ``merge_runs_fused_pallas`` in interpret mode.

The kernel cannot run here, so the emulation repeats what its CTAs do, in
their order, with the kernel's own index arithmetic:

- each CTA loads its slice of ceil(W / n_cta) lanes and keeps only the live
  ones, in an order of its own (a shuffle here: equal elements are
  identical bits, so the order inside a CTA must not matter);
- eight stable LSD passes of 8-bit digits over the (key << 32 | bits(charge))
  ^ 2^63 elements, digit-major then CTA rank; pass 0 always scatters, a
  later pass whose digit takes one value over the N live elements is
  skipped; after pass 0 CTA r holds sorted positions [r * cl, (r + 1) * cl),
  cl = ceil(N / n_cta) rounded up to a multiple of 128;
- per CTA, one warp a 128-lane segment: lane l holds lanes l, 32 + l,
  64 + l, 96 + l, the scan steps d < 32 shuffle within each of the four
  and take the lower one's value below d, d = 32 and 64 add the values one
  and two rows down;
- the segment totals of all CTAs, the exclusive Hillis-Steele segment scan
  over as many steps as the Pallas row's power-of-two width gives;
- the run end of a CTA's last lane from the next CTA's first, the
  sentinel after the last live lane; the run-end counts exchanged for the
  first slot of each CTA; (KEY_SENTINEL, 0.0) in the slots past n_uniq.

Bounds: key2 and n_uniq exact, c2 bit for bit (the kernel adds the same
two f32 operands in each addition as the TPU kernel; numpy float32
additions round as the card's).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from attpc_engine_tpu.detector.sort_pallas import merge_runs_fused_pallas
from attpc_engine_tpu_torch.detector import merge_cuda, sort_cuda

SENT = 2**31 - 1
SIGN = np.uint64(1 << 63)
LANES = 128
CTAS = (1, 2, 4, 8, 16)


def _element(key: np.ndarray, q: np.ndarray) -> np.ndarray:
    hi = key.astype(np.uint32).astype(np.uint64) << np.uint64(32)
    return (hi | q.view(np.uint32).astype(np.uint64)) ^ SIGN


def _key(x: np.ndarray) -> np.ndarray:
    return ((x ^ SIGN) >> np.uint64(32)).astype(np.uint32).view(np.int32)


def _charge(x: np.ndarray) -> np.ndarray:
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.float32)


def _lane_scan(q: np.ndarray) -> np.ndarray:
    """One warp's scan of 128-lane segments [S, 4, 32] (v[j] at lane l is
    segment lane 32 j + l), as the kernel's registers and shuffles do it."""
    v = q.reshape(-1, 4, 32).astype(np.float32)
    lane = np.arange(32)
    zero = np.zeros_like(v[:, :1])
    d = 1
    while d < 32:
        u = np.roll(v, d, axis=2)  # u[j][l] = v[j][(l - d) & 31]
        lower = np.concatenate([zero, u[:, :-1]], axis=1)  # u[j - 1]
        v = v + np.where(lane >= d, u, lower)
        d *= 2
    v = v + np.concatenate([zero, v[:, :-1]], axis=1)  # d = 32
    v = v + np.concatenate([zero, zero, v[:, :-2]], axis=1)  # d = 64
    return v.reshape(-1, LANES)


def emulate_row(packed, qv, cap, rank_bits, n_cta, seed=0):
    """One row through the cluster kernel's decomposition on n_cta CTAs."""
    w = len(packed)
    rng = np.random.default_rng(seed)
    load = -(-w // n_cta)
    ctas = []
    for r in range(n_cta):
        k, q = packed[r * load:(r + 1) * load], qv[r * load:(r + 1) * load]
        live = k != SENT
        ctas.append(rng.permutation(_element(k[live], q[live])))
    n_live = sum(len(c) for c in ctas)
    per = -(-n_live // n_cta)
    cl = max(LANES, -(-per // LANES) * LANES)
    assert cl * n_cta >= n_live and cl <= -(-load // LANES) * LANES

    for p in range(8):
        shift = np.uint64(8 * p)
        digits = [((c >> shift) & np.uint64(255)).astype(np.int64)
                  for c in ctas]
        totals = sum(np.bincount(d, minlength=256) for d in digits)
        if p > 0 and (totals == n_live).any():
            continue  # the identity
        allx, alld = np.concatenate(ctas), np.concatenate(digits)
        row = allx[np.argsort(alld, kind="stable")]
        ctas = [row[r * cl:(r + 1) * cl] for r in range(n_cta)]
    assert [len(c) for c in ctas] == [max(0, min(cl, n_live - r * cl))
                                      for r in range(n_cta)]

    # lane scans and segment totals, per CTA
    cbufs, segtots = [], []
    for c in ctas:
        n_seg = -(-len(c) // LANES)
        q = np.zeros(n_seg * LANES, np.float32)
        q[:len(c)] = _charge(c)
        scanned = _lane_scan(q)
        cbufs.append(scanned.reshape(-1)[:len(c)])
        segtots.append(scanned[:, LANES - 1])
    # the segment scan, every CTA over the totals of all
    spc = cl // LANES
    s_live = -(-n_live // LANES)
    n_seg_full = max(2 * LANES, 1 << (w - 1).bit_length()) // LANES
    x = np.array([0.0 if g == 0 else segtots[(g - 1) // spc][(g - 1) % spc]
                  for g in range(s_live)], np.float32)
    g_idx = np.arange(s_live)
    d = 1
    while d < n_seg_full:
        x = x + np.where(g_idx >= d, np.roll(x, d), np.float32(0.0))
        d *= 2
    # run ends, their counts and slots
    keys = [_key(c) for c in ctas]
    ends = []
    for r, k in enumerate(keys):
        nxt = np.empty_like(k)
        nxt[:-1] = k[1:]
        if len(k):
            nxt[-1] = (keys[r + 1][0] if r + 1 < n_cta and len(keys[r + 1])
                       else SENT)
        ends.append(np.nonzero((k >> rank_bits) != (nxt >> rank_bits))[0])
    counts = [len(e) for e in ends]
    base = np.concatenate([[0], np.cumsum(counts)[:-1]])
    key2 = np.full(cap, SENT, np.int32)
    c2 = np.zeros(cap, np.float32)
    for r, idx in enumerate(ends):
        slot = base[r] + np.arange(len(idx))
        keep = slot < cap
        key2[slot[keep]] = keys[r][idx[keep]]
        c2[slot[keep]] = cbufs[r][idx[keep]] + x[r * spc + idx[keep] // LANES]
    return key2, c2, int(sum(counts))


def _case(name):
    """[E, W] keys and charges of one edge case, with its cap and rank bits."""
    rng = np.random.default_rng(len(name))
    e, w, cap, rank_bits, n_space, dead = 3, 4100, 2000, 2, 600, 0.3
    if name == "long_runs":  # runs of ~200 equal keys cross CTA boundaries
        n_space = 20
    if name == "small_cap":  # cap below n_uniq, not a multiple of 128
        cap, n_space = 100, 3000
    if name == "odd_width":
        w, cap = 701, 256
    if name == "no_sentinel":
        dead = 0.0
    space = rng.integers(0, n_space, (e, w)).astype(np.int32)
    packed = (space << rank_bits) | rng.integers(
        0, 1 << rank_bits, (e, w)).astype(np.int32)
    # whole charges, so equal (key, charge) elements occur
    qv = np.floor(rng.uniform(0.0, 40.0, (e, w))).astype(np.float32)
    mask = rng.random((e, w)) < dead
    if name == "all_sentinels":
        mask[0] = True
    if name == "one_live":
        mask[0] = True
        mask[0, w // 2] = False
        mask[1] = True
        mask[1, w - 1] = False
    packed[mask] = SENT
    qv[mask] = 0.0
    return packed, qv, cap, rank_bits


CASES = ("all_sentinels", "no_sentinel", "one_live", "long_runs", "small_cap",
         "odd_width")


@functools.lru_cache(maxsize=None)
def _reference(name):
    packed, qv, cap, rank_bits = _case(name)
    ref = tuple(np.asarray(a) for a in merge_runs_fused_pallas(
        jnp.asarray(packed), jnp.asarray(qv), cap, rank_bits, interpret=True))
    return (packed, qv, cap, rank_bits), ref


@pytest.mark.parametrize("n_cta", CTAS)
@pytest.mark.parametrize("name", CASES)
def test_emulated_cluster_merge_bit_exact_vs_pallas(name, n_cta):
    (packed, qv, cap, rank_bits), (k_ref, c_ref, n_ref) = _reference(name)
    for i in range(packed.shape[0]):
        k2, c2, n = emulate_row(packed[i], qv[i], cap, rank_bits, n_cta,
                                seed=i)
        np.testing.assert_array_equal(k2, k_ref[i])
        np.testing.assert_array_equal(c2.view(np.int32),
                                      c_ref[i].view(np.int32))
        assert n == n_ref[i]
    if name == "all_sentinels":
        assert n_ref[0] == 0 and (k_ref[0] == SENT).all()
    if name == "one_live":
        assert list(n_ref[:2]) == [1, 1]
    if name == "small_cap":
        assert (n_ref > cap).all()


def test_emulation_sees_runs_straddle_ctas():
    """The long-run case does put a run across a CTA boundary: at 16 CTAs
    some CTA's last live key equals the next CTA's first."""
    packed, qv, cap, rank_bits = _case("long_runs")
    row = packed[0]
    live = np.sort(row[row != SENT])
    cl = max(LANES, -(-(-(-len(live) // 16)) // LANES) * LANES)
    edges = np.arange(cl, len(live), cl)
    assert (live[edges - 1] >> rank_bits == live[edges] >> rank_bits).any()


@pytest.mark.parametrize("w,expected", [
    (1, ("cluster", 1)),
    (12_288, ("cluster", 1)),
    (13_360, ("cluster", 1)),
    (13_361, ("cluster", 2)),
    (51_200, ("cluster", 4)),
    (102_400, ("cluster", 8)),
    (106_881, ("cluster", 16)),
    (204_800, ("cluster", 16)),
    (213_760, ("cluster", 16)),
    (213_761, ("two_launch", 0)),
    (250_000, ("two_launch", 0)),
    (2**18, ("two_launch", 0)),
])
def test_merge_route_rule(w, expected):
    """Rows a 16-CTA cluster holds take the cluster kernel at K3's cluster
    size for the width, with buffers of ceil(W / n_cta) rounded up to 128
    that fit a CTA's shared memory; wider rows up to fits_fused take the
    two-launch route."""
    r = merge_cuda.route(w)
    assert (r.name, r.n_cta) == expected
    if r.name == "cluster":
        assert r.n_cta == sort_cuda.route(w).n_cta
        assert r.chunk % LANES == 0 and r.chunk * r.n_cta >= w
        assert r.chunk >= -(-w // r.n_cta)
        assert r.shared_bytes <= sort_cuda.SHARED_BYTES


@pytest.mark.parametrize("w", [0, 2**18 + 1, 409_600])
def test_merge_route_refuses_rows_past_fits_fused(w):
    with pytest.raises(ValueError):
        merge_cuda.route(w)
