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
from attpc_engine_tpu_torch.detector import compact_cuda, sort_cuda
from attpc_engine_tpu_torch.detector.deposition import (
    KEY_SENTINEL,
    _merge_rows,
    _merge_runs,
    _prefix_sum,
    _run_sums,
)
from attpc_engine_tpu_torch.detector.sort_cuda import pack64, unpack64
from tests.merge_cases import (
    LIVE_CASES,
    LIVE_EDGES,
    live_merge_passes,
    live_plan,
    live_rows,
    merge_rows,
)


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


def _left_to_right(x):
    """Inclusive prefix along the last axis, one addition after another,
    as each thread of the compaction kernel sums its 16 values."""
    out = x.clone()
    for j in range(1, x.shape[-1]):
        out[..., j] = out[..., j - 1] + x[..., j]
    return out


def _compact_decomposed(sorted_rows, cap, rank_bits):
    """The run-end compaction kernel (csrc/compact_runs.cu) as it
    decomposes the work, in PyTorch: the row cut into tiles of TILE lanes
    (dead lanes past the end), the totals kernel's level-1 block totals,
    segment totals and run-end counts a tile; the carry kernel's slot scan
    and its prefix of the segment totals through the upper levels; the
    write kernel's carry for each level-1 block and its slots. Returns the
    kernel's outputs and the prefix at every lane of the row."""
    e, w = sorted_rows.shape
    blk = 16
    tiles = -(-w // compact_cuda.TILE)
    lanes = tiles * compact_cuda.TILE
    rows = torch.nn.functional.pad(sorted_rows, (0, lanes - w),
                                   value=KEY_SENTINEL << 32)
    key, q = unpack64(rows)
    i = torch.arange(lanes)
    nxt = torch.cat([key[:, 1:], torch.full((e, 1), KEY_SENTINEL,
                                            dtype=torch.int32)], dim=1)
    last = (i < w) & (key != KEY_SENTINEL) & (
        (i + 1 == w) | ((key >> rank_bits) != (nxt >> rank_bits)))

    # totals kernel
    inner0 = _left_to_right(q.reshape(e, -1, blk))  # [E, blocks, 16]
    t1 = inner0[..., -1]
    t2 = _left_to_right(t1.reshape(e, -1, blk))[..., -1]  # [E, segments]
    tile_ends = last.reshape(e, tiles, -1).sum(dim=2)

    # carry kernel: slots, then the segment prefix level by level
    first = torch.cumsum(tile_ends, dim=1) - tile_ends
    n_uniq = tile_ends.sum(dim=1).to(torch.int32)
    n_seg = -(-w // compact_cuda.SEGMENT)
    a, inners = t2[:, :n_seg], []
    while a.shape[1] > blk:
        m = a.shape[1]
        inner = _left_to_right(torch.nn.functional.pad(
            a, (0, (-m) % blk)).reshape(e, -1, blk))
        inners.append(inner.reshape(e, -1)[:, :m])
        a = inner[..., -1]
    pre = _left_to_right(a)
    for inner in reversed(inners):
        b = torch.arange(inner.shape[1]) // blk
        pre = inner + torch.where(b == 0, 0.0,
                                  pre[:, torch.clamp(b - 1, min=0)])

    # write kernel: the carry of each level-1 block b1
    b1 = torch.arange(lanes // blk)
    p = b1 % blk
    seg = b1 // blk
    in_seg = torch.cat([torch.zeros(e, t1.shape[1] // blk, 1),
                        _left_to_right(t1.reshape(e, -1, blk))[..., :-1]],
                       dim=2).reshape(e, -1)
    prev_t2 = torch.cat([torch.zeros(e, 1), t2[:, :-1]], dim=1)
    s = torch.where(p > 0, seg, seg - 1)
    inner = torch.where(p > 0, in_seg, prev_t2[:, seg])
    if w > compact_cuda.SEGMENT:
        pre_all = torch.nn.functional.pad(pre, (0, t2.shape[1] - n_seg))
        inner = inner + torch.where(s <= 0, 0.0,
                                    pre_all[:, torch.clamp(s - 1, min=0)])
    carry = torch.where(b1 == 0, 0.0, inner)
    c = (inner0 + carry[..., None] if w > blk else inner0).reshape(e, -1)

    slot = first.repeat_interleave(compact_cuda.TILE, dim=1) + (
        torch.cumsum(last.reshape(e, tiles, -1), dim=2)
        - last.reshape(e, tiles, -1).to(torch.int64)).reshape(e, -1)
    put = last & (slot < cap)
    dest = torch.where(put, torch.arange(e)[:, None] * cap + slot, e * cap)
    key2 = torch.full((e * cap + 1,), KEY_SENTINEL, dtype=torch.int32)
    c2 = torch.zeros(e * cap + 1)
    key2[dest.reshape(-1)] = key.reshape(-1)
    c2[dest.reshape(-1)] = c.reshape(-1)
    return (key2[:-1].reshape(e, cap), c2[:-1].reshape(e, cap), n_uniq,
            c[:, :w])


@pytest.mark.parametrize("w", [1, 16, 17, 4103, 12288, 192000, 213761,
                               819200, 1638400])
def test_compaction_decomposition_is_the_sorts_path(w):
    """The compaction kernel's tiles, tile totals, upper-level carries and
    slot scan give ``_prefix_sum``'s prefix and the plain ``_merge_rows``
    bit for bit: widths of one lane, one and two blocks of 16, ragged
    tiles, c16dd's and the chain's merge rows and the chain's first retry
    doubling; a row of dead lanes only, runs across tile boundaries, caps
    below and above n_uniq, rank_bits 1 and 2."""
    for rank_bits in (1, 2):
        rows = merge_rows(w, rank_bits)
        srt = torch.sort(rows, dim=1).values
        for cap in (max(1, w // 7), w):
            key2, c2, n_uniq, c = _compact_decomposed(srt, cap, rank_bits)
            assert torch.equal(c.view(torch.int32),
                               _prefix_sum(unpack64(srt)[1]).view(torch.int32))
            got = _run_sums(key2, c2, n_uniq)
            ref = _merge_rows(rows, cap, rank_bits)
            for g, r in zip(got, ref):
                assert g.dtype == r.dtype and torch.equal(
                    g.view(torch.int32) if g.is_floating_point() else g,
                    r.view(torch.int32) if r.is_floating_point() else r)
            assert torch.equal(c2.view(torch.int32), torch.where(
                key2 != KEY_SENTINEL, c2, 0.0).view(torch.int32))
            assert int(n_uniq[1]) == 0 and int(n_uniq[3]) > 0
            if cap < w and w > 16:
                assert int(n_uniq.max()) > cap


@pytest.mark.parametrize("w,name,n_cta", [
    (1, "cluster", 1), (12288, "cluster", 1), (102400, "cluster", 8),
    (204800, "cluster", 16), (213761, "wide", 1), (262145, "wide", 1),
    (409600, "wide", 1), (819200, "wide", 1),
])
def test_sort_route_rule(w, name, n_cta):
    """K3's width rule: the smallest cluster whose CTAs hold the row, each
    an even chunk within a block's 232,448 B of shared memory, else the
    wide route: the fewest chunks, a power of two >= 2, of at most
    WIDE_CHUNK elements, each on the cluster the rule gives its width."""
    r = sort_cuda.route(w)
    assert (r.name, r.n_cta) == (name, n_cta)
    assert r.chunk % 2 == 0 and r.n_cta * r.chunk >= r.chunk_w
    assert r.shared_bytes == 16 * r.chunk + sort_cuda.FIXED_BYTES
    assert r.shared_bytes <= sort_cuda.SHARED_BYTES == 232_448
    if r.name == "cluster":
        assert (r.chunks, r.chunk_w, r.passes) == (1, w, 0)
        smaller = [n for n in sort_cuda.CLUSTER_SIZES if n < r.n_cta]
        assert not smaller or smaller[-1] * sort_cuda.CTA_CAPACITY < w
    else:
        assert w > sort_cuda.CLUSTER_SIZES[-1] * sort_cuda.CTA_CAPACITY
        assert r.chunks >= 2 and r.chunks & (r.chunks - 1) == 0
        assert r.passes == r.chunks.bit_length() - 1
        assert r.chunks * r.chunk_w >= w > (r.chunks - 1) * r.chunk_w
        assert r.chunk_w <= sort_cuda.WIDE_CHUNK
        assert r.chunks == 2 or -(-w // (r.chunks // 2)) > sort_cuda.WIDE_CHUNK
        assert sort_cuda.route(r.chunk_w)[:3] == ("cluster", r.n_cta, r.chunk)
        assert r == sort_cuda.wide_plan(w, r.chunks)
    assert sort_cuda.WIDE_CHUNK <= 16 * sort_cuda.CTA_CAPACITY
    assert sort_cuda.route(16 * sort_cuda.CTA_CAPACITY).shared_bytes <= (
        sort_cuda.SHARED_BYTES)


def _split(a, b, d):
    """Merge path split of diagonal d (csrc/merge_rows.cu ``split``): how
    many of the first d outputs of merging a and b come from a, where
    a[i] <= b[j] takes a."""
    lo, hi = max(0, d - len(b)), min(d, len(a))
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] <= b[d - 1 - mid]:
            lo = mid + 1
        else:
            hi = mid
    return lo


def _merge_pass(rows, run, threads, items):
    """One pass of merge_rows.cu, emulated: the partition searches each
    tile's first diagonal over the whole pair, then each thread of a tile
    searches its own diagonal inside the tile's slices and merges its
    ``items`` outputs serially, with the same tie rule throughout."""
    tile = threads * items
    out = []
    for row in rows.tolist():
        w, merged = len(row), []
        for a0 in range(0, w, 2 * run):
            na = min(run, w - a0)
            nb = max(0, min(run, w - a0 - na))
            a, b = row[a0:a0 + na], row[a0 + na:a0 + na + nb]
            tiles = -(-2 * run // tile)
            splits = [_split(a, b, min(q * tile, na + nb))
                      for q in range(tiles + 1)]
            for q in range(tiles):
                d0 = min(q * tile, na + nb)
                d1 = min(d0 + tile, na + nb)
                sa = a[splits[q]:splits[q + 1]]
                sb = b[d0 - splits[q]:d1 - splits[q + 1]]
                for k0 in range(0, d1 - d0, items):
                    ia = _split(sa, sb, k0)
                    jb = k0 - ia
                    for _ in range(min(items, d1 - d0 - k0)):
                        if ia < len(sa) and (jb >= len(sb) or sa[ia] <= sb[jb]):
                            merged.append(sa[ia])
                            ia += 1
                        else:
                            merged.append(sb[jb])
                            jb += 1
        out.append(merged)
    return torch.tensor(out, dtype=torch.int64)


def _wide_rows(case, rng):
    """Signed int64 rows for the merge-path test, by case."""
    e, w = 3, 157
    if case == "all_equal":
        return np.full((e, w), 42, dtype=np.int64)
    if case == "two_valued":
        return np.where(rng.random((e, w)) < 0.5, 3, 8).astype(np.int64)
    if case == "int64_max_runs":
        return np.where(rng.random((e, w)) < 0.6, np.int64(2**63 - 1),
                        rng.integers(-5, 5, (e, w)))
    if case == "negative_keys":
        return rng.integers(-2**63, 0, (e, w)) | rng.integers(0, 3, (e, w))
    if case == "ragged_last_chunk":  # 157 = 4 * 40 - 3
        return rng.integers(-20, 20, (e, w))
    return rng.integers(-2**62, 2**62, (e, 331))  # runs of 83, tiles of 12


@pytest.mark.parametrize("case", [
    "all_equal", "two_valued", "int64_max_runs", "negative_keys",
    "ragged_last_chunk", "runs_not_multiples_of_the_tile",
])
def test_wide_merge_path_partition_and_ties(case):
    """Phase B of K3's wide route, emulated at tiles of 4 threads x 3
    elements on the plan's chunks (each sorted by torch.sort in place of
    the cluster kernel): after log2(chunks) passes every row equals
    torch.sort's, bit for bit; no element is lost or doubled at a tile
    edge, whatever the duplicates."""
    x = torch.from_numpy(_wide_rows(case, np.random.default_rng(7)))
    w = x.shape[1]
    r = sort_cuda.wide_plan(w, 4)
    rows = torch.cat([torch.sort(c, dim=1).values
                      for c in torch.split(x, r.chunk_w, dim=1)], dim=1)
    run = r.chunk_w
    for _ in range(r.passes):
        rows = _merge_pass(rows, run, threads=4, items=3)
        run *= 2
    assert torch.equal(rows, torch.sort(x, dim=1).values)


SENT_ELEM = KEY_SENTINEL << 32


def _sort_segment(src, dst, s0, s1, n_cta, chunk):
    """One cluster of the live kernel (csrc/sort_cluster.cu ``sort_live``)
    on lanes [s0, s1) of a numpy row: CTA m loads its even share of them
    and keeps what is not the sentinel, the N kept elements are sorted (the
    passes; equal elements are equal bits) and spread, CTA m storing
    sorted positions [m * cl, m * cl + n_m), cl = max(2, ceil(N / n_cta)),
    then the CTAs write the sentinel over [N, s1 - s0) in even shares.
    Every lane of the segment is written exactly once, and no CTA holds
    more than ``chunk`` elements."""
    length = s1 - s0
    load = -(-length // n_cta)
    assert load <= chunk
    held = []
    for m in range(n_cta):
        seg = src[s0 + min(m * load, length):s0 + min((m + 1) * load, length)]
        held.append(seg[seg != SENT_ELEM])
    n_live = sum(len(h) for h in held)
    cl = max(2, -(-n_live // n_cta))
    assert cl <= chunk
    srt = np.sort(np.concatenate(held))
    out = np.full(length, -1, dtype=np.int64)
    writes = np.zeros(length, dtype=np.int64)
    for m in range(n_cta):
        n_m = max(0, min(cl, n_live - m * cl))
        out[m * cl:m * cl + n_m] = srt[m * cl:m * cl + n_m]
        writes[m * cl:m * cl + n_m] += 1
    rest = length - n_live
    per = -(-rest // n_cta)
    for m in range(n_cta):
        f0 = min(rest, m * per)
        f1 = min(rest, f0 + per)
        out[n_live + f0:n_live + f1] = SENT_ELEM
        writes[n_live + f0:n_live + f1] += 1
    assert (writes == 1).all()
    dst[s0:s1] = out


def _live_emulated(x, lanes):
    """K3's live route on numpy rows [E, W], as its launches split the work
    (``merge_cases.live_plan``): each cluster launch takes the rows whose
    prefix lies in (lo, hi], the cluster-1 launch lists the wide rows; the
    wide launch sorts each listed row's chunks of CTA_CAPACITY lanes into
    the buffer that the parity of the row's merge passes gives, and merge
    pass j joins pairs of runs of CTA_CAPACITY << j lanes over each prefix
    with more than j passes, from one buffer into the other (each run
    must be sorted when it is read). Returns the rows and each row's sites."""
    e, w = x.shape
    cap = sort_cuda.CTA_CAPACITY
    rows = x.copy()
    scratch = np.full_like(rows, -1)
    sites = [[] for _ in range(e)]
    wide = []
    for launch in live_plan(w):
        if launch.site != "wide":
            for r in range(e):
                if (launch.site == "cluster-1"
                        and lanes[r] > sort_cuda.LIVE_CLUSTER_LANES):
                    wide.append(r)
                if launch.lo < lanes[r] <= launch.hi:
                    sites[r].append(launch.site)
                    _sort_segment(rows[r], rows[r], 0, lanes[r],
                                  launch.n_cta, launch.chunk)
            continue
        for r in wide:
            sites[r].append("wide")
            dst = scratch if live_merge_passes(lanes[r]) % 2 else rows
            for s0 in range(0, lanes[r], cap):
                _sort_segment(rows[r], dst[r], s0, min(s0 + cap, lanes[r]), 1,
                              launch.chunk)
        for j in range(launch.passes):
            run = cap << j
            for r in wide:
                passes = live_merge_passes(lanes[r])
                if j >= passes:
                    continue
                src, dst = ((scratch, rows) if (passes - j) % 2
                            else (rows, scratch))
                for a in range(0, lanes[r], 2 * run):
                    b, z = min(a + run, lanes[r]), min(a + 2 * run, lanes[r])
                    for lo, hi in ((a, b), (b, z)):
                        assert (np.diff(src[r, lo:hi]) >= 0).all()
                    dst[r, a:z] = np.sort(src[r, a:z])
    return rows, sites


def _site(v):
    """The one site ``sort_cuda.live_sites`` gives a prefix of v lanes."""
    (site,) = sort_cuda.live_sites([v])
    return site


@pytest.mark.parametrize("case", LIVE_CASES)
@pytest.mark.parametrize("w", [192000, 819200])
def test_live_route_emulated_is_the_full_sort(w, case):
    """K3's live route, emulated launch by launch, gives torch.sort's rows
    bit for bit, on c16dd's and the chain's merge widths, for prefixes of
    0 lanes, of the whole row, and at 1, 4, 8 and 16 CTAs' 13,360 lanes and
    one either side, with scattered sentinels, none, only sentinels, or
    equal keys of different charges; each row takes the one route
    ``sort_cuda.live_sites`` names (none for an empty prefix), and the
    plain version is torch.sort of the whole row."""
    lanes = np.array([v for v in LIVE_EDGES if v <= w] + [w], dtype=np.int64)
    x = live_rows(w, lanes, case)
    ref = sort_cuda.sort_rows_plain(x)
    got, sites = _live_emulated(x.numpy(), lanes)
    assert np.array_equal(got, ref.numpy())
    assert sites == [[] if v == 0 else [_site(v)] for v in lanes]
    plain = sort_cuda.sort_rows_live(x, torch.from_numpy(lanes).int())
    assert torch.equal(plain, ref)
    counted = sort_cuda.live_sites(lanes)
    assert counted == {s: [_site(v) for v in lanes].count(s) for s in counted}
    assert sum(counted.values()) == len(lanes)


@pytest.mark.parametrize("w", [1, 100, 13360, 13361, 26721, 53441, 192000,
                               213760, 213761, 819200, 1638400])
def test_live_plan_takes_each_prefix_once(w):
    """The live route's launches over rows of ``w``: every cluster route a
    prefix of at most ``w`` lanes could need, up to 8 CTAs, each of even
    chunks that hold every share of the prefixes it takes, within a
    block's shared memory, and the wide route exactly where a prefix can
    pass 8 CTAs, with the passes of the widest prefix (the launches as
    ``merge_cases.live_plan`` emulates them). Every prefix in (0, w] is
    taken by exactly one launch, the one ``sort_cuda.live_sites`` names; 0
    by none."""
    plan = live_plan(w)
    cap = sort_cuda.CTA_CAPACITY
    assert sort_cuda.LIVE_CLUSTER_SIZES == (1, 2, 4, 8)
    assert [p.site for p in plan if p.site != "wide"] == [
        f"cluster-{n}" for n in sort_cuda.LIVE_CLUSTER_SIZES
        if (n // 2) * cap < w or n == 1]
    assert (plan[-1].site == "wide") == (w > sort_cuda.LIVE_CLUSTER_LANES)
    prefixes = {0, 1, w, w - 1, *(v for v in LIVE_EDGES if v <= w)}
    prefixes |= set(np.random.default_rng(w).integers(0, w + 1, 200).tolist())
    for v in sorted(prefixes):
        takers = [p for p in plan
                  if (p.lo < v <= p.hi if p.site != "wide" else p.lo < v)]
        assert [p.site for p in takers] == ([] if v <= 0 else
                                            [_site(v)])
        for p in takers:
            share = cap if p.site == "wide" else -(-v // p.n_cta)
            assert share <= p.chunk and p.chunk % 2 == 0
            assert 16 * p.chunk + sort_cuda.FIXED_BYTES <= (
                sort_cuda.SHARED_BYTES)
            chunks = -(-v // cap)
            passes = live_merge_passes(v)
            assert 2**passes >= chunks > 2 ** (passes - 1) or chunks == 1
            if p.site == "wide":
                assert p.passes == live_merge_passes(w) >= passes
    assert sort_cuda.live_sites([0, 0]) == {"empty": 2}


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
    live = (Path(sort_cuda.__file__).resolve().parents[1] / "csrc"
            / "sort_live.cuh").read_text()
    assert int(re.search(r"constexpr int kLiveChunk = (\d+);", live)[1]) == (
        sort_cuda.CTA_CAPACITY)
    ctas = re.search(r"constexpr int64_t kLiveClusterLanes = "
                     r"(\d+) \* \(int64_t\)kLiveChunk;", live)[1]
    assert int(ctas) * sort_cuda.CTA_CAPACITY == sort_cuda.LIVE_CLUSTER_LANES
