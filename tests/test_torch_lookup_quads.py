"""K2's and K7's CUDA kernel (``quad_lookup_kernel`` in csrc/deposit.cu) as
its threads compute it, emulated in numpy on the CPU, and the 32-bit index
rule of their wrappers.

The kernel cannot run here, so its decomposition is emulated thread by
thread from the constants of the source: thread q of the grid (blocks of
``kThreads``) owns quad q of the [P, 10, 10] output, keys 4 q .. 4 q + 3 of
point q // 25; it loads that point's tbr, the x cells of the quad's one or
two rows and its four y cells (clamped), gathers four pad ids, adds the
key transform (K2) and writes one 16-byte slot. A quad is two pairs of
horizontally adjacent keys, pair h of its point on x row h // 5 at y cells
2 (h % 5) and 2 (h % 5) + 1; 100 keys a point make 25 quads, so no quad
straddles two points, but the quads at y cells 8, 9 and 0, 1 straddle two
x rows. The threads of the last block past the last quad write nothing.
The emulation must equal the plain versions and the Pallas kernels in
interpret mode bit for bit, with every slot written exactly once, at
P = 1, 3 and 5003 (the last block ragged) and 300.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attpc_engine_tpu.detector.deposit_pallas import (
    packed_key_lookup_2s_pallas,
    pad_lookup_pallas,
)
from attpc_engine_tpu_torch.detector import deposit_cuda
from tests.test_torch_deposit import _lookup_inputs
from tests.test_torch_host import jax_config

SRC = (Path(__file__).resolve().parents[1] / "attpc_engine_tpu_torch"
       / "csrc" / "deposit.cu")
SENT = 2**31 - 1
QUADS = 25  # 100 keys a point, 4 a quad


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SRC.read_text())
    assert m, name
    return int(m.group(1))


THREADS = _constant("kThreads")
POISON = -7777


def emulate_quads(ix, iy, tbr, table, rank_bits, sentinel, keys: bool):
    """quad_lookup_kernel<keys> on numpy arrays. Returns the [P, 10, 10]
    output, how many times each 16-byte slot was written, the grid's block
    count and the number of quads whose keys lie on two x rows."""
    n_points = ix.shape[0]
    n_quads = n_points * QUADS
    blocks = -(-n_quads // THREADS)
    q = np.arange(blocks * THREADS)
    q = q[q < n_quads]  # the last block's threads past the quads return
    p = q // QUADS
    h = 2 * (q - p * QUADS)
    ra, rb = h // 5, (h + 1) // 5
    ca, cb = 2 * (h - 5 * ra), 2 * (h + 1 - 5 * rb)
    key = 100 * p[:, None] + np.stack(
        [10 * ra + ca, 10 * ra + ca + 1, 10 * rb + cb, 10 * rb + cb + 1], 1)
    assert (key == 4 * q[:, None] + np.arange(4)).all()  # the quad's keys
    ixf, iyf = ix.reshape(-1).astype(np.int64), iy.reshape(-1).astype(np.int64)
    xa = np.clip(ixf[p * 10 + ra], 0, 559) * 640
    xb = np.clip(ixf[p * 10 + rb], 0, 559) * 640
    y = [np.clip(iyf[p * 10 + c], 0, 639) for c in (ca, ca + 1, cb, cb + 1)]
    flat = table.reshape(-1).astype(np.int64)
    v = np.stack([flat[xa + y[0]], flat[xa + y[1]], flat[xb + y[2]],
                  flat[xb + y[3]]], 1)
    if keys:
        v = np.where(v < 10240, v * (512 << rank_bits)
                     + tbr.astype(np.int64)[p, None], sentinel)
    slots = np.full((n_quads, 4), POISON, np.int64)
    slots[q] = v
    writes = np.bincount(q, minlength=n_quads)
    out = slots.astype(np.int32).reshape(n_points, 10, 10)
    return out, writes, blocks, int((ra != rb).sum())


def test_quads_of_full_and_ragged_grids():
    """Every quad is written once by one thread; five quads a point
    straddle two x rows; the last block holds the grid's ragged tail."""
    table = np.arange(560 * 640, dtype=np.int32).reshape(560, 640) % 10241
    for p in (1, THREADS * 4 // QUADS, 5003):
        ix, iy, tbr = _lookup_inputs(p, 5)
        _, writes, blocks, straddles = emulate_quads(ix, iy, tbr, table, 1,
                                                     SENT, True)
        assert (writes == 1).all() and straddles == 5 * p
        assert 0 <= blocks * THREADS - p * QUADS < THREADS


@pytest.mark.parametrize("p", [1, 3, 300, 5003])
@pytest.mark.parametrize("kernel", ["K2", "K7"])
def test_quad_kernel_emulation_matches_plain_and_pallas(kernel, p):
    """The emulated kernel against the plain version and the Pallas kernel
    in interpret mode (K2: packed_key_lookup_2s_pallas; K7:
    pad_lookup_pallas), bit for bit, with out-of-plane cells and cells
    aliased onto the table's sentinel padding; every slot written once."""
    dev = jax_config().device_arrays()
    table = (dev["plane_hi"] * 128 + dev["plane_lo"]).astype(np.int32)
    ix, iy, tbr = _lookup_inputs(p, p)
    keys = kernel == "K2"
    got, writes, _, straddles = emulate_quads(ix, iy, tbr, table, 1, SENT,
                                              keys)
    assert (writes == 1).all() and straddles == 5 * p
    args = [torch.from_numpy(a) for a in (ix, iy)]
    if keys:
        plain = deposit_cuda.packed_key_lookup_plain(
            *args, torch.from_numpy(tbr), torch.from_numpy(table), 1, SENT)
        ref = packed_key_lookup_2s_pallas(
            jnp.asarray(ix), jnp.asarray(iy), jnp.asarray(tbr),
            dev["plane_hi"], dev["plane_lo"], rank_bits=1, sentinel=SENT,
            interpret=True)
    else:
        plain = deposit_cuda.pad_lookup_plain(*args, torch.from_numpy(table))
        ref = pad_lookup_pallas(ix, iy, dev["plane_hi"], dev["plane_lo"],
                                interpret=True)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_k2_k7_wrappers_refuse_keys_past_int32():
    """K2 and K7 index their P * 100 keys in int32: their wrappers refuse
    P * 100 >= 2**31 before they look at the tensors (meta tensors here:
    no storage), and take the largest P below it up to the device check.
    The overflow retry's widest batches are far below the limit."""
    m = deposit_cuda.MAX_POINTS
    assert m * 100 < 2**31 <= (m + 1) * 100
    deposit_cuda.require_int32_keys(384 * 4096)
    deposit_cuda.require_int32_keys(m)
    with pytest.raises(ValueError, match=r"2\*\*31"):
        deposit_cuda.require_int32_keys(m + 1)
    before = (deposit_cuda.launches, deposit_cuda.launches_pad_lookup)
    for n, why in ((m + 1, r"2\*\*31"), (m, "CUDA tensor")):
        ix = torch.empty((n, 10), dtype=torch.int32, device="meta")
        tbr = torch.empty((n,), dtype=torch.int32, device="meta")
        table = torch.empty((560, 640), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match=why):
            deposit_cuda.packed_key_lookup_cuda(ix, ix, tbr, table, 1, SENT)
        with pytest.raises(ValueError, match=why):
            deposit_cuda.pad_lookup_cuda(ix, ix, table)
    assert (deposit_cuda.launches, deposit_cuda.launches_pad_lookup) == before
