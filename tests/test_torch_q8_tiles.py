"""The arithmetic of kernel D (q8_gemv_i8) on the CPU.

The kernel (lmrs_tpu_torch/csrc/q8_gemv_i8.cu) quantizes x inside each block
and runs the W8A8 GEMV on the int8 tensor cores: mma.sync m16n8k32, A = 16
weight rows read from a TMA ring (128-byte swizzle), B = xq with row t of x
in column t of one n8 tile; a thread reads one contiguous gs/4-byte piece
of its rows and of its row of xq for each group, step j of the group taking
bytes 8j .. 8j+7 of the piece (the low four as k slots 4t4..4t4+3, the high
four as 16+4t4..16+4t4+3); a group's steps sum exactly in int32, then
acc += (float(c) * ws) * xs, each product rounded, in increasing group
order; split K over S ranks of whole groups (rank r: groups
[ng*r/S, ng*(r+1)/S)), their sums added in rank order.  These tests emulate
those steps with torch and hold:

- the k slots: every byte of a group is one slot of one step, A's and B's
  slots name the same bytes, so the emulated tensor-core dot is the group's
  integer dot exactly, for every group size the kernel takes;
- the ring: the kernel's swizzled address of a thread's 16 bytes is where
  TMA's 128-byte swizzle (its address-bit form, Swizzle<3, 4, 3>) put them, and at the models' group size (128) the eight
  threads of a quarter warp read eight different 16-byte bank groups (no
  conflict; two-way at the other group sizes);
- the emulated sum: within 1e-4 of the output scale of `q8_gemv_i8_plain`
  and of the JAX `_q8_xei8_stacked_kernel` (`qmatmul_pallas_stacked` in
  interpret mode, the reference's W8A8 path), at every split S, and a row
  the same bits whatever T is (T = 1-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.kernels.dequant_matmul import qmatmul_pallas_stacked
from lmrs_tpu.quant import QuantType as JQuantType
from lmrs_tpu.quant import qtensor_from_float_np

from lmrs_tpu_torch.kernels.q8_gemv_i8 import q8_gemv_i8_plain
from lmrs_tpu_torch.quant import quantize_q8_act

torch.set_num_threads(1)

GROUP_SIZES = (32, 64, 128, 256)


def slot_bytes(gs: int, t4: int, step: int):
    """The group bytes that k slots 0..31 of `step` hold for the threads of
    quad position t4 (A's row g and B's column g alike): slot 4*t4 + i is
    byte W*t4 + 8*step + i, slot 16 + 4*t4 + i byte W*t4 + 8*step + 4 + i,
    W = gs / 4."""
    w = gs // 4
    lo = [w * t4 + 8 * step + i for i in range(4)]
    hi = [w * t4 + 8 * step + 4 + i for i in range(4)]
    return {4 * t4 + i: b for i, b in enumerate(lo)} | \
        {16 + 4 * t4 + i: b for i, b in enumerate(hi)}


def slot_map(gs: int):
    """(steps, 32) byte of each k slot of each step of a group."""
    steps = gs // 32
    m = np.full((steps, 32), -1)
    for j in range(steps):
        for t4 in range(4):
            for slot, b in slot_bytes(gs, t4, j).items():
                m[j, slot] = b
    return m


@pytest.mark.parametrize("gs", GROUP_SIZES)
def test_k_slots_cover_each_group_byte_once(gs):
    m = slot_map(gs)
    assert (m >= 0).all()
    assert sorted(m.ravel().tolist()) == list(range(gs))
    # a thread's bytes of a group are one contiguous gs/4-byte piece
    w = gs // 4
    for t4 in range(4):
        got = sorted(b for j in range(gs // 32)
                     for b in slot_bytes(gs, t4, j).values())
        assert got == list(range(w * t4, w * (t4 + 1)))


@pytest.mark.parametrize("gs", GROUP_SIZES)
def test_emulated_tensor_core_dot_is_the_group_dot(gs):
    rng = np.random.default_rng(gs)
    wq = rng.integers(-127, 128, (16, gs))
    xq = rng.integers(-127, 128, (8, gs))
    m = slot_map(gs)
    c = np.zeros((16, 8), dtype=np.int64)
    for j in range(gs // 32):
        a = wq[:, m[j]]                 # (16, 32): A, row-major
        b = xq[:, m[j]].T               # (32, 8): B, column g = row g of x
        c += a @ b
    assert np.array_equal(c, wq @ xq.T)
    assert np.abs(c).max() < 2 ** 31    # int32 holds a group's dot


def ring_addr(r: int, off: int) -> int:
    """The kernel's ring_addr: byte `off` of row r of a stage of 128-row
    boxes, 128 bytes a row a box, 128-byte swizzle."""
    box, chunk = off >> 7, (off >> 4) & 7
    return box * 128 * 128 + r * 128 + (((chunk ^ (r & 7)) << 4) | (off & 15))


def tma_swizzle_128b(addr: int) -> int:
    """CU_TENSOR_MAP_SWIZZLE_128B as an address map (CUTLASS's Swizzle<3, 4,
    3>): the box is written in order from a 1024-aligned base, and bits 4-6
    of each byte's offset are XORed with bits 7-9."""
    return addr ^ ((addr >> 3) & 0x70)


def box_offset(r: int, off: int) -> int:
    """Byte `off` of row r in the stage's boxes as TMA writes them, before
    the swizzle: box off // 128 after box, each 128 rows of 128 bytes."""
    return (off // 128) * 128 * 128 + r * 128 + off % 128


@pytest.mark.parametrize("gs,ways", [(32, 2), (64, 2), (128, 1), (256, 2)])
def test_ring_reads_find_the_swizzled_bytes_without_conflict(gs, ways):
    w = gs // 4
    stage_bytes = max(gs, 128)
    for r in range(128):
        for off in range(stage_bytes):
            assert ring_addr(r, off) == tma_swizzle_128b(box_offset(r, off))
    # a quarter warp: lanes (g, t4) with g in {2q, 2q+1}, each reading 16
    # bytes (8 for gs = 32, where a half warp shares a wavefront)
    lanes = 8 if w >= 16 else 16
    for warp in range(8):
        for grp in range(stage_bytes // gs):
            for first in range(0, 32, lanes):
                for u in range(0, w, 16 if w >= 16 else 8):
                    banks = []
                    for lane in range(first, first + lanes):
                        g, t4 = lane >> 2, lane & 3
                        a = ring_addr(warp * 16 + g, grp * gs + t4 * w + u)
                        banks.append((a % 128) // (16 if w >= 16 else 8))
                    assert max(banks.count(b) for b in banks) <= ways


def emulate(x, q, s, gs, split):
    """Kernel D's order of operations: quantize x, the exact group dots,
    (float(c) * ws) * xs rounded in f32, summed over each rank's groups in
    increasing order, the ranks' sums in rank order.  Every column of the
    tile takes the same operations whatever T is."""
    t, k = x.shape
    o, ng = s.shape
    xq, xs = quantize_q8_act(x.float(), gs)
    dots = torch.einsum("tgk,ogk->tog",
                        xq.reshape(t, ng, gs).to(torch.int64),
                        q.reshape(o, ng, gs).to(torch.int64))
    assert dots.abs().max() < 2 ** 24          # exact as f32 too
    terms = (dots.float() * s[None]) * xs[:, None, :]
    y = None
    for r in range(split):
        g0, g1 = ng * r // split, ng * (r + 1) // split
        acc = torch.zeros((t, o), dtype=torch.float32)
        for g in range(g0, g1):
            acc = acc + terms[:, :, g]
        y = acc if y is None else y + acc
    return y


def _case(o, k, gs, t, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.1, (1, o, k)).astype(np.float32)
    qt = qtensor_from_float_np(w, JQuantType.Q8_0, gs)
    x = rng.normal(0, 1, (t, k)).astype(np.float32)
    x[0, :gs] = 0.0                            # an all-zero group
    x[-1, gs:gs + 5] = [127.0, 2.5, -2.5, 0.5, -63.5]   # .5 ties
    return qt, x


@pytest.mark.parametrize("gs,o,k", [(128, 136, 1024), (64, 72, 576),
                                    (32, 40, 256), (256, 64, 1024)])
@pytest.mark.parametrize("split", [1, 3, 8])
def test_emulation_matches_plain_and_jax_kernel(gs, o, k, split):
    """Reference: qmatmul_pallas_stacked, Q8_0, T <= 8, W8A8 on (the
    default), run in interpret mode.  Both sides quantize x bit for bit
    alike and take exact integer dots; they differ in the f32 order of the
    sum over groups: 1e-4 of the output scale, the kernel's tolerance on
    the card."""
    qt, x = _case(o, k, gs, 5)
    q = torch.from_numpy(np.array(qt.q[0]))
    s = torch.from_numpy(np.array(qt.s[0]))
    got = emulate(torch.from_numpy(x), q, s, gs, split)
    plain = q8_gemv_i8_plain(torch.from_numpy(x), q, s, gs)
    scale = plain.abs().max().item()
    assert (got - plain).abs().max().item() <= 1e-4 * scale
    want = np.asarray(qmatmul_pallas_stacked(jnp.asarray(x), qt, 0,
                                             interpret=True))
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("t", range(1, 9))
def test_a_row_is_the_same_bits_whatever_t(t):
    """A row of a T-row call equals the row computed alone, bit for bit:
    the split depends on O and K only, and each column's operations are
    its own."""
    qt, x = _case(200, 1024, 128, 8, seed=3)
    q = torch.from_numpy(np.array(qt.q[0]))
    s = torch.from_numpy(np.array(qt.s[0]))
    xt = torch.from_numpy(x[:t].copy())
    for split in (1, 5):
        whole = emulate(xt, q, s, 128, split)
        rows = torch.cat([emulate(xt[i:i + 1], q, s, 128, split)
                          for i in range(t)])
        assert torch.equal(whole, rows)
