"""The arithmetic of kernel A (q4_gemv) on the CPU.

The kernel (lmrs_tpu_torch/csrc/q4_gemv.cu) runs the Q4 GEMV on the tensor
cores: the A operand is the integer weight w = n - 8, exact in bf16; the B
operand is x split into three bf16 slices, x0 = bf16(x), x1 = bf16(x - x0),
x2 = bf16(x - x0 - x1), whose sum is x exactly, each slice of each row of
x a column of the n8 tiles (column 3t + i holds slice i of row t, so T <= 2
takes one tile, T <= 5 two, T <= 8 three); each segment's products are
summed in a fresh f32 fragment, then acc = fmaf(s, part, acc) for each
column, and y = (acc_0 + acc_1) + acc_2.  These tests emulate those steps
with torch and hold:

- the split: the three slices sum to x bit for bit over random, large,
  tiny and bf16-tie values (+-0: the first slice is x, the others zeros),
  the third slice needs no rounding, and
  below 2^-110 (where the residues reach bf16's subnormals) the sum is off
  by less than 2^-133;
- the kernel's order of K: the k slots of each m16n8k16 step, read from
  the runtime Q4 bytes as the kernel reads them, cover every element of a
  row once, give `unpack_q4`'s values, and a step (and a segment) lies in
  one scale group, for every group size the kernel takes;
- the columns: row t's three columns and their n8 tiles are the same
  whatever T is, and the tiles a call takes hold every row's columns;
- the emulated sum: within 1e-4 of the output scale of `q4_gemv_plain`
  (the kernel's tolerance on the card), and the same bits for a row
  whatever T is (every (t, o) takes the same operations in the same
  order; the emulation sums each product in a fixed order, as the kernel's
  fragment does for each column).
"""

import numpy as np
import pytest
import torch

from lmrs_tpu_torch.kernels.q4_gemv import q4_gemv_plain
from lmrs_tpu_torch.quant import unpack_q4

torch.set_num_threads(1)


def split3(x: torch.Tensor):
    """The kernel's split3: round to nearest even at each step, the
    subtractions exact in f32."""
    x0 = x.to(torch.bfloat16).float()
    r = x - x0
    x1 = r.to(torch.bfloat16).float()
    r2 = r - x1
    return x0, x1, r2.to(torch.bfloat16).float(), r2


def _values():
    rng = np.random.default_rng(0)
    normal = rng.normal(0, 1, 20000)
    scaled = normal * np.logspace(-30, 30, 20000)
    scaled = scaled[np.abs(scaled) >= 2.0 ** -110]
    large = np.array([1e30, -3e38, 3.38e38, 65504.0, 1e10 + 1.0])
    tiny = np.array([1e-30, -2.0 ** -110, 2.0 ** -100 * 1.2345678])
    # f32 values halfway between two bf16 values, and the next ones up
    ties = rng.integers(0x2000, 0x7000, 2000).astype(np.uint32) << 16
    ties = (ties | 0x8000).view(np.float32)
    near = (ties.view(np.uint32) + 1).view(np.float32)
    v = np.concatenate([normal, scaled, large, tiny, ties, -ties, near,
                        [0.0, -0.0, 1.0, -1.0]])
    return torch.from_numpy(v.astype(np.float32))


def test_three_slices_sum_to_x_bit_for_bit():
    x = _values()
    x0, x1, x2, r2 = split3(x)
    assert torch.isfinite(x0).all()
    # the third slice needs no rounding: r2 has at most 8 significant bits
    assert torch.equal(x2, r2)
    # the exact sum of the slices is x (f64 holds it exactly), and so is
    # their f32 sum, bit for bit
    assert torch.equal(x0.double() + x1.double() + x2.double(), x.double())
    nz = x != 0
    back = (x0 + x1) + x2
    assert torch.equal(back[nz].view(torch.int32), x[nz].view(torch.int32))


def test_slices_of_signed_zero_and_ties():
    """-0 keeps its sign in the first slice (x - x0 is +0, so the residues
    are +0: the products are zeros of either sign, no sum moves)."""
    x = torch.tensor([0.0, -0.0], dtype=torch.float32)
    x0, x1, x2, _ = split3(x)
    assert torch.equal(x0.view(torch.int32), x.view(torch.int32))
    assert (x1 == 0).all() and (x2 == 0).all()
    # a tie rounds to the even bf16 value; the residue carries the half ulp
    tie = torch.tensor([1.0 + 2.0 ** -8], dtype=torch.float32)
    t0, t1, t2, _ = split3(tie)
    assert t0.item() == 1.0 and t1.item() == 2.0 ** -8 and t2.item() == 0.0


def test_subnormal_edge_is_bounded():
    """Below 2^-110 the residues fall into bf16's subnormal range (steps of
    2^-133): the slices then sum to x within 2^-133."""
    rng = np.random.default_rng(1)
    mags = 2.0 ** rng.uniform(-149, -110, 5000)
    x = torch.from_numpy((mags * rng.choice([-1, 1], 5000)).astype(
        np.float32))
    x0, x1, x2, _ = split3(x)
    err = (((x0 + x1) + x2).double() - x.double()).abs()
    assert err.max().item() < 2.0 ** -133


def kernel_w(gs: int) -> int:
    """Bytes a thread reads of a row per segment (the kernel's W)."""
    half = gs // 2
    return 16 if half % 64 == 0 else 8 if half % 32 == 0 else 4


def kernel_steps(k: int, gs: int):
    """(segment, the 16 k slots' elements, byte of each slot's nibble and
    whether it is the high nibble) for every k16 step of a row, in the
    kernel's order."""
    w = kernel_w(gs)
    half = gs // 2
    steps = []
    for seg in range(k // 2 // (4 * w)):
        for s in range(w // 2):
            elems, nib = [0] * 16, [None] * 16
            for t4 in range(4):
                b = seg * 4 * w + t4 * w + 2 * s
                grp = b // half
                e_lo = grp * gs + (b - grp * half)
                for j in range(2):
                    elems[2 * t4 + j] = e_lo + j
                    nib[2 * t4 + j] = (b + j, False)
                    elems[2 * t4 + 8 + j] = e_lo + half + j
                    nib[2 * t4 + 8 + j] = (b + j, True)
            steps.append((seg, elems, nib))
    return steps


@pytest.mark.parametrize("k,gs", [(256, 32), (640, 64), (3584, 128),
                                  (14336, 128), (288, 96), (1024, 256),
                                  (480, 160)])
def test_kernel_k_order_covers_k_in_groups(k, gs):
    half = gs // 2
    w = kernel_w(gs)
    assert half % (4 * w) == 0            # a segment lies in a half-group
    steps = kernel_steps(k, gs)
    seen = sorted(e for _, elems, _ in steps for e in elems)
    assert seen == list(range(k))
    for seg, elems, _ in steps:
        groups = {e // gs for e in elems}
        assert groups == {seg * 4 * w // half}


@pytest.mark.parametrize("k,gs", [(256, 32), (640, 64), (1024, 128),
                                  (288, 96)])
def test_kernel_reads_the_runtime_bytes_as_unpack_q4(k, gs):
    """Each slot's nibble, decoded as the kernel decodes it (low: (u & 15)
    - 8; high: ((u >> 4) ^ 8) - 8, the byte XOR-0x80 biased), is
    `unpack_q4`'s value of the slot's element."""
    gen = torch.Generator().manual_seed(k + gs)
    o = 5
    q = torch.randint(0, 256, (o, k // 2), dtype=torch.uint8, generator=gen)
    want = unpack_q4(q, gs).to(torch.int32)
    u = q.to(torch.int32)
    lo, hi = (u & 15) - 8, ((u >> 4) ^ 8) - 8
    got = torch.empty_like(want)
    for _, elems, nib in kernel_steps(k, gs):
        for e, (b, high) in zip(elems, nib):
            got[:, e] = (hi if high else lo)[:, b]
    assert torch.equal(got, want)


SLICES = 3


def n8_tiles(t: int) -> int:
    """The kernel's n8 tiles of B for a T-row call: the 3T columns."""
    return (SLICES * t + 7) // 8


def columns(t: int):
    """(tile, column in the tile) of each slice of row t of x."""
    return [divmod(SLICES * t + i, 8) for i in range(SLICES)]


def emulate(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
            gs: int) -> torch.Tensor:
    """The kernel's sums for each (t, o): per step, the 16 exact products
    of a slice added into its column's fragment of the segment in a fixed
    order; the fragment times the segment's scale added to the column's sum
    with one rounding (fma, emulated in f64); the row's three columns added
    as (slice 0 + slice 1) + slice 2."""
    t, k = x.shape
    w_int = unpack_q4(q, gs).float()                 # exact
    slices = split3(x)[:3]
    half = gs // 2
    w_bytes = kernel_w(gs)
    acc = [torch.zeros(t, q.shape[0], dtype=torch.float32) for _ in slices]
    part, cur = None, None
    for seg, elems, _ in kernel_steps(k, gs):
        if seg != cur:
            if part is not None:
                acc = [fma(s[:, cur * 4 * w_bytes // half], p, a)
                       for p, a in zip(part, acc)]
            part, cur = [torch.zeros_like(acc[0]) for _ in slices], seg
        idx = torch.tensor(elems)
        wv = w_int[:, idx]                             # (O, 16)
        for i, sl in enumerate(slices):
            xv = sl[:, idx]                            # (T, 16)
            for j in range(16):
                part[i] = part[i] + xv[:, j:j + 1] * wv[:, j]
    acc = [fma(s[:, cur * 4 * w_bytes // half], p, a)
           for p, a in zip(part, acc)]
    return (acc[0] + acc[1]) + acc[2]


@pytest.mark.parametrize("t", range(1, 9))
def test_columns_of_a_row_do_not_move_with_t(t):
    """Row r's columns (3r, 3r + 1, 3r + 2) and their tiles are the same in
    a call of any T > r, and the call's n8 tiles hold them all: 1 tile for
    T <= 2, 2 for T <= 5, 3 for T <= 8."""
    nt = n8_tiles(t)
    assert nt == (1 if t <= 2 else 2 if t <= 5 else 3)
    seen = set()
    for r in range(t):
        cols = columns(r)
        assert all(tile < nt for tile, _ in cols)
        assert [8 * a + b for a, b in cols] == [3 * r, 3 * r + 1, 3 * r + 2]
        seen.update(cols)
    assert len(seen) == SLICES * t


def fma(scale, part, acc):
    return (scale.double()[None] * part.double() + acc.double()).float()


@pytest.mark.parametrize("o,k,gs", [(24, 256, 32), (17, 640, 64),
                                    (16, 1024, 128), (9, 288, 96)])
def test_emulated_sum_matches_plain_and_is_row_independent(o, k, gs):
    rng = np.random.default_rng(o * k)
    x = torch.from_numpy(rng.normal(0, 1, (8, k)).astype(np.float32))
    x[3] *= 1e-3
    x[6, : k // 4] = 0.0
    q = torch.from_numpy(rng.integers(0, 256, (o, k // 2), dtype=np.uint8))
    s = torch.from_numpy((-0.003 * (0.5 + rng.random((o, k // gs))))
                         .astype(np.float32))
    got = emulate(x, q, s, gs)
    want = q4_gemv_plain(x, q, s, gs)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    for t in (5, 8):
        whole = emulate(x[:t], q, s, gs)
        rows = torch.cat([emulate(x[i:i + 1], q, s, gs) for i in range(t)])
        assert torch.equal(whole, rows)
