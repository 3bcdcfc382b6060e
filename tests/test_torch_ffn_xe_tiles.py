"""The arithmetic of kernel K (ffn_fused_xe) on the CPU.

The kernel (lmrs_tpu_torch/csrc/ffn_fused.cu, its mma pieces in
csrc/gemv_sm90.cuh) runs both products of the FFN on the tensor cores:
mma.sync m16n8k16 bf16 -> f32, A = 16 weight rows of exact integers read
from a TMA ring (128-byte swizzle), B = bf16 activations with row t in
column t of one n8 tile.  A thread reads one contiguous W-byte piece of
its rows a segment (4W bytes of a row a quad, inside one scale group);
Q4: step 2q + o takes bytes 4q + o and 4q + 2 + o of the piece, low
nibbles as k slots 2t4, 2t4+1, high nibbles (gs/2 elements on) as 2t4+8,
2t4+9; Q8: the same bytes as slots 2t4, 2t4+1 and their partners W/2
bytes on as 2t4+8, 2t4+9; the activations are staged with each aligned 4
values e .. e+3 as the words (e, e+2), (e+1, e+3).  A segment sums
in a fresh fragment, acc = fmaf(s, part, acc) in increasing k order; each
stage splits K over S ranks of whole groups, their sums added in rank
order, the even segments of a rank (one warp) and its odd ones (another)
apart, their sums added even first.  The GLU stage's warp holds gate rows j..j+15 in one tile and up
rows H+j..H+j+15 in the other, and forms g = bf16(act(gate) * up) from
the same accumulator registers.  These tests emulate those steps with
torch and hold, with the fragment placements taken from the PTX ISA's
figures for m16n8k16 (not from the kernel's formulas):

- the k slots: from the runtime Q4 bytes and the int8 rows, A's and B's
  registers name the same element at every k slot, the slots of a
  segment's steps cover each of its elements once, give `unpack_q4`'s
  values (the int8 values), and a segment lies in one scale group;
- the ring and the activations in shared memory: the kernel's swizzled
  address is where TMA's 128-byte swizzle put the byte; at the models'
  group size a quarter warp's 16-byte weight loads (its fragment rows
  permuted within the slice) and a half warp's 8-byte activation loads
  each hit 32 banks, and the staged word a step loads holds the two
  values its B register names;
- the GLU pairing: gate(t, j) and up(t, j) sit in the same accumulator
  register of the same thread in the warp's two tiles;
- the split: each stage's ranks summed in rank order, within tolerance at
  every split, the same bits for a row at every T;
- the emulated output: within 1e-3 of the output scale of
  `ffn_fused_xe_plain` and of the JAX `ffn_fused_xe_stacked`
  (`_ffn_xe_kernel` in interpret mode), Q4 and Q8, silu and tanh-GELU;
- rows independent of T: a row the same bits at T = 1, 5 and 8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.kernels.fused_ffn import ffn_fused_xe_stacked
from lmrs_tpu.kernels.fused_ffn import ffn_split_perm as jax_split_perm
from lmrs_tpu.quant import QuantType as JQuantType
from lmrs_tpu.quant import qtensor_from_float_np

from lmrs_tpu_torch.kernels.ffn_fused import ffn_fused_xe_plain, glu_bf16
from lmrs_tpu_torch.quant import unpack_q4

torch.set_num_threads(1)

GROUP_SIZES = (32, 64, 128, 256)
TOL = 1e-3


# ---- the PTX ISA's fragment layout of mma.sync.aligned.m16n8k16 (.row.col,
# bf16 operands, f32 accumulators); lane = 4 g + t4.  Register r, half h
# (h = 0: the low 16 bits) -> (row, k) of A, (k, column) of B; accumulator
# register r -> (row, column) of C.

def a_frag(lane):
    g, t4 = lane >> 2, lane & 3
    return {(0, 0): (g, 2 * t4), (0, 1): (g, 2 * t4 + 1),
            (1, 0): (g + 8, 2 * t4), (1, 1): (g + 8, 2 * t4 + 1),
            (2, 0): (g, 2 * t4 + 8), (2, 1): (g, 2 * t4 + 9),
            (3, 0): (g + 8, 2 * t4 + 8), (3, 1): (g + 8, 2 * t4 + 9)}


def b_frag(lane):
    g, t4 = lane >> 2, lane & 3
    return {(0, 0): (2 * t4, g), (0, 1): (2 * t4 + 1, g),
            (1, 0): (2 * t4 + 8, g), (1, 1): (2 * t4 + 9, g)}


def c_frag(lane):
    g, t4 = lane >> 2, lane & 3
    return {0: (g, 2 * t4), 1: (g, 2 * t4 + 1), 2: (g + 8, 2 * t4),
            3: (g + 8, 2 * t4 + 1)}


# ---- the kernel's reading order, as its header note states it

def piece_bytes(gs: int, q4: bool) -> int:
    """W: bytes a thread reads a row a segment (a quad's 4W bytes lie in
    one group: Q4 groups are gs/2 bytes, Q8 groups gs)."""
    if q4:
        return 16 if gs % 128 == 0 else 8 if gs % 64 == 0 else 4
    return 16 if gs % 64 == 0 else 8


def steps(gs: int, q4: bool) -> int:
    w = piece_bytes(gs, q4)
    return w // 2 if q4 else w // 4


def a_register(gs, q4, seg_byte, t4, step, reg, half):
    """(byte of the row, which nibble) that A register `reg`, `half` of
    quad position t4 holds at `step` of the segment starting at byte
    seg_byte: registers 0, 1 rows g and g + 8 at the k slots 2t4, 2t4+1;
    2, 3 the same rows at 2t4+8, 2t4+9.  Step 2q + o: bytes 4q + o (the low
    half) and 4q + 2 + o of the piece."""
    w = piece_bytes(gs, q4)
    q, o = step // 2, step % 2
    byte = seg_byte + t4 * w + 4 * q + o + 2 * half
    if q4:
        return byte, "hi" if reg >= 2 else "lo"
    return byte + (w // 2 if reg >= 2 else 0), None


def b_register(gs, q4, seg_byte, t4, step, reg, half):
    """The element of x (g) that B register `reg`, `half` holds."""
    w = piece_bytes(gs, q4)
    q, o = step // 2, step % 2
    byte = seg_byte + t4 * w + 4 * q + o + 2 * half
    if q4:
        gb = gs // 2
        e = (byte // gb) * gs + byte % gb
        return e + (gb if reg == 1 else 0)
    return byte + (w // 2 if reg == 1 else 0)


def staged(e: int):
    """(word, half) of the staged activations that hold value e: each
    aligned 4 values e0 .. e0+3 as the words (e0, e0+2), (e0+1, e0+3)."""
    e0, k = e - e % 4, e % 4
    return e0 // 2 + k % 2, k // 2


def b_words(gs, q4, seg_byte, t4, step):
    """The staged words the kernel loads for B's two registers at `step`:
    word `step` of the run from the piece's first element (x0) and of the
    run gs/2 (Q4) or W/2 (Q8) elements on (x1)."""
    w = piece_bytes(gs, q4)
    e_piece = b_register(gs, q4, seg_byte, t4, 0, 0, 0)
    off = gs // 2 if q4 else w // 2
    return e_piece // 2 + step, (e_piece + off) // 2 + step


def element(gs, q4, byte, nibble):
    """The row element a byte (and nibble) of the runtime layout holds."""
    if not q4:
        return byte
    gb = gs // 2
    return (byte // gb) * gs + byte % gb + (gb if nibble == "hi" else 0)


def segment_slots(gs, q4, seg_byte):
    """[(step, k slot, element of A's row g, element of B's column)] of one
    segment, over the four quad positions and every register half."""
    out = []
    for step in range(steps(gs, q4)):
        for t4 in range(4):
            lane = t4                      # g = 0: rows 0 and 8, column 0
            for (reg, half), (row, k) in a_frag(lane).items():
                if row != 0:
                    continue
                a_e = element(gs, q4, *a_register(gs, q4, seg_byte, t4, step,
                                                  reg, half))
                b = [b_register(gs, q4, seg_byte, t4, step, r, h)
                     for (r, h), (kk, _) in b_frag(lane).items() if kk == k]
                out.append((step, k, a_e, b[0]))
    return out


@pytest.mark.parametrize("q4", [True, False])
@pytest.mark.parametrize("gs", GROUP_SIZES)
def test_k_slots_name_one_element_and_cover_each_once(gs, q4):
    w = piece_bytes(gs, q4)
    gb = gs // 2 if q4 else gs
    assert gb % (4 * w) == 0               # a segment lies in one group
    for seg_byte in range(0, 2 * gb, 4 * w):    # two groups' segments
        slots = segment_slots(gs, q4, seg_byte)
        assert all(a == b for _, _, a, b in slots)     # A and B agree
        for step in range(steps(gs, q4)):
            ks = sorted(k for st, k, _, _ in slots if st == step)
            assert ks == list(range(16))   # every slot filled once a step
        elems = sorted(a for _, _, a, _ in slots)
        assert len(set(elems)) == len(elems)          # each element once
        grp = seg_byte // gb
        assert {e // gs for e in elems} == {grp}      # one scale group
    # the segments of a row cover it
    k = 4 * gs
    covered = sorted(a for sb in range(0, k // (2 if q4 else 1), 4 * w)
                     for _, _, a, _ in segment_slots(gs, q4, sb))
    assert covered == list(range(k))


@pytest.mark.parametrize("gs", GROUP_SIZES)
def test_k_slot_values_are_the_weights(gs):
    """The kernel's nibble decode of the runtime bytes (low: (u & 15) - 8,
    high: ((u >> 4) ^ 8) - 8) at each slot's byte gives unpack_q4's value
    of the slot's element; for Q8 the slot's byte is the element."""
    rng = np.random.default_rng(gs)
    k = 4 * gs
    row = torch.from_numpy(rng.integers(0, 256, k // 2).astype(np.uint8))
    want = unpack_q4(row[None], gs)[0]
    w = piece_bytes(gs, True)
    for seg_byte in range(0, k // 2, 4 * w):
        for step in range(steps(gs, True)):
            for t4 in range(4):
                for (reg, half), (r, _) in a_frag(t4).items():
                    byte, nib = a_register(gs, True, seg_byte, t4, step,
                                           reg, half)
                    u = int(row[byte])
                    v = (u & 15) - 8 if nib == "lo" else ((u >> 4) ^ 8) - 8
                    assert v == int(want[element(gs, True, byte, nib)])


@pytest.mark.parametrize("q4", [True, False])
@pytest.mark.parametrize("gs", GROUP_SIZES)
def test_staged_words_hold_the_b_registers(gs, q4):
    w = piece_bytes(gs, q4)
    gb = gs // 2 if q4 else gs
    for seg_byte in range(0, 2 * gb, 4 * w):
        for t4 in range(4):
            for step in range(steps(gs, q4)):
                words = b_words(gs, q4, seg_byte, t4, step)
                for reg in range(2):
                    for half in range(2):
                        e = b_register(gs, q4, seg_byte, t4, step, reg, half)
                        assert staged(e) == (words[reg], half)


def ring_addr(tile: int, r: int, off: int) -> int:
    """The kernel's ring_addr: byte `off` (< 128) of row r of box `tile`
    of a stage (128-row boxes, 128 bytes a row, 128-byte swizzle)."""
    return tile * 128 * 128 + r * 128 + (
        ((((off >> 4) & 7) ^ (r & 7)) << 4) | (off & 15))


def tma_swizzle_128b(addr: int) -> int:
    """CU_TENSOR_MAP_SWIZZLE_128B as an address map (CUTLASS's Swizzle<3,
    4, 3>) from a 1024-aligned base: bits 4-6 XOR bits 7-9."""
    return addr ^ ((addr >> 3) & 0x70)


def test_ring_reads_find_the_swizzled_bytes():
    for tile in range(2):
        for r in range(128):
            for off in range(128):
                assert ring_addr(tile, r, off) == tma_swizzle_128b(
                    tile * 128 * 128 + r * 128 + off)


def fragment_row(g: int) -> int:
    """The row of a warp's 16-row slice that fragment row g (and g + 8,
    plus 8) takes: lanes g = 2q and 2q + 1 read rows whose swizzles differ
    in bit 2."""
    return ((g & 1) << 2) | (g >> 1)


def test_weight_loads_of_a_quarter_warp_hit_32_banks():
    """W = 16 (the models' group size): the 8 lanes of a quarter warp read
    16 bytes each from 8 different 16-byte bank groups."""
    w = 16
    for warp in range(8):
        for h in range(2):
            for seg in range(128 // (4 * w)):
                for quarter in range(4):
                    groups = set()
                    for lane in range(8 * quarter, 8 * quarter + 8):
                        g, t4 = lane >> 2, lane & 3
                        r = warp * 16 + fragment_row(g) + 8 * h
                        groups.add((ring_addr(0, r, seg * 4 * w + t4 * w)
                                    % 128) // 16)
                    assert len(groups) == 8
    assert sorted(fragment_row(g) for g in range(8)) == list(range(8))


def x_stride(gmax: int, gs: int) -> int:
    """The kernel's row stride of the staged activations, in 32-bit words:
    the rank's gmax * gs values rounded up to 32 words, plus 2."""
    return (gmax * gs // 2 + 31) // 32 * 32 + 2


@pytest.mark.parametrize("q4", [True, False])
@pytest.mark.parametrize("gmax", [7, 14, 28])
def test_activation_loads_of_a_half_warp_hit_32_banks(q4, gmax):
    """At the models' group size (128: W = 16) each 8-byte load of B (two
    steps' words of one run) of a half warp touches 16 different pairs of
    banks, all 32 banks."""
    gs = 128
    stride = x_stride(gmax, gs)
    w = piece_bytes(gs, q4)
    for seg_byte in range(0, 128, 4 * w):
        for step in range(0, steps(gs, q4), 2):
            for reg in range(2):
                for first in (0, 16):
                    pairs = []
                    for lane in range(first, first + 16):
                        g, t4 = lane >> 2, lane & 3
                        word = g * stride + b_words(gs, q4, seg_byte, t4,
                                                    step)[reg]
                        assert word % 2 == 0            # 8-byte aligned
                        pairs.append((word // 2) % 16)
                    assert sorted(pairs) == list(range(16))


def kernel_epilogue(lane: int, reg: int):
    """(row of the warp's 16, column) the kernel's epilogue assigns to
    accumulator register acc[tile][reg] = acc[tile][2h + cc]: row g + 8h,
    column 2t4 + cc."""
    g, t4 = lane >> 2, lane & 3
    return g + 8 * (reg >> 1), 2 * t4 + (reg & 1)


def test_glu_pairs_gate_and_up_in_one_register():
    """The GLU stage: tile 0 of warp w holds W13 rows j0 + 16w + i (gate),
    tile 1 rows H + j0 + 16w + i (up).  The m16n8k16 products of the two
    tiles against one B, read through the PTX accumulator layout, put
    gate(t, j) and up(t, j) in the same register of the same thread, and
    that register is the one the kernel's epilogue reads for (t, j)."""
    h, j0, d = 48, 16, 16
    rng = np.random.default_rng(0)
    w13 = rng.integers(-8, 8, (2 * h, d)).astype(np.float64)
    x = rng.normal(0, 1, (8, d))
    gate_up = w13 @ x.T                          # (2H, T)
    for warp in range(2):
        tiles = [w13[tile * h + j0 + 16 * warp:][:16] for tile in range(2)]
        c = [tile @ x.T for tile in tiles]       # each (16, 8): C of a tile
        for lane in range(32):
            for reg, (i, col) in c_frag(lane).items():
                j = j0 + 16 * warp + i
                assert c[0][i, col] == gate_up[j, col]
                assert c[1][i, col] == gate_up[h + j, col]
                assert kernel_epilogue(lane, reg) == (i, col)


# ---- the emulation

def values(q: torch.Tensor, gs: int) -> torch.Tensor:
    return (unpack_q4(q, gs) if q.dtype == torch.uint8 else q).double()


def segments(k: int, gs: int, q4: bool):
    """(group, element indices) of each segment of a row, in k order."""
    w = piece_bytes(gs, q4)
    gb = gs // 2 if q4 else gs
    out = []
    for grp in range(k // gs):
        for b0 in range(0, gb, 4 * w):
            idx = np.arange(b0, b0 + 4 * w)
            if q4:
                idx = np.concatenate([idx, idx + gb])
            out.append((grp, grp * gs + idx))
    return out


def f32_fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def emulate_stage(a: torch.Tensor, q, s, gs: int, split: int):
    """One stage: a (T, K) bf16 values, weights q (O, K/2 | K), scales s
    (O, K/gs) -> (T, O) f32.  A segment's exact dot rounded to f32, then
    acc = fmaf(s, part, acc) over a rank's even segments in order and,
    apart, over its odd ones (two warps), the two sums added even first,
    the ranks' sums added in rank order; every column takes the same
    operations whatever T is."""
    q4 = q.dtype == torch.uint8
    wv = values(q, gs)
    t, k = a.shape
    ng = k // gs
    segs = segments(k, gs, q4)
    perm = np.concatenate([idx for _, idx in segs])
    n = len(segs)
    w3 = wv[:, perm].reshape(wv.shape[0], n, -1)
    a3 = a.double()[:, perm].reshape(t, n, -1)
    # each row of a on its own: its sums never depend on the other rows
    parts = torch.stack([torch.einsum("se,ose->os", a3[i], w3)
                         for i in range(t)]).float()
    y = None
    for r in range(split):
        g0, g1 = ng * r // split, ng * (r + 1) // split
        mine = [(i, grp) for i, (grp, _) in enumerate(segs)
                if g0 <= grp < g1]
        halves = []
        for h in range(2):
            acc = torch.zeros((t, wv.shape[0]), dtype=torch.float32)
            for i, grp in mine[h::2]:
                acc = f32_fma(s[:, grp][None], parts[:, :, i], acc)
            halves.append(acc)
        acc = halves[0] + halves[1]
        y = acc if y is None else y + acc
    return y


def emulate(x, w13q, w13s, w2q, w2s, gs, act, split13=1, split2=1):
    xb = x.to(torch.bfloat16).float()
    h = w13q.shape[0] // 2
    gu = emulate_stage(xb, w13q, w13s, gs, split13)
    g = glu_bf16(gu[:, :h], gu[:, h:], act).float()
    return emulate_stage(g, w2q, w2s, gs, split2)


def _case(quant, t, d, h, gs, seed):
    """x (T, D), the port's weights (logical row order) and the JAX
    QTensors (Q4 w13 rows in the loader's ffn_split_perm order)."""
    rng = np.random.default_rng(seed)
    w13 = rng.normal(0, 0.1, (2 * h, d)).astype(np.float32)
    w2 = rng.normal(0, 0.1, (d, h)).astype(np.float32)
    x = rng.normal(0, 1, (t, d)).astype(np.float32)
    jq = JQuantType.Q4_0 if quant == "q4" else JQuantType.Q8_0
    port = [qtensor_from_float_np(w, jq, gs) for w in (w13, w2)]
    port = [v for qt in port for v in (torch.from_numpy(np.array(qt.q)),
                                       torch.from_numpy(np.array(qt.s)))]
    perm = np.arange(2 * h)
    if quant == "q4":
        p = jax_split_perm(h, gs)
        perm = np.concatenate([p, h + p])
    jax_w = (qtensor_from_float_np(w13[perm][None], jq, gs),
             qtensor_from_float_np(w2[None], jq, gs))
    return torch.from_numpy(x), port, jax_w


SHAPES = [(256, 512, 32), (512, 1536, 64), (384, 1024, 128)]


@pytest.mark.parametrize("quant", ["q4", "q8"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("d,h,gs", SHAPES[:2])
def test_emulation_matches_plain_and_jax_kernel(quant, act, d, h, gs):
    """Reference: ffn_fused_xe_stacked -> _ffn_xe_kernel (fused_ffn.py:526)
    in interpret mode.  1e-3 of the output scale: the same bf16 operands
    and exact products, f32 sums in another order, and a last-bit
    difference of gate or up may flip a g value's bf16 rounding."""
    x, port, (j13, j2) = _case(quant, 5, d, h, gs, seed=d + len(act))
    got = emulate(x, *port, gs, act, split13=2, split2=4)
    plain = ffn_fused_xe_plain(x, *port, gs, act)
    assert (got - plain).abs().max() <= TOL * plain.abs().max()
    want = np.asarray(ffn_fused_xe_stacked(jnp.asarray(x.numpy()), j13, j2,
                                           0, act=act, interpret=True))
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("quant", ["q4", "q8"])
@pytest.mark.parametrize("d,h,gs", SHAPES)
def test_every_split_sums_in_rank_order_within_tolerance(quant, d, h, gs):
    """Each stage's K split (the down stage's along H) at every cluster
    size the kernel may pick: the ranks' sums in rank order stay within
    the tolerance of the plain version."""
    x, port, _ = _case(quant, 3, d, h, gs, seed=gs)
    plain = ffn_fused_xe_plain(x, *port, gs, "silu")
    for split in (1, 2, 3, 4, 6, 8):
        if split > min(d, h) // gs:
            continue
        got = emulate(x, *port, gs, "silu", split13=split, split2=split)
        assert (got - plain).abs().max() <= TOL * plain.abs().max(), split


@pytest.mark.parametrize("quant", ["q4", "q8"])
@pytest.mark.parametrize("split", [1, 3, 8])
def test_a_row_is_the_same_bits_at_t_1_5_8(quant, split):
    """A row of a T-row call equals the row computed alone, bit for bit, at
    a fixed split (the kernel's split depends on the rows and K only)."""
    d, h, gs = SHAPES[2]
    x, port, _ = _case(quant, 8, d, h, gs, seed=split)
    full = emulate(x, *port, gs, "gelu", split13=split, split2=split)
    for t in (1, 5, 8):
        part = emulate(x[:t], *port, gs, "gelu", split13=split,
                       split2=split)
        assert torch.equal(part, full[:t]), t
    for i in range(8):
        alone = emulate(x[i:i + 1], *port, gs, "gelu", split13=split,
                        split2=split)
        assert torch.equal(alone, full[i:i + 1]), i
