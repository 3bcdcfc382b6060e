"""The arithmetic of kernels B (q4_gemm) and F (q8_gemm) on the CPU.

The kernels (lmrs_tpu_torch/csrc/qgemm_sm90.cuh) dequantize in packed bf16
form: a magic-constant int -> bf16 conversion, one exact bf16 subtraction
and one round-to-nearest-even bf16 multiply by bf16(s).  These tests
emulate exactly those steps with torch bit operations and hold them, bit
for bit, against `dequant_bf16` of kernels/q4_gemm.py and q8_gemm.py (the
rounding of the JAX kernels) for every Q4 byte (both nibbles, XOR-0x80
biased) and every int8 value in [-127, 127], times 10^4 scales and more
across and beyond the synthetic writer's range.

They also hold the order in which the kernels walk K (the Q4 group-half
pairing issues a k16 step of a group's first half and the step gs/2 further
on back to back) and the scale column each step reads: the order covers
every element once, each step lies in one scale group, and the product of
both operands permuted into that order equals the plain version to 1e-5 of
the output scale in f32 (a reordering of the sum, nothing else).
"""

import numpy as np
import pytest
import torch

from lmrs_tpu_torch.kernels.q4_gemm import dequant_bf16 as dequant_q4
from lmrs_tpu_torch.kernels.q4_gemm import q4_gemm_plain
from lmrs_tpu_torch.kernels.q8_gemm import dequant_bf16 as dequant_q8
from lmrs_tpu_torch.kernels.q8_gemm import q8_gemm_plain

torch.set_num_threads(1)

BF16_128 = 0x4300          # bf16 bits of 128.0
BF16_136 = 0x4308          # bf16 bits of 136.0


def _scales():
    """f32 scales: the synthetic writer's magnitudes (Q4 ~ 0.0013-0.004
    negative, Q8 ~ 0.00008-0.00024), a log sweep from 1e-8 to 1e3 of both
    signs, and ones that sit on bf16 rounding ties."""
    rng = np.random.default_rng(0)
    writer = np.concatenate([
        -(0.02 / 7.5) * (0.5 + rng.random(3000)),
        (0.02 / 127.0) * (0.5 + rng.random(3000))])
    sweep = np.logspace(-8, 3, 3000)
    sweep = np.concatenate([sweep, -sweep])
    # f32 values halfway between two bf16 values (bit 15 set, lower zero)
    ties = rng.integers(0x3000, 0x4400, 1000).astype(np.uint32) << 16
    ties = (ties | 0x8000).view(np.float32)
    s = np.concatenate([writer, sweep, ties, -ties, [1.0, -1.0, 0.5]])
    return torch.from_numpy(s.astype(np.float32))


def _bf16(bits: torch.Tensor) -> torch.Tensor:
    """int32 tensor of 16-bit patterns -> bf16 tensor of those bits."""
    return bits.to(torch.int16).view(torch.bfloat16)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int16)


def _scale_bf16(s: torch.Tensor) -> torch.Tensor:
    """__float2bfloat16_rn: one RNE rounding of the f32 scale."""
    return s.to(torch.bfloat16)


def packed_q4(r: torch.Tensor, s: torch.Tensor):
    """The kernel's dq4_lo / dq4_hi on raw runtime-layout bytes r (int32
    0..255) with f32 scales s broadcast against them: the low nibble into
    the mantissa of 128 (0x4300 | n), the high nibble's biased top bit
    flipped ((n_hi & 0xF) ^ 0x4308), one exact bf16 subtraction of 136, one
    bf16 multiply."""
    sb = _scale_bf16(s)
    lo = _bf16((r & 0xF) | BF16_128)
    hi = _bf16(((r >> 4) & 0xF) ^ BF16_136)
    c136 = _bf16(torch.tensor(BF16_136))
    return (lo - c136) * sb, (hi - c136) * sb


def packed_q8(v: torch.Tensor, s: torch.Tensor):
    """The kernel's dq8 on int8 values v (int32): X = 0x4300 | (v & 0x7f),
    C = 0x4300 | (v & 0x80) (128 or 256), one exact bf16 subtraction X - C
    = v, one bf16 multiply."""
    u = v & 0xFF
    x = _bf16((u & 0x7F) | BF16_128)
    c = _bf16((u & 0x80) | BF16_128)
    return (x - c) * _scale_bf16(s)


def test_magic_constants_are_exact():
    """The intermediate values: 128 + n for every nibble, v for every
    int8 value, before any scale."""
    n = torch.arange(16, dtype=torch.int32)
    assert torch.equal(_bf16(n | BF16_128).float(), 128.0 + n.float())
    r = torch.arange(256, dtype=torch.int32)
    c136 = _bf16(torch.tensor(BF16_136))
    lo = (_bf16((r & 0xF) | BF16_128) - c136).float()
    hi = (_bf16(((r >> 4) & 0xF) ^ BF16_136) - c136).float()
    b = r ^ 0x80                                    # the runtime bias
    assert torch.equal(lo, ((b & 0xF) - 8).float())
    assert torch.equal(hi, ((b >> 4) - 8).float())
    v = torch.arange(-127, 128, dtype=torch.int32)
    u = v & 0xFF
    x = _bf16((u & 0x7F) | BF16_128)
    c = _bf16((u & 0x80) | BF16_128)
    assert torch.equal((x - c).float(), v.float())


def test_q4_packed_dequant_bit_exact():
    """Every byte, both nibbles, times every scale: the bits of
    q4_gemm.dequant_bf16."""
    s = _scales()
    o = s.numel()
    assert o >= 10_000
    gs = 512                          # one group: byte j -> j and j + 256
    q = torch.arange(256, dtype=torch.int32).repeat(o, 1)
    want = dequant_q4(q.to(torch.uint8), s[:, None], gs)
    lo, hi = packed_q4(q, s[:, None])
    assert torch.equal(_bits(lo), _bits(want[:, :256]))
    assert torch.equal(_bits(hi), _bits(want[:, 256:]))


def test_q8_packed_dequant_bit_exact():
    """Every int8 value in [-127, 127] times every scale: the bits of
    q8_gemm.dequant_bf16."""
    s = _scales()
    o = s.numel()
    v = torch.arange(-127, 128, dtype=torch.int32).repeat(o, 1)
    want = dequant_q8(v.to(torch.int8), s[:, None], 255)
    got = packed_q8(v, s[:, None])
    assert torch.equal(_bits(got), _bits(want))


# ---- the order of K and the scale columns (qgemm_sm90.cuh: step_elem,
# the producer's g0 window, the consumers' gcol/gi)

def kernel_steps(k: int, gs: int, quant: str, scale_tma: bool):
    """(first K element, scale group) of each k16 step, in the order the
    kernel issues them; scale groups as the kernel indexes its staged
    [row][4] scale window."""
    bk = 128 if quant == "q4" else 64
    half = gs // 2
    out = []
    for c in range(k // bk):
        g0 = c * bk // gs
        base = g0 & ~3 if scale_tma else g0
        lead = c * bk % gs
        gcol = (g0 & 3) if scale_tma else 0
        for p in range(4):
            e = 16 * p + ((16 * p) & ~(half - 1)) if quant == "q4" else 16 * p
            at = lead + e
            gi = gcol + (at >= gs) + (at >= 2 * gs) + (at >= 3 * gs)
            assert 0 <= gi < 4
            ks = [e, e + half] if quant == "q4" else [e]
            out += [(c * bk + kk, base + gi) for kk in ks]
    return out


@pytest.mark.parametrize("quant,gs", [("q4", 32), ("q4", 64), ("q4", 128),
                                      ("q8", 16), ("q8", 32), ("q8", 64),
                                      ("q8", 128), ("q8", 256)])
@pytest.mark.parametrize("scale_tma", [True, False])
def test_kernel_k_order_covers_k(quant, gs, scale_tma):
    """Every element of K once, each k16 step inside one scale group, and
    that group the one the kernel's scale column points at."""
    k = 1024
    steps = kernel_steps(k, gs, quant, scale_tma)
    elems = np.concatenate([np.arange(k0, k0 + 16) for k0, _ in steps])
    assert np.array_equal(np.sort(elems), np.arange(k))
    for k0, g in steps:
        assert k0 // gs == (k0 + 15) // gs == g


@pytest.mark.parametrize("quant,o,k,gs", [("q4", 136, 512, 64),
                                          ("q4", 64, 768, 128),
                                          ("q4", 40, 256, 32),
                                          ("q8", 136, 640, 64),
                                          ("q8", 64, 768, 128),
                                          ("q8", 40, 256, 32)])
def test_kernel_k_order_product(quant, o, k, gs):
    """Both operands permuted into the kernel's K order, and the product
    summed step by step in f32: the plain version's product to 1e-5 of the
    output scale."""
    rng = np.random.default_rng(1)
    t = 24
    x = torch.from_numpy(rng.standard_normal((t, k)).astype(np.float32))
    s = torch.from_numpy((rng.random((o, k // gs)) * 0.01 + 0.001)
                         .astype(np.float32))
    if quant == "q4":
        q = torch.from_numpy(rng.integers(0, 256, (o, k // 2))
                             .astype(np.uint8))
        wd = dequant_q4(q, s, gs).float()
        want = q4_gemm_plain(x, q, s, gs)
    else:
        q = torch.from_numpy(rng.integers(-127, 128, (o, k)).astype(np.int8))
        wd = dequant_q8(q, s, gs).float()
        want = q8_gemm_plain(x, q, s, gs)
    order = torch.from_numpy(np.concatenate(
        [np.arange(k0, k0 + 16)
         for k0, _ in kernel_steps(k, gs, quant, True)]))
    xp = x.to(torch.bfloat16).float()[:, order]
    wp = wd[:, order]
    got = torch.zeros(t, o)
    for i in range(0, k, 16):           # one k16 step after another
        got += xp[:, i:i + 16] @ wp[:, i:i + 16].t()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
