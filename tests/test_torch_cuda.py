"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips without a CUDA device (the decision is taken
in a fixture, never at import).  On the card:
    python -m pytest tests/test_torch_cuda.py -m gpu
This file imports no JAX: the machine with the card has none.

Tolerances: A 1e-4 of the output scale (f32 both sides, sums over K in
another order); B 1e-3 of the output scale (the same bf16 operands,
tensor-core f32 accumulation in another order over K up to 14336);
C per element, `flash_attention_tol`: (2^-7 + 2^-9) times the plain
version run on |v| (each side rounds its softmax weights to bf16 once, the
kernel the unnormalized ones, the plain version the normalized ones, so
the weights differ by at most 2^-7 of themselves; 2^-9 covers the float32
sums in another order); D's quantizer pre-pass bit for bit; D and E 1e-4
of the output scale (D's integer dots are exact, so both differ from their
plain versions only in the f32 order of the sums); F 1e-3 as B; G per
element, `flash_attention_i8_tol` (C's bound with the softmax weight times
the value scale in the weight's place); H per element,
`flash_attention_i4_tol` (G's bound on the unpacked nibble values); C on an
f32 cache as C, and bit for bit the bf16 cache's result; the int4 row
quantizer bit for bit card vs CPU; whole-model logits 1e-2 of the
logit scale (the per-kernel differences compound over layers);
speculative greedy tokens equal to plain greedy tokens up to the first
step whose top-2 logit margin is below 1e-3 of the logit scale (the reason
stands at the test).  I and J (per-slot and paged flash) per element within
their plain versions' bound, as C's; slot b of an I or J call bit for bit
C's, G's or H's result on the slot's rows (the same walk), J bit for bit
I on a pool holding I's rows, and a slot's result bit for bit unchanged
when every other slot, page and the trash page hold NaN.  K and L (the
fused FFN) 1e-3 of the output scale (the same bf16 operands and exact
products, f32 sums in another order; a last-bit difference of the f32
gate or up flips a g value's bf16 rounding by one step, 2^-8 of it, and
moves the outputs by ~2e-4 of their scale at most), and a row of a K call
bit for bit the row computed alone.  Flash-decoding (the split pass and
kernel M): C, G, H, I and J at positions on and next to split boundaries
and the window's edge within their plain versions' bounds, and a row of a
T = 5 call bit for bit the row alone; C, G and H with a device position
and host bounds bit for bit the host-position call; M within `flash_merge_tol` of its
plain version (the same f32 weights and sums in another order); the cp
partials (B1) of each of four sequence shards within the plain raw acc's
bound (`flash_attention_batched_tol(..., return_lse=True)`), m within
1e-5 and l within 1e-4 relative of the plain version's (f32 scores in
another order), m == _MASK_NEG exactly where a shard holds no live key,
and the shards merged by M within I's bound of I's result and of the plain
version (two levels of merge round differently: not bit for bit).  The
offline path: a tiny model's NLL per token (`scripts/torch_perplexity.py`)
on the card within `chip_smoke.CUT_TOL` of the CPU's plain versions (the
attention's softmax-weight rounding, C's bound above, sets most of it),
and the native tokenizer's ids equal to the Python merge loop's.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lmrs_tpu_torch.kernels import launches, reset_launches
from lmrs_tpu_torch.kernels.ffn_fused import (ffn_fused, ffn_fused_plain,
                                              ffn_fused_xe,
                                              ffn_fused_xe_plain)
from lmrs_tpu_torch.kernels.flash_attention import (flash_attention,
                                                    flash_attention_plain,
                                                    flash_attention_tol)
from lmrs_tpu_torch.kernels.q4_gemm import dequant_bf16 as q4_dequant
from lmrs_tpu_torch.kernels.q4_gemm import q4_gemm, q4_gemm_plain
from lmrs_tpu_torch.kernels.flash_attention_i4 import (
    flash_attention_i4, flash_attention_i4_plain, flash_attention_i4_tol)
from lmrs_tpu_torch.kernels.flash_attention_batched import (
    flash_attention_batched, flash_attention_batched_plain,
    flash_attention_batched_tol)
from lmrs_tpu_torch.kernels.flash_attention_i8 import (
    flash_attention_i8, flash_attention_i8_plain, flash_attention_i8_tol)
from lmrs_tpu_torch.kernels.flash_attention_paged import (
    flash_attention_paged, flash_attention_paged_plain,
    flash_attention_paged_tol)
from lmrs_tpu_torch.kernels.flash_merge import (SPLIT, flash_merge,
                                                flash_merge_plain,
                                                flash_merge_tol)
from lmrs_tpu_torch.kernels.q4_gemv import q4_gemv, q4_gemv_plain
from lmrs_tpu_torch.kernels.q8_gemm import dequant_bf16 as q8_dequant
from lmrs_tpu_torch.kernels.q8_gemm import q8_gemm, q8_gemm_plain
from lmrs_tpu_torch.kernels.q8_gemv import q8_gemv, q8_gemv_plain
from lmrs_tpu_torch.kernels.q8_gemv_i8 import (q8_act_quant, q8_gemv_i8,
                                               q8_gemv_i8_plain)
from lmrs_tpu_torch.quant import (q4_cache_pair_mode, q4_file_to_runtime_np,
                                  quantize_kv_rows, quantize_kv_rows_q4,
                                  quantize_q8_act, quantize_q40_np,
                                  quantize_q80_np, unpack_kv_q4)
from torch_batched_cases import make_case, spoil

# the module (the package exports kernel M's wrapper under its name)
fm = importlib.import_module("lmrs_tpu_torch.kernels.flash_merge")


def _weights(o, k, device, gs=128):
    w = np.random.default_rng(0).normal(0, 0.1, (o, k)).astype(np.float32)
    packed, s, _ = quantize_q40_np(w, gs)
    q = q4_file_to_runtime_np(packed.reshape(o, k // 2), gs)
    return (torch.from_numpy(q).to(device),
            torch.from_numpy(s.reshape(o, k // gs)).to(device))


def _q8_weights(o, k, device, gs=128):
    w = np.random.default_rng(0).normal(0, 0.1, (o, k)).astype(np.float32)
    q, s, _ = quantize_q80_np(w, gs)
    return (torch.from_numpy(q.reshape(o, k)).to(device),
            torch.from_numpy(s.reshape(o, k // gs)).to(device))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _rel_err(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("o,k,gs", [(1024, 3584, 128), (1000, 256, 32),
                                    (136, 512, 64)])
def test_gemv_kernel_on_card(cuda_device, t, o, k, gs):
    q, s = _weights(o, k, cuda_device, gs)
    x = torch.randn(t, k, device=cuda_device)
    reset_launches()
    got = q4_gemv(x, q, s, gs)
    assert launches()["q4_gemv"] == 1
    want = q4_gemv_plain(x, q, s, gs)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-4


# (O, K) of the five matmuls of Gemma-2-9B, Llama-3.2-3B and Phi-3.5-mini
# (wqkv, wo, w13, w2, classifier), and odd row counts
GEMV_MODEL_SHAPES = [(8192, 3584), (3584, 4096), (28672, 3584), (3584, 14336),
                     (256000, 3584), (5120, 3072), (3072, 3072),
                     (16384, 3072), (3072, 8192), (128256, 3072),
                     (9216, 3072), (32064, 3072)]
GEMV_ODD_SHAPES = [(1001, 3584, 128), (77, 4096, 128), (999, 256, 32),
                   (13, 640, 64), (4099, 14336, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("o,k,gs", [(o, k, 128) for o, k in GEMV_MODEL_SHAPES]
                         + GEMV_ODD_SHAPES)
def test_gemv_every_t_at_model_shapes_on_card(cuda_device, o, k, gs):
    """A at T = 1..8 at each model shape and at odd row counts (the last
    m16 tile and quad of rows partly past O), within 1e-4 of the output
    scale of its plain version."""
    gen = torch.Generator(device="cuda").manual_seed(o + k)
    q = torch.randint(0, 256, (o, k // 2), dtype=torch.uint8,
                      device=cuda_device, generator=gen)
    s = -0.003 * (0.5 + torch.rand((o, k // gs), device=cuda_device,
                                   generator=gen))
    for t in range(1, 9):
        x = torch.randn(t, k, device=cuda_device, generator=gen)
        got = q4_gemv(x, q, s, gs)
        want = q4_gemv_plain(x, q, s, gs)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all() and got.shape == (t, o)
        assert _rel_err(got, want) <= 1e-4, t


@pytest.mark.gpu
@pytest.mark.parametrize("t", [5, 8])
@pytest.mark.parametrize("o,k,gs", [(8192, 3584, 128), (3584, 14336, 128),
                                    (3584, 4096, 128), (1001, 3584, 128),
                                    (999, 256, 32), (13, 640, 64)])
def test_gemv_rows_independent_of_t_on_card(cuda_device, t, o, k, gs):
    """A row of a T-row call of A equals, bit for bit, the row computed
    alone (one arithmetic path for every T: speculative greedy decoding is
    exact on the card because of it); two calls give the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(t * o)
    q = torch.randint(0, 256, (o, k // 2), dtype=torch.uint8,
                      device=cuda_device, generator=gen)
    s = -0.003 * (0.5 + torch.rand((o, k // gs), device=cuda_device,
                                   generator=gen))
    x = torch.randn(t, k, device=cuda_device, generator=gen)
    whole = q4_gemv(x, q, s, gs)
    rows = torch.cat([q4_gemv(x[i:i + 1].contiguous(), q, s, gs)
                      for i in range(t)])
    again = q4_gemv(x, q, s, gs)
    torch.cuda.synchronize()
    assert torch.equal(whole, rows)
    assert torch.equal(whole, again)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [9, 64, 100, 256, 512])
@pytest.mark.parametrize("o,k,gs", [(1024, 3584, 128), (1000, 256, 32),
                                    (136, 512, 64)])
def test_gemm_kernel_on_card(cuda_device, t, o, k, gs):
    q, s = _weights(o, k, cuda_device, gs)
    x = torch.randn(t, k, device=cuda_device)
    reset_launches()
    got = q4_gemm(x, q, s, gs)
    assert launches()["q4_gemm"] == 1
    want = q4_gemm_plain(x, q, s, gs)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("hd,kh,g", [(256, 8, 2), (128, 2, 4), (64, 4, 1)])
@pytest.mark.parametrize("t_q,pos", [(1, 0), (1, 1100), (3, 63), (64, 5000),
                                     (256, 300)])
@pytest.mark.parametrize("softcap,window", [(50.0, 4096), (None, None),
                                            (30.0, 200)])
def test_flash_kernel_on_card(cuda_device, hd, kh, g, t_q, pos, softcap,
                              window):
    L, S = 2, 6144
    gen = torch.Generator(device=cuda_device).manual_seed(pos + t_q)
    k = torch.randn(L, S, kh * hd, device=cuda_device,
                    generator=gen).to(torch.bfloat16)
    v = torch.randn(L, S, kh * hd, device=cuda_device,
                    generator=gen).to(torch.bfloat16)
    q = torch.randn(t_q, kh * g, hd, device=cuda_device, generator=gen)
    kw = dict(n_kv=kh, scale=hd ** -0.5, softcap=softcap, window=window)
    got = flash_attention(q, k, v, 1, pos, **kw)
    want = flash_attention_plain(q, k, v, 1, pos, **kw)
    torch.cuda.synchronize()
    tol = flash_attention_tol(q, k, v, 1, pos, **kw)
    assert ((got - want).abs() <= tol).all()


def act_quant_traps(t, k, gs, device):
    """Random activations plus the quantizer's traps: a group whose scale
    is exactly 1 with quotients on and next to .5 (0.49999997 + 0.5 rounds
    up to 1.0 in f32, so trunc gives 1 where roundf gives 0), an all-zero
    group, and a group whose largest-magnitude value is negative."""
    x = torch.randn(t, k, generator=torch.Generator().manual_seed(t + k))
    x[0, :gs] = 0.0
    x[0, :8] = torch.tensor([127.0, 2.5, -2.5, 0.5, -0.5, 63.5, 0.49999997,
                             -0.49999997])
    x[0, gs:2 * gs] = 0.0
    x[-1, 2 * gs:3 * gs] = x[-1, 2 * gs:3 * gs].clamp(-1, 1)
    x[-1, 2 * gs + 3] = -5.0
    return x.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("t,k,gs", [(1, 3072, 128), (4, 8192, 128),
                                    (8, 576, 64), (3, 256, 32)])
def test_q8_act_quant_bit_exact_on_card(cuda_device, t, k, gs):
    x = act_quant_traps(t, k, gs, cuda_device)
    xq, xs = q8_act_quant(x, gs)
    wq, ws = quantize_q8_act(x, gs)             # plain version, on the card
    cq, cs = quantize_q8_act(x.cpu(), gs)       # and on the CPU
    torch.cuda.synchronize()
    assert torch.equal(xq, wq) and torch.equal(xs, ws)
    assert torch.equal(xq.cpu(), cq) and torch.equal(xs.cpu(), cs)
    assert xq[0, :8].tolist() == [127, 3, -3, 1, -1, 64, 1, -1]
    assert not xq[0, gs:2 * gs].any() and xs[0, 1] == 0


Q8_SHAPES = [(1024, 3072, 128), (1000, 256, 32), (136, 576, 64),
             (3, 8192, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("o,k,gs", Q8_SHAPES)
def test_q8_gemv_i8_kernel_on_card(cuda_device, t, o, k, gs):
    q, s = _q8_weights(o, k, cuda_device, gs)
    x = act_quant_traps(t, k, gs, cuda_device)
    reset_launches()
    got = q8_gemv_i8(x, q, s, gs)
    assert launches()["q8_gemv_i8"] == 1
    want = q8_gemv_i8_plain(x, q, s, gs)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-4


# kernel D at the models' layer shapes: Llama-3.2-3B's wqkv, wo, w13, w2
# (the K split over clusters of 4, 8, 2 and 8 ranks on an H100) and
# Gemma-2-9B's w2 (K = 14,336)
Q8_LAYER_SHAPES = [(5120, 3072), (3072, 3072), (16384, 3072), (3072, 8192),
                   (3584, 14336)]


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 5, 8])
@pytest.mark.parametrize("o,k", Q8_LAYER_SHAPES)
def test_q8_gemv_i8_layer_shapes_on_card(cuda_device, t, o, k):
    """D at its main path's shapes, 1e-4 of the output scale (exact integer
    dots, f32 sums in another order), one launch a call, and a row of the
    call bit for bit the row computed alone (the K split depends on O and
    K only; each column's operations are its own)."""
    q, s = _q8_weights(o, k, cuda_device)
    x = act_quant_traps(t, k, 128, cuda_device)
    reset_launches()
    got = q8_gemv_i8(x, q, s, 128)
    assert launches()["q8_gemv_i8"] == 1
    want = q8_gemv_i8_plain(x, q, s, 128)
    rows = torch.cat([q8_gemv_i8(x[i:i + 1].contiguous(), q, s, 128)
                      for i in range(t)])
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-4
    assert torch.equal(got, rows)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("o,k,gs", Q8_SHAPES)
def test_q8_gemv_kernel_on_card(cuda_device, t, o, k, gs):
    q, s = _q8_weights(o, k, cuda_device, gs)
    x = torch.randn(t, k, device=cuda_device)
    reset_launches()
    got = q8_gemv(x, q, s, gs)
    assert launches()["q8_gemv"] == 1
    want = q8_gemv_plain(x, q, s, gs)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("t", [9, 64, 100, 256, 512])
@pytest.mark.parametrize("o,k,gs", [(1024, 3072, 128), (1000, 256, 32),
                                    (136, 640, 64)])
def test_q8_gemm_kernel_on_card(cuda_device, t, o, k, gs):
    q, s = _q8_weights(o, k, cuda_device, gs)
    x = torch.randn(t, k, device=cuda_device)
    reset_launches()
    got = q8_gemm(x, q, s, gs)
    assert launches()["q8_gemm"] == 1
    want = q8_gemm_plain(x, q, s, gs)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-3


# kernels B and F at each model's layer shapes (O, K): the split-K cluster
# reduction (wo, w2), tails of O (136, 1000 above) and T (16 and 80 rows:
# a decode step of 16 slots, a verify step of 16 x (4 + 1))
GEMM_LAYER_SHAPES = {
    "q4": [(8192, 3584), (3584, 4096), (28672, 3584), (3584, 14336)],
    "q8": [(5120, 3072), (3072, 3072), (16384, 3072), (3072, 8192)],
}
GEMM_KERNELS = {"q4": (q4_gemm, q4_gemm_plain, _weights, q4_dequant),
                "q8": (q8_gemm, q8_gemm_plain, _q8_weights, q8_dequant)}


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["q4", "q8"])
@pytest.mark.parametrize("t", [16, 80])
@pytest.mark.parametrize("o,k,gs", [(1024, 3072, 128), (1000, 256, 32),
                                    (136, 640, 64)])
def test_gemm_small_t_on_card(cuda_device, quant, t, o, k, gs):
    fn, plain, weights, _ = GEMM_KERNELS[quant]
    q, s = weights(o, k, cuda_device, gs)
    x = torch.randn(t, k, device=cuda_device)
    got = fn(x, q, s, gs)
    want = plain(x, q, s, gs)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["q4", "q8"])
@pytest.mark.parametrize("layer", range(4))
def test_gemm_layer_shapes_on_card(cuda_device, quant, layer):
    """Each model's four layer matrices at T = 256 (a prefill chunk)."""
    fn, plain, weights, _ = GEMM_KERNELS[quant]
    o, k = GEMM_LAYER_SHAPES[quant][layer]
    q, s = weights(o, k, cuda_device)
    x = torch.randn(256, k, device=cuda_device)
    got = fn(x, q, s, 128)
    want = plain(x, q, s, 128)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["q4", "q8"])
@pytest.mark.parametrize("t", [9, 16, 64, 256, 512])
@pytest.mark.parametrize("o,k,gs", [(3584, 4096, 128), (1000, 256, 32),
                                    (136, 640, 64)])
def test_gemm_one_hot_rows_on_card(cuda_device, quant, t, o, k, gs):
    """Rows of x that are unit vectors e_k give W_deq[:, k] bit for bit:
    the kernel's packed dequant is dequant_bf16's rounding, element for
    element, where the 1e-3 output tolerance could not tell."""
    if quant == "q4" and k == 640:
        k = 512                     # Q4 takes K % 128 == 0
    fn, _, weights, dequant = GEMM_KERNELS[quant]
    q, s = weights(o, k, cuda_device, gs)
    cols = torch.from_numpy(np.random.default_rng(t).integers(0, k, t))
    x = torch.zeros(t, k, device=cuda_device)
    x[torch.arange(t, device=cuda_device), cols.to(cuda_device)] = 1.0
    got = fn(x, q, s, gs)
    want = dequant(q, s, gs)[:, cols.to(cuda_device)].t().float()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["q4", "q8"])
@pytest.mark.parametrize("t", [9, 64, 256, 300])
def test_gemm_deterministic_on_card(cuda_device, quant, t):
    """Two calls on the same inputs give the same bits (the split-K sums
    run in a fixed order, no atomics): greedy decoding across reset() and
    the scheduler's prefill chunks depend on it."""
    fn, _, weights, _ = GEMM_KERNELS[quant]
    o, k = GEMM_LAYER_SHAPES[quant][1]          # wo: split over K
    q, s = weights(o, k, cuda_device)
    x = torch.randn(t, k, device=cuda_device)
    first = fn(x, q, s, 128)
    second = fn(x, q, s, 128)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["q4", "q8"])
@pytest.mark.parametrize("t,k,gs", [(8, 512, 128), (513, 512, 128),
                                    (16, 320, 64), (16, 512, 48)])
def test_gemm_rejects_unsupported_shapes_on_card(cuda_device, quant, t, k,
                                                 gs):
    """8 or 513 rows, K not a multiple of 128, a group size the kernel does
    not take: the wrapper raises rather than launching."""
    fn, _, _, _ = GEMM_KERNELS[quant]
    o = 256
    if quant == "q4":
        q = torch.zeros(o, k // 2, dtype=torch.uint8, device=cuda_device)
    else:
        q = torch.zeros(o, k, dtype=torch.int8, device=cuda_device)
    s = torch.ones(o, max(1, k // gs), device=cuda_device)
    x = torch.randn(t, k, device=cuda_device)
    reset_launches()
    with pytest.raises(ValueError):
        fn(x, q, s, gs)
    assert launches()[fn.__name__] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("hd,kh,g", [(256, 8, 2), (128, 8, 3), (128, 2, 4),
                                     (64, 4, 1)])
@pytest.mark.parametrize("t_q,pos", [(1, 0), (1, 1100), (3, 63), (64, 5000),
                                     (256, 300)])
@pytest.mark.parametrize("softcap,window", [(50.0, 4096), (None, None),
                                            (30.0, 200)])
def test_flash_i8_kernel_on_card(cuda_device, hd, kh, g, t_q, pos, softcap,
                                 window):
    """Rows and scales past the last live row hold garbage and NaN, as a
    reused cache may: they must add exactly nothing."""
    L, S = 2, 6144
    gen = torch.Generator(device=cuda_device).manual_seed(pos + t_q)
    kv = torch.randn(2, L * S, kh, hd, device=cuda_device, generator=gen)
    kv = kv * (0.25 + 4 * torch.rand(2, L * S, kh, 1, device=cuda_device,
                                     generator=gen))
    rows, scales = quantize_kv_rows(kv)
    k, v = rows[0].reshape(L, S, kh * hd), rows[1].reshape(L, S, kh * hd)
    ks, vs = (scales[i].reshape(L, S, kh).transpose(1, 2).contiguous()
              for i in (0, 1))
    n = pos + t_q
    for a in (ks, vs):
        a[:, :, n:] = float("nan")
    k[:, n:] = 77
    q = torch.randn(t_q, kh * g, hd, device=cuda_device, generator=gen)
    kw = dict(n_kv=kh, scale=hd ** -0.5, softcap=softcap, window=window)
    reset_launches()
    got = flash_attention_i8(q, k, v, ks, vs, 1, pos, **kw)
    assert launches()["flash_attention_i8"] == 1
    want = flash_attention_i8_plain(q, k, v, ks, vs, 1, pos, **kw)
    torch.cuda.synchronize()
    tol = flash_attention_i8_tol(q, k, v, ks, vs, 1, pos, **kw)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= tol).all()


@pytest.mark.gpu
@pytest.mark.parametrize("hd,kh,g", [(256, 8, 2), (128, 8, 3), (128, 3, 2),
                                     (64, 4, 1), (64, 1, 4)])
@pytest.mark.parametrize("t_q,pos", [(1, 0), (1, 1100), (5, 63), (64, 5000),
                                     (256, 300)])
@pytest.mark.parametrize("softcap,window", [(50.0, 4096), (None, None),
                                            (30.0, 200)])
def test_flash_i4_kernel_on_card(cuda_device, hd, kh, g, t_q, pos, softcap,
                                 window):
    """Kernel H, both packings (half: hd 256, or an odd kv-head count; pair
    otherwise).  Rows and scales past the last live row hold garbage and
    NaN, as a reused cache may: they must add exactly nothing."""
    L, S = 2, 6144
    assert q4_cache_pair_mode(kh, hd) == (hd != 256 and kh % 2 == 0)
    gen = torch.Generator(device=cuda_device).manual_seed(pos + t_q)
    kv = torch.randn(2, L * S, kh, hd, device=cuda_device, generator=gen)
    kv = kv * (0.25 + 4 * torch.rand(2, L * S, kh, 1, device=cuda_device,
                                     generator=gen))
    rows, scales = quantize_kv_rows_q4(kv)
    k = rows[0].reshape(L, S, kh * hd // 2).contiguous()
    v = rows[1].reshape(L, S, kh * hd // 2).contiguous()
    ks, vs = (scales[i].reshape(L, S, kh).transpose(1, 2).contiguous()
              for i in (0, 1))
    n = pos + t_q
    for a in (ks, vs):
        a[:, :, n:] = float("nan")
    k[:, n:] = 0x77
    q = torch.randn(t_q, kh * g, hd, device=cuda_device, generator=gen)
    kw = dict(n_kv=kh, scale=hd ** -0.5, softcap=softcap, window=window)
    reset_launches()
    got = flash_attention_i4(q, k, v, ks, vs, 1, pos, **kw)
    assert launches()["flash_attention_i4"] == 1
    want = flash_attention_i4_plain(q, k, v, ks, vs, 1, pos, **kw)
    torch.cuda.synchronize()
    tol = flash_attention_i4_tol(q, k, v, ks, vs, 1, pos, **kw)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= tol).all()


@pytest.mark.gpu
@pytest.mark.parametrize("hd,kh,g", [(256, 8, 2), (128, 2, 4), (64, 4, 1)])
@pytest.mark.parametrize("t_q,pos", [(1, 1100), (5, 63), (256, 300)])
@pytest.mark.parametrize("softcap,window", [(50.0, 4096), (None, None)])
def test_flash_f32_cache_kernel_on_card(cuda_device, hd, kh, g, t_q, pos,
                                        softcap, window):
    """Kernel C's f32 instantiation rounds the tile to bf16 on load: within
    flash_attention_tol of the plain version on the f32 rows, and bit for
    bit the bf16 instantiation's result on the rounded rows."""
    L, S = 2, 2048
    gen = torch.Generator(device=cuda_device).manual_seed(pos + t_q)
    k = torch.randn(L, S, kh * hd, device=cuda_device, generator=gen)
    v = torch.randn(L, S, kh * hd, device=cuda_device, generator=gen)
    q = torch.randn(t_q, kh * g, hd, device=cuda_device, generator=gen)
    kw = dict(n_kv=kh, scale=hd ** -0.5, softcap=softcap, window=window)
    reset_launches()
    got = flash_attention(q, k, v, 1, pos, **kw)
    assert launches()["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, 1, pos, **kw)
    torch.cuda.synchronize()
    tol = flash_attention_tol(q, k, v, 1, pos, **kw)
    assert ((got - want).abs() <= tol).all()
    same = flash_attention(q, k.to(torch.bfloat16), v.to(torch.bfloat16), 1,
                           pos, **kw)
    assert torch.equal(got, same)


@pytest.mark.gpu
@pytest.mark.parametrize("kh,hd", [(8, 256), (8, 128), (3, 32), (32, 128)])
def test_kv_q4_quantizer_bit_exact_on_card(cuda_device, kh, hd):
    """quantize_kv_rows_q4 on the card gives the CPU's bytes and scales
    (7 / amax and amax / 7 are tensor / tensor quotients on both), the
    traps included: an all-zero row, exact ties at absmax 7, a clip to -8,
    and lanes that are zero as Phi's padded head dim leaves them."""
    x = torch.randn(2, 9, kh, hd, generator=torch.Generator().manual_seed(kh))
    x = x * (0.1 + 10 * torch.rand(2, 9, kh, 1,
                                   generator=torch.Generator().manual_seed(1)))
    x[0, 1, 0] = 0.0
    x[0, 0, 0] = 0.0
    x[0, 0, 0, :6] = torch.tensor([7.0, 0.5, 1.5, 2.5, -2.5, -6.5])
    x[1, 2, 1, hd - hd // 4:] = 0.0
    got_q, got_s = quantize_kv_rows_q4(x.to(cuda_device))
    want_q, want_s = quantize_kv_rows_q4(x)
    torch.cuda.synchronize()
    assert torch.equal(got_q.cpu(), want_q) and torch.equal(got_s.cpu(), want_s)
    vals = unpack_kv_q4(got_q, kh, hd)
    assert torch.equal(vals.cpu(), unpack_kv_q4(want_q, kh, hd))
    assert vals[0, 0, 0, :6].tolist() == [7, 0, 2, 2, -2, -6]
    assert not vals[0, 1, 0].any() and got_s[0, 1, 0] == 0


def _small_model_card_matches_cpu(tmp_path, family, quant, cache,
                                  w8a8=True, fuse_ffn=False):
    """A small model with kernel-legal widths (gs 128, head_dim 64 for
    Llama with 3 query heads per kv head, 128 for Gemma with a 48-row
    window) on the card against the same file on the CPU: prefill and
    decode logits, greedy tokens, and the kernels the path must launch.
    With `fuse_ffn` the prompt's 13-row tail takes L and the decode steps
    K."""
    from lmrs_tpu_torch.config import ModelConfig, ModelType, QuantType
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import params_from_lmrs
    from lmrs_tpu_torch.io.synthetic import write_synthetic_lmrs
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

    extra = (dict(sliding_window=48) if family == "gemma" else {})
    cache_dtype = cache if cache == "int4" else getattr(torch, cache)
    cfg = ModelConfig.make(
        ModelType.GEMMA if family == "gemma" else ModelType.LLAMA,
        dim=512, hidden_dim=1024, n_layers=2,
        n_heads=8 if family == "gemma" else 6,
        head_dim=128 if family == "gemma" else 64, n_kv_heads=2,
        vocab_size=4096, seq_len=512, rms_norm_eps=1e-5,
        rope_theta=10000.0, quant=QuantType[quant], group_size=128, **extra)
    path = str(tmp_path / "m.lmrs")
    write_synthetic_lmrs(path, cfg, seed=3, scale=0.05)
    prompt = list(range(7, 7 + 77))
    logits = {}
    for dev in ("cuda", "cpu"):
        f = read_lmrs(path)
        eng = Engine(f.cfg.replace(fuse_ffn=fuse_ffn),
                     params_from_lmrs(f, device=dev), device=dev,
                     prefill_chunk=32, cache_dtype=cache_dtype, w8a8=w8a8)
        rows = [eng.prefill(prompt)]
        rows += [eng.decode_step(t) for t in (3, 4, 5)]
        logits[dev] = torch.stack([r.float().cpu() for r in rows])
    a, b = logits["cuda"], logits["cpu"]
    assert torch.isfinite(a).all()
    assert (a - b).abs().max().item() <= 1e-2 * b.abs().max().item() + 1e-4
    f = read_lmrs(path)
    eng = Engine(f.cfg.replace(fuse_ffn=fuse_ffn),
                 params_from_lmrs(f, device="cuda"),
                 cache_dtype=cache_dtype, w8a8=w8a8)
    reset_launches()
    toks = eng.generate(prompt, GenerationConfig(temperature=0.0,
                                                 max_new_tokens=8))
    assert len(toks) == 8 and all(0 <= t < cfg.vocab_size for t in toks)
    expect = {"Q4_0": {"q4_gemv", "q4_gemm"},
              "Q8_0": {"q8_gemv_i8", "q8_gemv", "q8_gemm"}}[quant]
    if not w8a8:
        expect.discard("q8_gemv_i8")    # the layers take kernel E too
    expect.add({"int8": "flash_attention_i8",
                "int4": "flash_attention_i4"}.get(cache, "flash_attention"))
    expect.add("flash_merge")           # a decode step: split pass, merge
    if fuse_ffn:
        expect.add("ffn_fused_xe")      # the 77-row prompt: one B/F chunk
    assert {k for k, n in launches().items() if n > 0} == expect


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_small_model_card_matches_cpu(cuda_device, tmp_path, family):
    _small_model_card_matches_cpu(tmp_path, family, "Q4_0", "bfloat16")


@pytest.mark.gpu
@pytest.mark.parametrize("family,quant,cache", [
    ("llama", "Q8_0", "bfloat16"), ("llama", "Q8_0", "int8"),
    ("gemma", "Q8_0", "int8"), ("gemma", "Q4_0", "int8")])
def test_small_q8_or_int8_model_card_matches_cpu(cuda_device, tmp_path,
                                                 family, quant, cache):
    _small_model_card_matches_cpu(tmp_path, family, quant, cache)


@pytest.mark.gpu
@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_small_q8_model_without_w8a8_card_matches_cpu(cuda_device, tmp_path,
                                                      cache):
    _small_model_card_matches_cpu(tmp_path, "llama", "Q8_0", cache,
                                  w8a8=False)


@pytest.mark.gpu
@pytest.mark.parametrize("family,quant,cache", [
    ("llama", "Q8_0", "int4"), ("gemma", "Q4_0", "int4"),
    ("llama", "Q8_0", "float32"), ("gemma", "Q4_0", "float32")])
def test_small_int4_or_f32_cache_model_card_matches_cpu(cuda_device, tmp_path,
                                                        family, quant, cache):
    """The int4 cache (Llama hd 64 with 2 kv heads: pair packing; Gemma hd
    128 with 2 kv heads: pair packing) and the f32 cache on the card
    against the CPU; kernel H, or C, must have launched."""
    _small_model_card_matches_cpu(tmp_path, family, quant, cache)


def _tiny_flash_engine(tmp_path, cache):
    from lmrs_tpu_torch.config import QuantType, tiny_flash
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import params_from_lmrs
    from lmrs_tpu_torch.io.synthetic import write_synthetic_lmrs
    from lmrs_tpu_torch.runtime.engine import Engine

    cfg = tiny_flash(quant=QuantType.Q4_0, group_size=128)
    path = str(tmp_path / "m.lmrs")
    write_synthetic_lmrs(path, cfg, seed=11, scale=0.1)
    f = read_lmrs(path)
    return Engine(f.cfg, params_from_lmrs(f, device="cuda"),
                  cache_dtype=cache if cache == "int4"
                  else getattr(torch, cache))


@pytest.mark.gpu
@pytest.mark.parametrize("cache", ["bfloat16", "float32", "int8", "int4"])
def test_speculative_matches_plain_on_card(cuda_device, tmp_path, cache):
    """Speculative greedy against plain greedy on the card, tiny-flash.  A
    verify window runs the matmul kernels at T = k+1 and the flash kernel
    with t_q = k+1, which may sum in another order than at T = 1: tokens
    are compared up to the first plain step whose top-2 margin is below
    1e-3 of the logit scale, and at least 8 steps must be compared."""
    from lmrs_tpu_torch.runtime.engine import GenerationConfig

    eng = _tiny_flash_engine(tmp_path, cache)
    prompt = [5, 9, 11, 5, 9, 11, 5, 9, 11, 5, 9]
    n_new = 40
    logits = eng.prefill(prompt)
    want, margins = [], []
    for _ in range(n_new):
        top = torch.topk(logits, 2)
        want.append(int(top.indices[0]))
        margins.append(float(top.values[0] - top.values[1])
                       / float(logits.abs().max()))
        logits = eng.decode_step(want[-1])
    eng.reset()
    assert eng.generate(prompt, GenerationConfig(
        temperature=0.0, max_new_tokens=n_new)) == want
    eng.reset()
    reset_launches()
    got = eng.generate(prompt, GenerationConfig(
        temperature=0.0, max_new_tokens=n_new, speculative_k=4))
    close = [i for i, m in enumerate(margins) if m < 1e-3]
    n_eq = close[0] if close else n_new
    assert n_eq >= 8, margins
    assert got[:n_eq] == want[:n_eq]
    assert eng.metrics.spec_proposed > 0
    name = {"int8": "flash_attention_i8",
            "int4": "flash_attention_i4"}.get(cache, "flash_attention")
    assert launches()[name] > 0 and launches()["q4_gemv"] > 0
    eng.reset()
    sampled = eng.generate(prompt, GenerationConfig(
        temperature=0.9, top_p=0.9, seed=7, max_new_tokens=24,
        speculative_k=3))
    assert len(sampled) == 24
    assert all(0 <= t < eng.cfg.vocab_size for t in sampled)


@pytest.mark.gpu
@pytest.mark.parametrize("cache", ["bfloat16", "int4"])
def test_session_round_trip_on_card(cuda_device, tmp_path, cache):
    from lmrs_tpu_torch.runtime.engine import GenerationConfig

    eng = _tiny_flash_engine(tmp_path, cache)
    gen = GenerationConfig(temperature=0.0, max_new_tokens=8)
    eng.generate([3, 17, 42, 7, 99], gen)
    eng.save_session(str(tmp_path / "s.npz"))
    other = _tiny_flash_engine(tmp_path, cache)
    other.load_session(str(tmp_path / "s.npz"))
    assert other.pos == eng.pos
    assert torch.equal(other.cache.k, eng.cache.k)
    assert other.generate([7, 7, 2], gen) == eng.generate([7, 7, 2], gen)


def _single(cache, q, k, v, ks, vs, pos, **kw):
    """Kernel C, G or H on one slot's (L, S, row) rows."""
    if cache in ("bf16", "f32"):
        return flash_attention(q, k, v, 1, pos, **kw)
    fn = flash_attention_i8 if cache == "int8" else flash_attention_i4
    return fn(q, k, v, ks, vs, 1, pos, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("cache", ["bf16", "f32", "int8", "int4"])
@pytest.mark.parametrize("hd,kh,g", [(256, 8, 2), (128, 8, 3), (64, 4, 1)])
@pytest.mark.parametrize("t_q,psz", [(1, 512), (5, 512), (5, 56), (1, 8)])
def test_flash_batched_and_paged_on_card(cuda_device, cache, hd, kh, g, t_q,
                                         psz):
    """Kernels I (per-slot cache; not int4) and J (page pool) at B = 5,
    ragged positions including 0 and some past a 1,024-row window,
    softcap 50: within the plain versions' bound; each slot bit for bit
    C / G / H on its own rows; J bit for bit I; a slot unchanged when the
    other slots, their pages and the trash page hold NaN."""
    pos = [0, 700, 1030 - t_q, 1300, 37]
    case = make_case(cuda_device, b=5, n_layers=2, s_len=1344, kh=kh, hd=hd,
                     cache=cache, psz=psz, pos=pos, t_q=t_q, seed=hd + t_q,
                     g=g)
    q, p = case["q"], case["pos"]
    kw = dict(n_kv=kh, scale=hd ** -0.5, softcap=50.0, window=1024)
    k, v, ks, vs = case["contig"]
    kp, vp, table, pks, pvs = case["paged"]
    reset_launches()
    got_j = flash_attention_paged(q, kp, vp, table, 1, p, k_scale=pks,
                                  v_scale=pvs, **kw)
    assert launches()["flash_attention_paged"] == 1
    want = flash_attention_paged_plain(q, kp, vp, table, 1, p, k_scale=pks,
                                       v_scale=pvs, **kw)
    tol = flash_attention_paged_tol(q, kp, vp, table, 1, p, k_scale=pks,
                                    v_scale=pvs, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got_j).all()
    assert ((got_j - want).abs() <= tol).all()
    for i, pi in enumerate(pos):
        one = _single(cache, q[i], k[i], v[i], None if ks is None else ks[i],
                      None if vs is None else vs[i], pi, **kw)
        assert torch.equal(got_j[i], one), i
    if cache != "int4":
        got_i = flash_attention_batched(q, k, v, 1, p, k_scale=ks,
                                        v_scale=vs, **kw)
        assert launches()["flash_attention_batched"] == 1
        want_i = flash_attention_batched_plain(q, k, v, 1, p, k_scale=ks,
                                               v_scale=vs, **kw)
        tol_i = flash_attention_batched_tol(q, k, v, 1, p, k_scale=ks,
                                            v_scale=vs, **kw)
        torch.cuda.synchronize()
        assert ((got_i - want_i).abs() <= tol_i).all()
        assert torch.equal(got_i, got_j)
    (sk, sv, sks, svs), (spk, spv, stb, spks, spvs) = spoil(case, 3)
    bad_j = flash_attention_paged(q, spk, spv, stb, 1, p, k_scale=spks,
                                  v_scale=spvs, **kw)
    assert torch.equal(bad_j[3], got_j[3])
    if cache != "int4":
        bad_i = flash_attention_batched(q, sk, sv, 1, p, k_scale=sks,
                                        v_scale=svs, **kw)
        assert torch.equal(bad_i[3], got_j[3])


@pytest.mark.gpu
def test_flash_batched_rejects_what_it_cannot_take(cuda_device):
    """Host positions, int64 positions and a table of another dtype raise
    instead of launching."""
    case = make_case(cuda_device, b=2, n_layers=1, s_len=64, kh=2, hd=128,
                     cache="bf16", psz=16, pos=[3, 9], t_q=1)
    k, v, _, _ = case["contig"]
    kp, vp, table, _, _ = case["paged"]
    kw = dict(n_kv=2, scale=0.1)
    with pytest.raises(ValueError):
        flash_attention_batched(case["q"], k, v, 0, case["pos"].cpu(), **kw)
    with pytest.raises(ValueError):
        flash_attention_batched(case["q"], k, v, 0, case["pos"].long(), **kw)
    with pytest.raises(ValueError):
        flash_attention_paged(case["q"], kp, vp, table.long(), 0,
                              case["pos"], **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("family,quant,cache", [
    ("gemma", "Q4_0", "bfloat16"), ("llama", "Q8_0", "int8")])
def test_small_fused_ffn_model_card_matches_cpu(cuda_device, tmp_path,
                                                family, quant, cache):
    _small_model_card_matches_cpu(tmp_path, family, quant, cache,
                                  fuse_ffn=True)


def _ffn_case(device, quant, t, d, h, gs, seed=0):
    """x (T, D) and one FFN's weights (q, s of w13, then of w2) in the
    runtime layout, from the export quantizers."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (t, d)).astype(np.float32))
    out = [x.to(device)]
    for o, k in ((2 * h, d), (d, h)):
        w = rng.normal(0, 0.1, (o, k)).astype(np.float32)
        if quant == "q4":
            packed, s, _ = quantize_q40_np(w, gs)
            q = q4_file_to_runtime_np(packed.reshape(o, k // 2), gs)
        else:
            q, s, _ = quantize_q80_np(w, gs)
            q = q.reshape(o, k)
        out += [torch.from_numpy(q).to(device),
                torch.from_numpy(s.reshape(o, k // gs)).to(device)]
    return out


# small shapes at every weight type and activation; Gemma-2-9B's and
# Llama-3.2-3B's FFN at their own
FFN_SMALL = [(256, 512, 32), (512, 1536, 64)]
FFN_CASES = ([(q, a, d, h, gs) for q in ("q4", "q8") for a in ("silu", "gelu")
              for d, h, gs in FFN_SMALL]
             + [("q4", "gelu", 3584, 14336, 128),
                ("q8", "silu", 3072, 8192, 128)])


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 2, 5, 8])
@pytest.mark.parametrize("quant,act,d,h,gs", FFN_CASES)
def test_ffn_fused_xe_kernel_on_card(cuda_device, quant, act, d, h, gs, t):
    x, *w = _ffn_case(cuda_device, quant, t, d, h, gs)
    reset_launches()
    got = ffn_fused_xe(x, *w, gs, act)
    assert launches()["ffn_fused_xe"] == 1
    want = ffn_fused_xe_plain(x, *w, gs, act)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and got.shape == (t, d)
    assert _rel_err(got, want) <= 1e-3
    # row independence: each row of the call bit for bit the row alone
    rows = torch.cat([ffn_fused_xe(x[i:i + 1].contiguous(), *w, gs, act)
                      for i in range(t)])
    assert torch.equal(rows, got)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [3, 4, 6, 7])
@pytest.mark.parametrize("quant,act,d,h,gs", FFN_CASES[-2:])
def test_ffn_fused_xe_every_t_at_model_shapes_on_card(cuda_device, quant,
                                                      act, d, h, gs, t):
    """K at the row counts the cases above leave out, at Gemma-2-9B's and
    Llama-3.2-3B's FFN: within 1e-3 of the plain version's output scale,
    each row bit for bit the row alone."""
    x, *w = _ffn_case(cuda_device, quant, t, d, h, gs, seed=t)
    got = ffn_fused_xe(x, *w, gs, act)
    want = ffn_fused_xe_plain(x, *w, gs, act)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and got.shape == (t, d)
    assert _rel_err(got, want) <= 1e-3
    rows = torch.cat([ffn_fused_xe(x[i:i + 1].contiguous(), *w, gs, act)
                      for i in range(t)])
    assert torch.equal(rows, got)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [9, 12, 16])
@pytest.mark.parametrize("quant,act,d,h,gs", FFN_CASES)
def test_ffn_fused_kernel_on_card(cuda_device, quant, act, d, h, gs, t):
    x, *w = _ffn_case(cuda_device, quant, t, d, h, gs)
    reset_launches()
    got = ffn_fused(x, *w, gs, act)
    assert launches()["ffn_fused"] == 1
    want = ffn_fused_plain(x, *w, gs, act)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and got.shape == (t, d)
    assert _rel_err(got, want) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("t", list(range(9, 17)))
@pytest.mark.parametrize("quant,act,d,h,gs", [
    ("q4", "gelu", 128, 96, 32), ("q8", "silu", 128, 96, 32),
    ("q4", "silu", 96, 512, 32), ("q8", "gelu", 320, 320, 64)])
def test_ffn_fused_glu_tiles_on_card(cuda_device, quant, act, d, h, gs, t):
    """L at every T of 9..16 where H is not a multiple of the 64 gate rows
    of a tile (H = 96, 320: the last tile's gate and up boxes run past H
    and must read zeros, not the other half's rows), where a stage's K is
    not a multiple of its chunk (Q4 chunks of 128: H = 96 in the down
    stage, D = 96 in the GLU stage) and where D leaves a partial tile of
    output rows."""
    x, *w = _ffn_case(cuda_device, quant, t, d, h, gs, seed=t)
    got = ffn_fused(x, *w, gs, act)
    want = ffn_fused_plain(x, *w, gs, act)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and got.shape == (t, d)
    assert _rel_err(got, want) <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("quant,act,d,h,gs", FFN_CASES)
def test_ffn_fused_deterministic_on_card(cuda_device, quant, act, d, h, gs):
    """Two calls of L on the same inputs give the same bits (split-K sums
    in cluster rank order, no atomics)."""
    x, *w = _ffn_case(cuda_device, quant, 16, d, h, gs)
    first = ffn_fused(x, *w, gs, act)
    second = ffn_fused(x, *w, gs, act)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_ffn_fused_rejects_what_it_cannot_take(cuda_device):
    """Row counts out of range, mixed weight types, mismatched shapes, a
    group size the kernel does not take, a non-contiguous or host weight
    and an unknown activation raise instead of launching."""
    x, q13, s13, q2, s2 = _ffn_case(cuda_device, "q4", 4, 256, 512, 32)
    _, p13, t13, p2, t2 = _ffn_case(cuda_device, "q8", 4, 256, 512, 32)
    reset_launches()
    with pytest.raises(ValueError):
        ffn_fused_xe(torch.zeros(9, 256, device=cuda_device), q13, s13, q2,
                     s2, 32, "silu")
    with pytest.raises(ValueError):
        ffn_fused(x, q13, s13, q2, s2, 32, "silu")           # 4 rows
    with pytest.raises(TypeError):
        ffn_fused_xe(x, q13, s13, p2, t2, 32, "silu")
    with pytest.raises(ValueError):
        ffn_fused_xe(x, q13, s13, q2[:128].contiguous(), s2[:128].contiguous(),
                     32, "silu")
    with pytest.raises(ValueError):
        ffn_fused_xe(x, p13, t13, p2, t2, 16, "silu")
    with pytest.raises(ValueError):
        ffn_fused_xe(x, q13.t().contiguous().t(), s13, q2, s2, 32, "silu")
    with pytest.raises(ValueError):
        ffn_fused_xe(x, q13.cpu(), s13, q2, s2, 32, "silu")
    with pytest.raises(ValueError):
        ffn_fused_xe(x, q13, s13, q2, s2, 32, "relu")
    assert launches()["ffn_fused_xe"] == launches()["ffn_fused"] == 0


MASK_NEG = torch.finfo(torch.float32).min


def _split_cache(cache, kh, hd, s_len, gen):
    """A two-layer `cache` KV cache of random rows, as the single-sequence
    kernels take it: (k, v, k_scale, v_scale), the scales None for bf16."""
    kv = torch.randn(2, 2, s_len, kh, hd, device="cuda", generator=gen)
    if cache == "bf16":
        rows = kv.reshape(2, 2, s_len, kh * hd).to(torch.bfloat16)
        return rows[0], rows[1], None, None
    quantize = quantize_kv_rows if cache == "int8" else quantize_kv_rows_q4
    rows, sc = quantize(kv)                  # (2, L, S, row), (2, L, S, KH)
    return (rows[0].contiguous(), rows[1].contiguous(),
            sc[0].transpose(1, 2).contiguous(),
            sc[1].transpose(1, 2).contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("cache,hd,kh,g,window", [
    ("bf16", 256, 8, 2, 4096), ("int8", 128, 8, 3, None),
    ("int4", 128, 8, 3, None), ("int4", 256, 8, 2, 4096)])
def test_flash_split_boundaries_on_card(cuda_device, cache, hd, kh, g,
                                        window):
    """C, G and H (both packings) at T 1 and 5 with the last live row on
    and next to a split boundary (pos = k*SPLIT - 1, k*SPLIT) and with the
    window's first row there: within the plain version's bound, and each
    row of the T = 5 call bit for bit the row alone."""
    split = SPLIT
    s_len = 8192
    gen = torch.Generator(device=cuda_device).manual_seed(hd + len(cache))
    k, v, ks, vs = _split_cache(cache, kh, hd, s_len, gen)
    kw = dict(n_kv=kh, scale=hd ** -0.5,
              softcap=50.0 if window else None, window=window)
    plist = [3 * split - 1, 3 * split, 5 * split - 5]
    if window:
        plist += [window + 2 * split - 1, window + 2 * split,
                  window + 2 * split + 1]
    for pos in plist:
        for t_q in (1, 5):
            q = torch.randn(t_q, kh * g, hd, device=cuda_device,
                            generator=gen)
            got = _single(cache, q, k, v, ks, vs, pos, **kw)
            if cache == "bf16":
                want = flash_attention_plain(q, k, v, 1, pos, **kw)
                tol = flash_attention_tol(q, k, v, 1, pos, **kw)
            elif cache == "int8":
                want = flash_attention_i8_plain(q, k, v, ks, vs, 1, pos,
                                                **kw)
                tol = flash_attention_i8_tol(q, k, v, ks, vs, 1, pos, **kw)
            else:
                want = flash_attention_i4_plain(q, k, v, ks, vs, 1, pos,
                                                **kw)
                tol = flash_attention_i4_tol(q, k, v, ks, vs, 1, pos, **kw)
            torch.cuda.synchronize()
            assert ((got - want).abs() <= tol).all(), (pos, t_q)
            if t_q == 5:
                rows = torch.cat([_single(cache, q[i:i + 1].contiguous(), k,
                                          v, ks, vs, pos + i, **kw)
                                  for i in range(5)])
                assert torch.equal(got, rows), pos


@pytest.mark.gpu
@pytest.mark.parametrize("cache,hd,kh,g,window", [
    ("bf16", 256, 8, 2, 4096), ("f32", 128, 8, 3, None),
    ("int8", 128, 8, 3, None), ("int4", 128, 8, 3, None),
    ("int4", 256, 8, 2, 4096)])
def test_flash_device_position_on_card(cuda_device, cache, hd, kh, g,
                                       window):
    """C (bf16 and f32 cache), G and H (both packings) with the position
    a (1,) int32 device tensor and host bounds up to 4 splits past it (the
    split axis sized from the bounds, the splits past the live range
    exiting at once) give the host-position call bit for bit, at T 1 and
    5, on split boundaries and at the window's edge; no host read of the
    position."""
    split = SPLIT
    s_len = 8192
    gen = torch.Generator(device=cuda_device).manual_seed(hd + kh)
    if cache == "f32":
        k, v, ks, vs = _split_cache("bf16", kh, hd, s_len, gen)
        k, v = k.float(), v.float()
    else:
        k, v, ks, vs = _split_cache(cache, kh, hd, s_len, gen)
    kw = dict(n_kv=kh, scale=hd ** -0.5,
              softcap=50.0 if window else None, window=window)
    plist = [3 * split - 1, 3 * split, 5 * split - 5]
    if window:
        plist += [window + 2 * split - 1, window + 2 * split]
    for pos in plist:
        for t_q in (1, 5):
            q = torch.randn(t_q, kh * g, hd, device=cuda_device,
                            generator=gen)
            want = _single(cache, q, k, v, ks, vs, pos, **kw)
            p = torch.tensor([pos], dtype=torch.int32, device=cuda_device)
            for bounds in ((pos, pos), (pos, pos + 4 * split),
                           (pos - 2 * split, pos + split)):
                got = _single(cache, q, k, v, ks, vs, p, pos_range=bounds,
                              **kw)
                assert torch.equal(got, want), (pos, t_q, bounds)


@pytest.mark.gpu
def test_flash_decode_merge_waits_for_the_split_pass_on_card(cuda_device):
    """Kernel M launched behind the split pass in one host call (a
    programmatic dependent launch) gives the bits of the split pass alone,
    a synchronize, then M on its workspace: 50 calls at Gemma-2-9B's
    geometry at pos 6,000, where the split pass is longest, so that a merge
    that read the workspace before the split pass finished would show."""
    kh, g, hd, s_len, pos = 8, 2, 256, 8192, 6000
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    k, v, _, _ = _split_cache("bf16", kh, hd, s_len, gen)
    common = dict(n_kv=kh, s_len=s_len, row=kh * hd, pos=pos, seq_base=0,
                  slot_stride=0, scale_slot_stride=0, table=None, maxp=0,
                  psz=0, split=SPLIT, scale=hd ** -0.5, softcap=50.0,
                  window=4096, ctype=fm.BF16, what="split pass",
                  n_split=fm.n_splits_host(pos, 1, s_len, 4096, SPLIT))
    for i in range(50):
        q = torch.randn(1, kh * g, hd, device=cuda_device, generator=gen)
        got = fm.split_pass(q, k[0], v[0], None, None,
                            out=torch.empty_like(q), **common)
        acc, m, l = fm.split_pass(q, k[0], v[0], None, None, **common)
        torch.cuda.synchronize()
        want = flash_merge(acc, m, l)[0]
        assert torch.equal(got, want), i


@pytest.mark.gpu
@pytest.mark.parametrize("cache", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("t_q", [1, 5])
def test_flash_cp_partials_on_card(cuda_device, cache, t_q):
    """B1: the per-slot cache cut into 4 shards along S, each shard's raw
    pieces (`return_lse=True`, `seq_base`) against the plain version, a
    shard that slot 0 never reaches at m == _MASK_NEG, and the shards
    merged by kernel M against kernel I on the whole cache and the plain
    version, within I's bound."""
    hd, kh, g, s_len, n_shards = 256, 8, 2, 2048, 4
    pos = [100, 700, 1530 - t_q, 1600, 2040 - t_q]
    case = make_case(cuda_device, b=5, n_layers=2, s_len=s_len, kh=kh, hd=hd,
                     cache=cache, psz=64, pos=pos, t_q=t_q, seed=t_q, g=g)
    q, p = case["q"], case["pos"]
    k, v, ks, vs = case["contig"]
    kw = dict(n_kv=kh, scale=hd ** -0.5, softcap=50.0, window=1024)
    shard = s_len // n_shards
    parts = []
    reset_launches()
    for i in range(n_shards):
        cut = [None if a is None else
               a.narrow(2 if a is k or a is v else 3, i * shard,
                        shard).contiguous() for a in (k, v, ks, vs)]
        sk = dict(k_scale=cut[2], v_scale=cut[3], seq_base=i * shard,
                  return_lse=True, **kw)
        acc, m, l = flash_attention_batched(q, cut[0], cut[1], 1, p, **sk)
        pacc, pm, pl = flash_attention_batched_plain(q, cut[0], cut[1], 1, p,
                                                     **sk)
        tol = flash_attention_batched_tol(q, cut[0], cut[1], 1, p, **sk)
        torch.cuda.synchronize()
        live = pm != MASK_NEG
        assert torch.equal(m == MASK_NEG, ~live)
        assert ((acc - pacc).abs() <= tol)[live].all()
        torch.testing.assert_close(m[live], pm[live], rtol=0, atol=1e-5)
        torch.testing.assert_close(l[live], pl[live], rtol=1e-4, atol=0)
        assert (acc[~live] == 0).all() and (l[~live] == 0).all()
        parts.append((acc, m, l))
    assert launches()["flash_attention_batched"] == n_shards
    # slot 0 (pos 100) never reaches shards 1..3
    assert (parts[3][1][0] == MASK_NEG).all()
    merged = flash_merge(*(torch.stack([pt[j] for pt in parts], dim=1)
                           for j in range(3)))
    got_i = flash_attention_batched(q, k, v, 1, p, k_scale=ks, v_scale=vs,
                                    **kw)
    want = flash_attention_batched_plain(q, k, v, 1, p, k_scale=ks,
                                         v_scale=vs, **kw)
    tol = flash_attention_batched_tol(q, k, v, 1, p, k_scale=ks, v_scale=vs,
                                      **kw)
    torch.cuda.synchronize()
    assert ((merged - got_i).abs() <= tol).all()
    assert ((merged - want).abs() <= tol).all()


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,t_q,h,hd", [(1, 17, 1, 16, 256),
                                          (8, 18, 5, 16, 256),
                                          (16, 32, 5, 24, 128),
                                          (3, 2, 2, 4, 64)])
def test_flash_merge_on_card(cuda_device, b, n, t_q, h, hd):
    """Kernel M against its plain version, raw and normalized, with dead
    splits (m = -inf, acc NaN: never read) and a row with no live split."""
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    acc = torch.randn(b, n, t_q, h, hd, device=cuda_device, generator=gen)
    m = 3 * torch.randn(b, n, t_q, h, device=cuda_device, generator=gen)
    l = 1 + torch.rand(b, n, t_q, h, device=cuda_device, generator=gen)
    dead = torch.rand(b, n, t_q, h, device=cuda_device, generator=gen) < 0.3
    dead[..., 0, 0] = True                 # row (., 0, 0): no live split
    dead[:, 0, 0, 1] = False
    m[dead] = float("-inf")
    l[dead] = 0.0
    acc[dead] = float("nan")
    reset_launches()
    got = flash_merge(acc, m, l)
    num, mg, den = flash_merge(acc, m, l, raw=True)
    assert launches()["flash_merge"] == 2
    want = flash_merge_plain(acc, m, l)
    wnum, wmg, wden = flash_merge_plain(acc, m, l, raw=True)
    torch.cuda.synchronize()
    ok = ~dead.all(dim=1)
    tol = flash_merge_tol(acc, m, l)
    assert ((got - want).abs() <= tol)[ok].all()
    assert ((num - wnum).abs() <= flash_merge_tol(acc, m, l, raw=True)).all()
    assert torch.equal(mg, wmg)
    torch.testing.assert_close(den, wden, rtol=2 ** -16, atol=0)
    assert (mg[~ok] == MASK_NEG).all() and (num[~ok] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("cache", ["bf16", "f32", "int8", "int4"])
@pytest.mark.parametrize("hd,kh,g", [(256, 8, 2), (128, 8, 3)])
@pytest.mark.parametrize("t_q", [5, 8])
def test_flash_rows_independent_of_t_on_card(cuda_device, cache, hd, kh, g,
                                             t_q):
    """A row of a T = 5 or 8 call of C (bf16, f32), G or H, and of I and J
    (not int4 for I), equals the row computed alone, bit for bit:
    speculative greedy decoding is exact because of it.  At hd 128, G = 3,
    T = 8 holds 24 query rows: a block of 64 rows, where a row alone takes
    a block of 16."""
    pos = [0, 700, 1030, 1300, 37]
    case = make_case(cuda_device, b=5, n_layers=2, s_len=1344, kh=kh, hd=hd,
                     cache=cache, psz=56, pos=pos, t_q=t_q, seed=hd, g=g)
    q, p = case["q"], case["pos"]
    kw = dict(n_kv=kh, scale=hd ** -0.5, softcap=50.0, window=1024)
    k, v, ks, vs = case["contig"]
    kp, vp, table, pks, pvs = case["paged"]
    fns = {"J": lambda qq, pp: flash_attention_paged(
        qq, kp, vp, table, 1, pp, k_scale=pks, v_scale=pvs, **kw)}
    if cache != "int4":
        fns["I"] = lambda qq, pp: flash_attention_batched(
            qq, k, v, 1, pp, k_scale=ks, v_scale=vs, **kw)
    for name, fn in fns.items():
        whole = fn(q, p)
        rows = torch.cat([fn(q[:, i:i + 1].contiguous(), p + i)
                          for i in range(t_q)], dim=1)
        assert torch.equal(whole, rows), name
    for i, pi in enumerate(pos):
        sq = q[i]
        one = (k[i], v[i], None if ks is None else ks[i],
               None if vs is None else vs[i])
        whole = _single(cache, sq, *one, pi, **kw)
        rows = torch.cat([_single(cache, sq[t:t + 1].contiguous(), *one,
                                  pi + t, **kw) for t in range(t_q)])
        assert torch.equal(whole, rows), (cache, pi)


# --------------------------------------------------------------------------
# The multimodal path (Phi-3.5-vision): the exact matmul, the CLIP encoder
# and the image prefix on the card against the same code on the CPU.  No
# kernel of its own: the vision matmuls are f32 torch products of exact
# integers, the text side the Phi path's kernels.  Tolerances: the exact
# matmul's integer part bit for bit (integers below 2^24 in f32) and its
# output within 1e-6 of the output scale (the same elementwise f32 ops and
# group sums in the same order); the encoder with its weights dequantized
# to f32 within 1e-4 of the output scale (f32 sums in another order); the
# encoder and the image rows as they run, with lm.rs's activation
# quantizer, within 1e-2 of the output scale and 1e-4 on at least 90% of
# the rows: the card's f32 sums (softmax, layernorm, exp) differ from the
# CPU's in the last bit, and where an activation lies within that bit of a
# rounding boundary it rounds to the neighbouring integer on one side,
# which moves the row it feeds by up to ~3e-3 of the scale at these
# narrow widths (1.3% of the encoder's rows past 1e-4 measured on the
# card); logits 1e-2 of the logit scale, as the small models above.  That
# end-to-end bound cannot tell a wrong quantizer from those flips (a
# skipped quantizer or bf16 products move the tower by about as much), so
# each matmul call of the card's encoder is also held on its own, against
# the exact arithmetic on the CPU on the input it was given, within 1e-6.
# --------------------------------------------------------------------------

def _close_up_to_rounding_steps(got, want):
    err = (got.float().cpu() - want.float()).abs().reshape(
        -1, want.shape[-1])
    scale = want.abs().max().item()
    assert err.max().item() <= 1e-2 * scale
    assert (err > 1e-4 * scale).any(dim=1).float().mean().item() <= 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("quant", ["Q8_0", "Q4_0"])
@pytest.mark.parametrize("t,o,k", [(2885, 4096, 1024), (2885, 1024, 4096)])
def test_exact_matmul_card_matches_cpu(cuda_device, quant, t, o, k):
    """The vision encoder's w1 and w2 over 5 crops of 577 rows."""
    from lmrs_tpu_torch.config import QuantType
    from lmrs_tpu_torch.ops.matmul import group_ints, qmatmul_exact
    from lmrs_tpu_torch.quant import (QTensor, quantize_q4_act,
                                      quantize_q8_act, quantize_q40_np,
                                      quantize_q80_np, unpack_q4)

    rng = np.random.default_rng(t + o)
    w = rng.normal(0, 0.02, (o, k)).astype(np.float32)
    if quant == "Q8_0":
        q, s, _ = quantize_q80_np(w, 128)
        q = q.reshape(o, k)
    else:
        q, s, _ = quantize_q40_np(w, 128)
        q = q4_file_to_runtime_np(q.reshape(o, k // 2), 128)
    wt = QTensor(torch.from_numpy(q.copy()),
                 torch.from_numpy(s.reshape(o, k // 128).copy()),
                 QuantType[quant], 128, o, k)
    x = torch.from_numpy(rng.normal(0, 1, (t, k)).astype(np.float32))
    wc = QTensor(wt.q.to(cuda_device), wt.s.to(cuda_device), wt.qtype, 128,
                 o, k)
    want = qmatmul_exact(x, wt)
    got = qmatmul_exact(x.to(cuda_device), wc).cpu()
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-6 * scale
    quantize = quantize_q8_act if quant == "Q8_0" else quantize_q4_act
    xq, xs = quantize(x, 128)
    cq, cs = quantize(x.to(cuda_device), 128)
    assert torch.equal(cq.cpu(), xq) and torch.equal(cs.cpu(), xs)
    wq = wt.q if quant == "Q8_0" else unpack_q4(wt.q, 128)
    ints = group_ints(xq, wq, 128)
    assert torch.equal(group_ints(cq, wq.to(cuda_device), 128).cpu(), ints)


def _narrow_multimodal(path, vdim=256):
    """A small Phi-3.5-vision file with kernel-legal text widths (gs 128,
    head_dim 96 padded to a 128 cache head) and a narrow CLIP encoder."""
    from lmrs_tpu_torch.config import ModelConfig, ModelType, QuantType
    from lmrs_tpu_torch.io.lmrs import write_lmrs
    from lmrs_tpu_torch.io.synthetic import random_multimodal_weights
    from lmrs_tpu_torch.models.phi3v import ProcessorConfig
    from lmrs_tpu_torch.models.vision import VisionConfig

    cfg = ModelConfig.make(
        ModelType.PHI, dim=512, hidden_dim=1024, n_layers=2, n_heads=4,
        head_dim=96, n_kv_heads=4, vocab_size=32064, seq_len=1024,
        rms_norm_eps=1e-5, rope_theta=10000.0, quant=QuantType.Q8_0,
        group_size=128, multimodal=True)
    vc = VisionConfig(dim=vdim, hidden_dim=4 * vdim, n_layers=3, n_heads=4,
                      head_dim=vdim // 4, quant=QuantType.Q8_0,
                      group_size=128)
    pc = ProcessorConfig(hidden_dim=4 * vdim, text_dim=512,
                         quant=QuantType.Q8_0, group_size=128)
    write_lmrs(path, cfg, random_multimodal_weights(cfg, vc, pc, 5),
               vision_cfg=vc, processor_cfg=pc)
    return path


@pytest.mark.gpu
def test_vision_forward_card_matches_cpu(cuda_device, tmp_path):
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import vision_params_from_lmrs
    from lmrs_tpu_torch.models.vision import (recording_matmul,
                                              vision_forward,
                                              vision_params_dequantized,
                                              worst_call_error)

    f = read_lmrs(_narrow_multimodal(str(tmp_path / "mm.lmrs")))
    vc = f.vision_cfg
    patches = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (3, vc.n_patches, 588)).astype(np.float32))
    out, flt = {}, {}
    rec, calls = recording_matmul()
    for dev in ("cpu", "cuda"):
        _, vp, _, _ = vision_params_from_lmrs(f, device=dev)
        kw = dict(matmul=rec) if dev == "cuda" else {}
        out[dev] = vision_forward(vp, vc, patches.to(dev), **kw)
        flt[dev] = vision_forward(vision_params_dequantized(vp), vc,
                                  patches.to(dev))
    assert torch.isfinite(out["cuda"]).all()
    assert _rel_err(flt["cuda"].cpu(), flt["cpu"]) <= 1e-4
    # every matmul of the card's tower is lm.rs's exact arithmetic on the
    # input it was given
    assert len(calls) == 6 * (vc.n_layers - 1)
    assert worst_call_error(calls) <= 1e-6
    _close_up_to_rounding_steps(out["cuda"], out["cpu"])


@pytest.mark.gpu
def test_prefill_embeds_card_matches_cpu(cuda_device, tmp_path):
    """An image (2 x 2 crops) to its 764 rows, prefilled before a turn:
    the rows, the turn's logits and three decode steps' on the card
    against the CPU; then greedy on the card launches the Phi Q8_0 path's
    kernels and no other."""
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import (params_from_lmrs,
                                          vision_params_from_lmrs)
    from lmrs_tpu_torch.models.phi3v import encode_image_to_embeds
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

    f = read_lmrs(_narrow_multimodal(str(tmp_path / "mm.lmrs")))
    img = np.random.default_rng(3).integers(0, 256, (300, 400, 3),
                                            dtype=np.uint8)
    turn = [450, 311, 7321, 29973, 32007, 29871, 13, 32001, 29871, 13]
    rows, logits = {}, {}
    for dev in ("cpu", "cuda"):
        params = params_from_lmrs(f, device=dev)
        rows[dev] = encode_image_to_embeds(
            vision_params_from_lmrs(f, device=dev), params, f.cfg, img, 4)
        # the logits from the same rows: the text path's kernels alone
        eng = Engine(f.cfg, params, device=dev, prefill_chunk=256)
        eng.prefill_embeds(rows["cpu"].to(dev), want_logits=False)
        out = [eng.prefill(turn)] + [eng.decode_step(t) for t in (5, 6, 7)]
        logits[dev] = torch.stack([o.float().cpu() for o in out])
    assert rows["cuda"].shape == (764, 512)
    _close_up_to_rounding_steps(rows["cuda"], rows["cpu"])
    a, b = logits["cuda"], logits["cpu"]
    assert torch.isfinite(a).all()
    assert (a - b).abs().max().item() <= 1e-2 * b.abs().max().item() + 1e-4
    eng = Engine(f.cfg, params, device="cuda")
    reset_launches()
    eng.prefill_embeds(rows["cuda"], want_logits=False)
    toks = eng.generate(turn, GenerationConfig(temperature=0.0,
                                               max_new_tokens=8))
    assert len(toks) == 8 and all(0 <= t < 32064 for t in toks)
    assert {k for k, n in launches().items() if n > 0} == {
        "q8_gemm", "flash_attention", "flash_merge", "q8_gemv_i8",
        "q8_gemv"}


@pytest.mark.gpu
def test_image_file_decodes_on_card(cuda_device, tmp_path):
    """An image file goes through PIL (skipped where PIL is missing) to
    the same rows as its decoded array."""
    Image = pytest.importorskip("PIL.Image")
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import (params_from_lmrs,
                                          vision_params_from_lmrs)
    from lmrs_tpu_torch.models.phi3v import encode_image_to_embeds

    f = read_lmrs(_narrow_multimodal(str(tmp_path / "mm.lmrs"), vdim=128))
    img = np.random.default_rng(4).integers(0, 256, (120, 90, 3),
                                            dtype=np.uint8)
    png = str(tmp_path / "img.png")
    Image.fromarray(img).save(png)
    params = params_from_lmrs(f, device="cuda")
    vision = vision_params_from_lmrs(f, device="cuda")
    a = encode_image_to_embeds(vision, params, f.cfg, png, 1)
    b = encode_image_to_embeds(vision, params, f.cfg, img, 1)
    assert torch.equal(a, b)


def _chip_smoke():
    """chip_smoke.py, the run phase 6 of which these tests shrink."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


@pytest.mark.gpu
def test_native_tokenizer_on_the_card_machine(cuda_device, tmp_path):
    """The native merge engine builds on the card's machine and equals the
    Python loop on chip_smoke's 128,256-token vocabulary."""
    from lmrs_tpu_torch.tokenizer import Tokenizer

    cs = _chip_smoke()
    path = tmp_path / "tokenizer.bin"
    cs.synthetic_tokenizer(path, 128256, merges=True)
    tok = Tokenizer.from_file(str(path))
    assert tok._native is not None
    plain = Tokenizer.from_file(str(path), native=False)
    text = "".join(np.random.default_rng(7).choice(
        list(cs.SMOKE_WORDS) + [" x", "é", "."], 300))
    ids = tok.encode(text)
    assert ids == plain.encode(text)
    assert len(ids) < len(text) // 2          # the words merged


@pytest.mark.gpu
@pytest.mark.parametrize("cache", ["float32", "int8"])
@pytest.mark.parametrize("quant", ["Q8_0", "Q4_0"])
def test_score_tokens_card_matches_cpu(cuda_device, quant, cache):
    """scripts/torch_perplexity.score_tokens of a tiny model (300 tokens,
    chunks of 128 and a 44-row tail) on the card against the CPU's plain
    versions, at phase 6's bound (chip_smoke.CUT_TOL of NLL per token),
    through B or F and C or G only."""
    from lmrs_tpu_torch.config import QuantType, tiny_llama
    from lmrs_tpu_torch.io.params import params_from_weights
    from lmrs_tpu_torch.io.synthetic import random_weights

    cs = _chip_smoke()
    sys.path.insert(0, str(cs.HERE / "scripts"))
    from torch_perplexity import score_tokens

    # head_dim 64 (a head dim the attention kernels are built for) and 4
    # query heads a kv head, as Llama-3.2-1B: every chunk, the tail's 44
    # rows too, has G * T > 64 rows a kv head, so no flash-decoding split
    cfg = tiny_llama(quant=QuantType[quant]).replace(
        n_heads=4, head_dim=64, n_kv_heads=1)
    weights = random_weights(cfg, seed=3)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, 300)
    got = {}
    for dev in ("cpu", "cuda"):
        params = params_from_weights(cfg, weights, device=dev)
        reset_launches()
        got[dev] = score_tokens(cfg, params, tokens, chunk=128,
                                cache_dtype=cache)["nll_per_token"]
    gemm = "q8_gemm" if quant == "Q8_0" else "q4_gemm"
    flash = "flash_attention" if cache == "float32" else "flash_attention_i8"
    assert {k for k, n in launches().items() if n > 0} == {gemm, flash}
    assert np.isfinite(got["cuda"])
    assert abs(got["cuda"] - got["cpu"]) <= cs.CUT_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("tp,cp", [(2, 1), (1, 2), (2, 2)])
def test_mesh_engine_on_card(cuda_device, tmp_path, tp, cp):
    """A tiny Llama Q8_0 (head_dim 64, a head dim the kernels are built
    for) on a mesh of rank processes sharing the card over gloo, a
    300-token prompt across cp's 256-row shard edge: greedy tokens equal
    to the one-device engine's up to the first step whose top-2 margin is
    below 1e-2 of the logit scale, teacher-forced logits within 1e-2 of
    it (`tests/torch_mesh_cases.py`: W8A8 rounding steps and cp's
    shard-max softmax rounding); the kernels summed over the ranks: tp
    D, E, F, C, M; cp D, E, F, I and B1 (on every rank), M and no C."""
    from lmrs_tpu_torch.config import QuantType, tiny_llama
    from lmrs_tpu_torch.io.lmrs import read_lmrs, write_lmrs
    from lmrs_tpu_torch.io.params import params_from_lmrs
    from lmrs_tpu_torch.io.synthetic import random_weights
    from lmrs_tpu_torch.parallel.tp import make_mesh_engine
    from lmrs_tpu_torch.runtime.engine import Engine
    from torch_mesh_cases import (ROUNDING_TOL, agree_until_tie,
                                  assert_close, greedy, teacher_logits)

    cfg = tiny_llama(quant=QuantType.Q8_0).replace(n_heads=4, head_dim=64,
                                                    n_kv_heads=2)
    path = str(tmp_path / "m.lmrs")
    write_lmrs(path, cfg, random_weights(cfg, 4, 0.1))
    f = read_lmrs(path)
    prompt = [int(t) for t in np.random.default_rng(1).integers(3, 2000, 300)]
    one = Engine(f.cfg, params_from_lmrs(f, "cuda"), prefill_chunk=64)
    want = greedy(one, prompt, 12)
    eng = make_mesh_engine(f, tp=tp, cp=cp, prefill_chunk=64)
    try:
        eng.mesh.reset_stats()
        got = greedy(eng, prompt, 12)
        per_rank = eng.mesh.stats()["launches"]
        mine = teacher_logits(eng, prompt, want)
    finally:
        eng.mesh.shutdown()
    ref = teacher_logits(one, prompt, want)
    assert_close(mine, ref, ROUNDING_TOL)
    agree_until_tie(got, want, ref, ROUNDING_TOL)
    total = {k for r in per_rank for k, n in r.items() if n}
    if cp == 1:
        assert total == {"q8_gemv_i8", "q8_gemv", "q8_gemm",
                         "flash_attention", "flash_merge"}
    else:
        assert total == {"q8_gemv_i8", "q8_gemv", "q8_gemm",
                         "flash_attention_batched",
                         "flash_attention_batched_lse", "flash_merge"}
        assert all(r["flash_attention_batched_lse"] for r in per_rank)
