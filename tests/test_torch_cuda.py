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
the value scale in the weight's place); whole-model logits 1e-2 of the
logit scale (the per-kernel differences compound over layers).
"""

import numpy as np
import pytest
import torch

from lmrs_tpu_torch.kernels import launches, reset_launches
from lmrs_tpu_torch.kernels.flash_attention import (flash_attention,
                                                    flash_attention_plain,
                                                    flash_attention_tol)
from lmrs_tpu_torch.kernels.q4_gemm import q4_gemm, q4_gemm_plain
from lmrs_tpu_torch.kernels.flash_attention_i8 import (
    flash_attention_i8, flash_attention_i8_plain, flash_attention_i8_tol)
from lmrs_tpu_torch.kernels.q4_gemv import q4_gemv, q4_gemv_plain
from lmrs_tpu_torch.kernels.q8_gemm import q8_gemm, q8_gemm_plain
from lmrs_tpu_torch.kernels.q8_gemv import q8_gemv, q8_gemv_plain
from lmrs_tpu_torch.kernels.q8_gemv_i8 import (q8_act_quant, q8_gemv_i8,
                                               q8_gemv_i8_plain)
from lmrs_tpu_torch.quant import (q4_file_to_runtime_np, quantize_kv_rows,
                                  quantize_q8_act, quantize_q40_np,
                                  quantize_q80_np)


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


def _small_model_card_matches_cpu(tmp_path, family, quant, cache,
                                  w8a8=True):
    """A small model with kernel-legal widths (gs 128, head_dim 64 for
    Llama with 3 query heads per kv head, 128 for Gemma with a 48-row
    window) on the card against the same file on the CPU: prefill and
    decode logits, greedy tokens, and the kernels the path must launch."""
    from lmrs_tpu_torch.config import ModelConfig, ModelType, QuantType
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import params_from_lmrs
    from lmrs_tpu_torch.io.synthetic import write_synthetic_lmrs
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

    extra = (dict(sliding_window=48) if family == "gemma" else {})
    cache_dtype = getattr(torch, cache)
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
        eng = Engine(f.cfg, params_from_lmrs(f, device=dev), device=dev,
                     prefill_chunk=32, cache_dtype=cache_dtype, w8a8=w8a8)
        rows = [eng.prefill(prompt)]
        rows += [eng.decode_step(t) for t in (3, 4, 5)]
        logits[dev] = torch.stack([r.float().cpu() for r in rows])
    a, b = logits["cuda"], logits["cpu"]
    assert torch.isfinite(a).all()
    assert (a - b).abs().max().item() <= 1e-2 * b.abs().max().item() + 1e-4
    f = read_lmrs(path)
    eng = Engine(f.cfg, params_from_lmrs(f, device="cuda"),
                 cache_dtype=cache_dtype, w8a8=w8a8)
    reset_launches()
    toks = eng.generate(prompt, GenerationConfig(temperature=0.0,
                                                 max_new_tokens=8))
    assert len(toks) == 8 and all(0 <= t < cfg.vocab_size for t in toks)
    expect = {"Q4_0": {"q4_gemv", "q4_gemm"},
              "Q8_0": {"q8_gemv_i8", "q8_gemv", "q8_gemm"}}[quant]
    if not w8a8:
        expect.discard("q8_gemv_i8")    # the layers take kernel E too
    expect.add("flash_attention_i8" if cache == "int8"
               else "flash_attention")
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

