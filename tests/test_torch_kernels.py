"""The plain versions of the port's kernels A (q4_gemv), B (q4_gemm) and C
(flash_attention) against the JAX functions that reach the TPU kernels
they replace, run in interpret mode on the CPU as the JAX tests run them.
A CPU tensor takes the plain version; the kernels themselves run only on
the card (chip_smoke.py holds each kernel against its plain version there,
as do the `gpu` tests of tests/test_torch_cuda.py).

Tolerances, stated at each assert:
- A: the JAX stacked kernel rounds x to bf16, so A's plain version gets
  bf16-representable x and both compute the same exact products; they
  differ only in the f32 summation order: 1e-5 relative to the output
  scale.  The K-major VPU matvec takes f32 x as A does: the same 1e-5.
- B: the same bf16 operands and W_deq rounding on both sides, f32 sums in
  another order: 1e-5 of the output scale.
- C vs flash_decode_stacked: the TPU kernel rounds the unnormalized
  softmax weights to bf16 block by block, the plain version the normalized
  ones: 2e-3 relative/absolute, the bf16-operand tolerance of
  tests/test_kernels.py.  C vs ops.attention.attention(precision="fast"):
  the same function over the same rows, 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.kernels.dequant_matmul import qmatmul_pallas_stacked
from lmrs_tpu.kernels.flash_attention import flash_decode_stacked
from lmrs_tpu.kernels.vpu_matvec import qmatmul_kmajor, to_kmajor
from lmrs_tpu.ops.attention import attention as jax_attention
from lmrs_tpu.quant import QuantType as JQuantType
from lmrs_tpu.quant import qtensor_from_float_np

from lmrs_tpu_torch.kernels import launches, reset_launches
from lmrs_tpu_torch.kernels.flash_attention import flash_attention
from lmrs_tpu_torch.kernels.q4_gemm import q4_gemm
from lmrs_tpu_torch.kernels.q4_gemv import q4_gemv

RNG = np.random.default_rng(0)
GS = 128


def _weights(o, k, layers=2):
    w = RNG.normal(0, 0.1, (layers, o, k)).astype(np.float32)
    return qtensor_from_float_np(w, JQuantType.Q4_0, GS)


def _bf16_exact(x):
    """x rounded to bf16 and back: operands both sides see exactly."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _port(qt, layer):
    return (torch.from_numpy(np.array(qt.q[layer])),
            torch.from_numpy(np.array(qt.s[layer])))


def _assert_close_scaled(got, want, rel):
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("t", [1, 3])
def test_gemv_plain_matches_stacked_xe_kernel(t):
    o, k = 384, 512
    qt = _weights(o, k)
    x = _bf16_exact(RNG.normal(0, 1, (t, k)).astype(np.float32))
    want = np.asarray(qmatmul_pallas_stacked(jnp.asarray(x), qt, 1,
                                             interpret=True))
    reset_launches()
    got = q4_gemv(torch.from_numpy(x), *_port(qt, 1), GS).numpy()
    assert launches()["q4_gemv"] == 0       # CPU tensors: the plain version
    _assert_close_scaled(got, want, 1e-5)   # f32 summation order only


def test_gemv_plain_matches_kmajor_vpu_kernel():
    o, k = 512, 1024
    qt = _weights(o, k, layers=1)
    x = RNG.normal(0, 1, (1, k)).astype(np.float32)      # f32 activations
    want = np.asarray(qmatmul_kmajor(jnp.asarray(x), to_kmajor(qt), 0,
                                     interpret=True))
    got = q4_gemv(torch.from_numpy(x), *_port(qt, 0), GS).numpy()
    _assert_close_scaled(got, want, 1e-5)   # f32 summation order only


@pytest.mark.parametrize("t", [9, 16])
def test_gemm_plain_matches_stacked_se_kernel(t):
    o, k = 256, 512
    qt = _weights(o, k)
    x = RNG.normal(0, 1, (t, k)).astype(np.float32)
    want = np.asarray(qmatmul_pallas_stacked(jnp.asarray(x), qt, 0,
                                             interpret=True))
    got = q4_gemm(torch.from_numpy(x), *_port(qt, 0), GS).numpy()
    _assert_close_scaled(got, want, 1e-5)   # same bf16 operands


def _cache(L, S, KH, HD):
    k = RNG.normal(0, 1, (L, S, KH * HD)).astype(np.float32)
    v = RNG.normal(0, 1, (L, S, KH * HD)).astype(np.float32)
    kj = jnp.asarray(k).astype(jnp.bfloat16)
    vj = jnp.asarray(v).astype(jnp.bfloat16)
    kt = torch.from_numpy(k).to(torch.bfloat16)
    vt = torch.from_numpy(v).to(torch.bfloat16)
    return kj, vj, kt, vt


@pytest.mark.parametrize("t_q,pos", [(1, 37), (1, 300), (16, 290)])
def test_flash_plain_matches_flash_decode_stacked(t_q, pos):
    """pos 300 > window 200 with 128-row blocks: the TPU kernel skips
    whole blocks before the window start."""
    L, S, KH, G, HD = 2, 512, 2, 2, 128
    window, softcap = 200, 50.0
    kj, vj, kt, vt = _cache(L, S, KH, HD)
    q = RNG.normal(0, 1, (t_q, KH * G, HD)).astype(np.float32)
    want = np.asarray(flash_decode_stacked(
        jnp.asarray(q), kj, vj, jnp.int32(1), jnp.int32(pos), n_kv=KH,
        attn_len=S, scale=HD ** -0.5, softcap=softcap, window=window,
        s_blk=128, interpret=True))
    got = flash_attention(torch.from_numpy(q), kt, vt, 1, pos, n_kv=KH,
                          scale=HD ** -0.5, softcap=softcap,
                          window=window).numpy()
    # bf16 rounding of block-wise unnormalized vs normalized weights
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("softcap,window", [(None, None), (50.0, 64)])
def test_flash_plain_matches_attention_sweep(softcap, window):
    L, S, KH, G, HD = 2, 256, 2, 3, 64
    kj, vj, kt, vt = _cache(L, S, KH, HD)
    for t_q in (1, 5):
        q = RNG.normal(0, 1, (t_q, KH * G, HD)).astype(np.float32)
        for pos in (0, 1, 63, 64, 100, 200, S - t_q):
            want = np.asarray(jax_attention(
                jnp.asarray(q), kj[0].reshape(S, KH, HD),
                vj[0].reshape(S, KH, HD), jnp.int32(pos), scale=0.125,
                softcap=softcap, window=window, precision="fast"))
            got = flash_attention(torch.from_numpy(q), kt, vt, 0, pos,
                                  n_kv=KH, scale=0.125, softcap=softcap,
                                  window=window).numpy()
            # the same function over the same live rows
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
