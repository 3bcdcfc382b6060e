"""The port's int8 KV cache against the JAX package on the CPU: the row
quantizer, and kernel G's plain version (flash_attention_i8 on CPU tensors)
against the JAX flash kernel with k_scale/v_scale in interpret mode.  Whole
models on the int8 cache: tests/test_torch_q8_model.py.

Tolerances, stated at each assert:
- quantize_kv_rows: bit for bit (the same f32 operations in the same order;
  round half to even on both sides).
- G vs flash_decode_stacked(k_scale=, v_scale=): the TPU kernel rounds the
  unnormalized softmax weight times the value scale to bf16 block by
  block, the plain version the normalized one: per element within
  flash_attention_i8_tol's bound, and 2e-3 relative/absolute, as kernel
  C's test, where hundreds of keys are live (with 38 live keys one weight
  dominates and its single rounding, up to 2^-8, shows in every output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.kernels.flash_attention import flash_decode_stacked
from lmrs_tpu.models.transformer import quantize_kv_rows as jax_quantize_kv

from lmrs_tpu_torch.kernels import launches, reset_launches
from lmrs_tpu_torch.kernels.flash_attention import flash_attention
from lmrs_tpu_torch.kernels.flash_attention_i8 import (flash_attention_i8,
                                                       flash_attention_i8_tol)
from lmrs_tpu_torch.quant import quantize_kv_rows

RNG = np.random.default_rng(0)


def test_quantize_kv_rows_bit_exact():
    x = (RNG.standard_normal((6, 3, 32)) * 4).astype(np.float32)
    x[1, 2] = 0.0                                   # all-zero row: scale 0
    # absmax 127 makes 127/absmax exactly 1: these are exact ties, which
    # round to even (0, 2, 2, -2, 64), not away from zero
    x[0, 0] = 0.0
    x[0, 0, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, 63.5]
    want_q, want_s = jax_quantize_kv(jnp.asarray(x))
    got_q, got_s = quantize_kv_rows(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_q.shape == (6, 96)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q[0, :6].tolist() == [127, 0, 2, 2, -2, 64]
    assert not got_q[1, 64:].any() and got_s[1, 2] == 0
    # K and V stacked quantize as each alone
    both_q, both_s = quantize_kv_rows(torch.from_numpy(np.stack([x, -x])))
    assert torch.equal(both_q[0], got_q) and torch.equal(both_s[1], got_s)


def _int8_cache(rng, L, S, KH, HD):
    """A random int8 cache: (k, v (L, S, KH*HD) int8, scales (L, KH, S))
    as numpy; rows of unit-normal values times a per-row factor in
    [0.25, 1] (no larger than the rows of kernel C's test, whose 2e-3 is
    reused below)."""
    out = []
    for _ in range(2):
        a = (rng.standard_normal((L * S, KH, HD))
             * rng.uniform(0.25, 1.0, (L * S, KH, 1))).astype(np.float32)
        q, s = quantize_kv_rows(torch.from_numpy(a))
        out.append((q.numpy().reshape(L, S, KH * HD),
                    np.ascontiguousarray(
                        s.numpy().reshape(L, S, KH).transpose(0, 2, 1))))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


@pytest.mark.parametrize("softcap,window", [(None, None), (50.0, 200)])
@pytest.mark.parametrize("t_q,pos", [(1, 37), (1, 300), (16, 290)])
def test_flash_i8_plain_matches_flash_decode_stacked(t_q, pos, softcap,
                                                     window):
    """pos 300 > window 200 with 128-row blocks: the TPU kernel skips whole
    blocks before the window start.  G = 3 query heads per kv head."""
    L, S, KH, G, HD = 2, 512, 2, 3, 128
    rng = np.random.default_rng(1000 * t_q + pos)   # whatever ran before
    k, v, ks, vs = _int8_cache(rng, L, S, KH, HD)
    q = rng.normal(0, 1, (t_q, KH * G, HD)).astype(np.float32)
    want = np.asarray(flash_decode_stacked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(1),
        jnp.int32(pos), n_kv=KH, attn_len=S, scale=HD ** -0.5,
        softcap=softcap, window=window, s_blk=128, interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    reset_launches()
    args = [torch.from_numpy(a) for a in (q, k, v, ks, vs)]
    got = flash_attention_i8(*args, 1, pos, n_kv=KH, scale=HD ** -0.5,
                             softcap=softcap, window=window).numpy()
    assert launches()["flash_attention_i8"] == 0    # CPU: the plain version
    # each side rounds its softmax weight times the value scale to bf16
    # (the TPU kernel the block-wise unnormalized one, the plain version the
    # normalized one): per element at most (2^-7 + 2^-9) sum_j w_j vs_j
    # |v_int_j|, whatever the number of live keys
    tol = flash_attention_i8_tol(*args, 1, pos, n_kv=KH, scale=HD ** -0.5,
                                 softcap=softcap, window=window).numpy()
    assert (np.abs(got - want) <= tol).all()
    if pos >= 200:
        # over hundreds of live keys the roundings average out: 2e-3
        # relative/absolute, as kernel C's test
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_flash_i8_plain_ignores_rows_past_the_last_live_one():
    """Stale rows and scales past pos + T (NaN scales included) add
    nothing, and the int8 result is the bf16 kernel's on the dequantized
    rows up to their bf16 rounding (1e-2 of the output scale: k_int * ks
    rounded to bf16 carries 2^-9 per element into the scores)."""
    L, S, KH, G, HD = 1, 128, 2, 2, 64
    rng = np.random.default_rng(5)
    k, v, ks, vs = (torch.from_numpy(a)
                    for a in _int8_cache(rng, L, S, KH, HD))
    q = torch.from_numpy(rng.normal(0, 1, (3, KH * G, HD)).astype(np.float32))
    pos = 40
    kw = dict(n_kv=KH, scale=HD ** -0.5, softcap=30.0, window=None)
    want = flash_attention_i8(q, k, v, ks, vs, 0, pos, **kw)
    k2, ks2, vs2 = k.clone(), ks.clone(), vs.clone()
    k2[:, pos + 3:] = 99
    ks2[:, :, pos + 3:] = float("nan")
    vs2[:, :, pos + 3:] = float("nan")
    assert torch.equal(flash_attention_i8(q, k2, v, ks2, vs2, 0, pos, **kw),
                       want)
    deq = [(a.reshape(L, S, KH, HD).float()
            * s.transpose(1, 2)[..., None]).reshape(L, S, KH * HD).to(
                torch.bfloat16) for a, s in ((k, ks), (v, vs))]
    ref = flash_attention(q, deq[0], deq[1], 0, pos, **kw)
    assert (want - ref).abs().max() <= 1e-2 * ref.abs().max()
