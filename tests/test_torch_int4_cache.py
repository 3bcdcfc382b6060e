"""The port's int4 and f32 KV caches against the JAX package on the CPU: the
nibble-packing row quantizer and its inverse, and kernel H's plain version
(flash_attention_i4 on CPU tensors) against the JAX flash kernel with
packed4=True in interpret mode, for both packings.  Whole models on the
int4 cache: tests/test_torch_int4_model.py.

Tolerances, stated at each assert:
- quantize_kv_rows_q4 / unpack_kv_q4: bit for bit (the same f32 operations
  in the same order; round half to even and the clip on both sides).
- H vs flash_decode_stacked(packed4=True): per element within
  flash_attention_i4_tol's bound (each side rounds its softmax weight times
  the value scale to bf16 once), and 2e-3 relative/absolute where hundreds
  of keys are live, as kernel G's test.
- An f32 cache against a bf16 cache holding the same rows rounded: bit for
  bit (the values are rounded to bf16 as they are read).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.kernels.flash_attention import flash_decode_stacked
from lmrs_tpu.models.transformer import q4_cache_pair_mode as jax_pair_mode
from lmrs_tpu.models.transformer import q4_cache_supported as jax_supported
from lmrs_tpu.models.transformer import quantize_kv_rows_q4 as jax_quantize_q4
from lmrs_tpu.models.transformer import unpack_kv_q4 as jax_unpack_q4

from lmrs_tpu_torch.kernels import launches, reset_launches
from lmrs_tpu_torch.kernels.flash_attention import flash_attention
from lmrs_tpu_torch.kernels.flash_attention_i4 import (flash_attention_i4,
                                                       flash_attention_i4_tol)
from lmrs_tpu_torch.quant import (q4_cache_pair_mode, q4_cache_supported,
                                  quantize_kv_rows_q4, unpack_kv_q4)

# tiny models gain nothing from intra-op threads, and several test
# processes side by side, each with a thread per core, slow one another
# tenfold
torch.set_num_threads(1)

# (kv heads, head dim): half packing, pair packing, odd-KH half packing
GEOMETRIES = [(2, 256), (2, 128), (3, 32)]


@pytest.mark.parametrize("kh,hd", GEOMETRIES + [(8, 64), (32, 128), (1, 128)])
def test_q4_cache_packing_choice_matches_jax(kh, hd):
    assert q4_cache_pair_mode(kh, hd) == jax_pair_mode(kh, hd)
    assert q4_cache_supported(kh, hd) == jax_supported(kh, hd)


@pytest.mark.parametrize("kh,hd", GEOMETRIES)
def test_quantize_kv_rows_q4_bit_exact(kh, hd):
    rng = np.random.default_rng(kh * 1000 + hd)
    x = (rng.standard_normal((7, kh, hd)) * 4).astype(np.float32)
    x[1, kh - 1] = 0.0                              # all-zero row: scale 0
    # absmax 7 makes 7/absmax exactly 1: these are exact ties, which round
    # to even (0, 2, 2, -2), and -6.5 rounds to -6
    x[0, 0] = 0.0
    x[0, 0, :6] = [7.0, 0.5, 1.5, 2.5, -2.5, -6.5]
    # |x| <= amax bounds every quotient by 7, so the clip to [-8, 7] never
    # moves a finite row's values: -7 stays -7 (the unpack test below
    # covers the -8 nibble)
    x[2, 0] = 0.0
    x[2, 0, :3] = [7.0, -7.0, -6.9999995]
    # zero lanes, as a padded head dim leaves them: they do not move the
    # scale and quantize to 0
    x[3, 0, hd - hd // 4:] = 0.0
    want_q, want_s = jax_quantize_q4(jnp.asarray(x))
    got_q, got_s = quantize_kv_rows_q4(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_q.shape == (7, kh * hd // 2)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # the inverse, against JAX's and against the planted values
    want_u = np.asarray(jax_unpack_q4(want_q, kh, hd))
    got_u = unpack_kv_q4(got_q, kh, hd)
    assert got_u.shape == (7, kh, hd) and got_u.dtype == torch.float32
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    assert got_u[0, 0, :6].tolist() == [7, 0, 2, 2, -2, -6]
    assert not got_u[1, kh - 1].any() and got_s[1, kh - 1] == 0
    assert not got_u[3, 0, hd - hd // 4:].any()
    assert got_u.min() >= -8 and got_u.max() <= 7
    # K and V stacked quantize as each alone
    both_q, both_s = quantize_kv_rows_q4(torch.from_numpy(np.stack([x, -x])))
    assert torch.equal(both_q[0], got_q) and torch.equal(both_s[1], got_s)


@pytest.mark.parametrize("kh,hd", GEOMETRIES)
def test_unpack_kv_q4_covers_the_whole_byte_range(kh, hd):
    """Every int8 byte, -128 (q_hi = q_lo = -8) and 127 included, unpacks
    as the JAX function unpacks it."""
    n = kh * hd // 2
    vals = np.resize(np.arange(-128, 128, dtype=np.int8), (3, n))
    want = np.asarray(jax_unpack_q4(jnp.asarray(vals), kh, hd))
    got = unpack_kv_q4(torch.from_numpy(vals), kh, hd).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() == -8 and got.max() == 7


def _int4_cache(rng, L, S, KH, HD):
    """A random int4 cache: (k, v (L, S, KH*HD/2) int8 bytes, scales (L,
    KH, S)) as numpy; rows of unit-normal values times a per-row factor in
    [0.25, 1], as the int8 cache's test."""
    out = []
    for _ in range(2):
        a = (rng.standard_normal((L * S, KH, HD))
             * rng.uniform(0.25, 1.0, (L * S, KH, 1))).astype(np.float32)
        q, s = quantize_kv_rows_q4(torch.from_numpy(a))
        out.append((q.numpy().reshape(L, S, KH * HD // 2),
                    np.ascontiguousarray(
                        s.numpy().reshape(L, S, KH).transpose(0, 2, 1))))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


@pytest.mark.parametrize("softcap,window", [(None, None), (50.0, 200)])
@pytest.mark.parametrize("t_q,pos", [(1, 37), (1, 300), (5, 290), (16, 290)])
@pytest.mark.parametrize("hd", [256, 128], ids=["half", "pair"])
def test_flash_i4_plain_matches_flash_decode_stacked(hd, t_q, pos, softcap,
                                                     window):
    """pos 300 > window 200 with 128-row blocks: the TPU kernel skips whole
    blocks before the window start.  G = 3 query heads per kv head; t_q 5
    is a speculative verify window."""
    L, S, KH, G = 2, 512, 2, 3
    rng = np.random.default_rng(1000 * t_q + pos + hd)
    k, v, ks, vs = _int4_cache(rng, L, S, KH, hd)
    q = rng.normal(0, 1, (t_q, KH * G, hd)).astype(np.float32)
    want = np.asarray(flash_decode_stacked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(1),
        jnp.int32(pos), n_kv=KH, attn_len=S, scale=hd ** -0.5,
        softcap=softcap, window=window, s_blk=128, interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), packed4=True))
    reset_launches()
    args = [torch.from_numpy(a) for a in (q, k, v, ks, vs)]
    kw = dict(n_kv=KH, scale=hd ** -0.5, softcap=softcap, window=window)
    got = flash_attention_i4(*args, 1, pos, **kw).numpy()
    assert launches()["flash_attention_i4"] == 0    # CPU: the plain version
    # each side rounds its softmax weight times the value scale to bf16
    # once: per element at most (2^-7 + 2^-9) sum_j w_j vs_j |v_int_j|
    tol = flash_attention_i4_tol(*args, 1, pos, **kw).numpy()
    assert (np.abs(got - want) <= tol).all()
    if pos >= 200:
        # over hundreds of live keys the roundings average out: 2e-3
        # relative/absolute, as kernel G's test
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("kh,hd", [(2, 64), (3, 64), (2, 256)])
def test_flash_i4_plain_ignores_rows_past_the_last_live_one(kh, hd):
    """Stale rows, bytes and scales past pos + T (NaN scales included) add
    nothing, and the int4 result is the bf16 kernel's on the dequantized
    rows up to their bf16 rounding (1e-2 of the output scale, as the int8
    cache's test)."""
    L, S, G = 1, 128, 2
    rng = np.random.default_rng(5)
    k, v, ks, vs = (torch.from_numpy(a)
                    for a in _int4_cache(rng, L, S, kh, hd))
    q = torch.from_numpy(rng.normal(0, 1, (3, kh * G, hd)).astype(np.float32))
    pos = 40
    kw = dict(n_kv=kh, scale=hd ** -0.5, softcap=30.0, window=None)
    want = flash_attention_i4(q, k, v, ks, vs, 0, pos, **kw)
    k2, v2, ks2, vs2 = k.clone(), v.clone(), ks.clone(), vs.clone()
    k2[:, pos + 3:] = -128
    v2[:, pos + 3:] = 0x77
    ks2[:, :, pos + 3:] = float("nan")
    vs2[:, :, pos + 3:] = float("nan")
    assert torch.equal(flash_attention_i4(q, k2, v2, ks2, vs2, 0, pos, **kw),
                       want)
    deq = [(unpack_kv_q4(a, kh, hd) * s.transpose(1, 2)[..., None]).reshape(
        L, S, kh * hd).to(torch.bfloat16) for a, s in ((k, ks), (v, vs))]
    ref = flash_attention(q, deq[0], deq[1], 0, pos, **kw)
    assert (want - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.parametrize("t_q,pos", [(1, 37), (5, 90)])
def test_f32_cache_gives_the_bf16_cache_result(t_q, pos):
    """The flash kernel rounds an f32 tile to bf16 on load, and so does the
    plain version: an f32 cache and the bf16 cache of the same rows agree
    bit for bit."""
    L, S, KH, G, HD = 2, 128, 2, 2, 64
    rng = np.random.default_rng(pos)
    k, v = (torch.from_numpy(rng.standard_normal((L, S, KH * HD)).astype(
        np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.normal(0, 1, (t_q, KH * G, HD)).astype(
        np.float32))
    kw = dict(n_kv=KH, scale=HD ** -0.5, softcap=50.0, window=64)
    a = flash_attention(q, k, v, 1, pos, **kw)
    b = flash_attention(q, k.to(torch.bfloat16), v.to(torch.bfloat16), 1, pos,
                        **kw)
    assert torch.equal(a, b)
