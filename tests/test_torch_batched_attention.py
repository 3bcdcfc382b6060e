"""Kernels I and J's plain versions against the JAX package on the CPU:
`flash_attention_batched` (per-slot cache) against
`lmrs_tpu.kernels.flash_attention.flash_decode_batched`, and
`flash_attention_paged` (page pool) against `flash_decode_paged`, both JAX
functions in interpret mode, as tests/test_flash_attention.py runs them.
B = 3 slots at ragged positions (0 included), t_q 1 and 5, Gemma's window
and softcap, every cache type (int4 in both packings, paged only), pages
of 64 and 16 rows, garbage in the rows past each slot's last live one and
in the trash page.

Tolerances, stated at each assert:
- against JAX: per element within the plain version's bound
  (`flash_attention_batched_tol` / `flash_attention_paged_tol`,
  (2^-7 + 2^-9) times the plain version on |v|): the TPU kernel rounds its
  block-wise unnormalized softmax weights to bf16, the plain version the
  normalized ones, as for kernels C, G and H.
- slot independence, and the pool against the per-slot cache holding the
  same rows: bit for bit (the same operations on the same values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.kernels.flash_attention import (flash_decode_batched,
                                              flash_decode_paged)

from lmrs_tpu_torch.kernels import launches, reset_launches
from lmrs_tpu_torch.kernels.flash_attention_batched import (
    flash_attention_batched, flash_attention_batched_tol)
from lmrs_tpu_torch.kernels.flash_attention_paged import (
    flash_attention_paged, flash_attention_paged_tol)
from torch_batched_cases import make_case, spoil

# tiny inputs gain nothing from intra-op threads, and several test
# processes side by side, each with a thread per core, slow one another
torch.set_num_threads(1)

S_LEN = 128
WINDOW = 64


def _np(a):
    if a is None:
        return None
    if a.dtype == torch.bfloat16:     # numpy has no bfloat16
        return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(a.numpy())


def _case(cache, kh, hd, t_q, psz, window):
    # slot 2 sits past the window, slot 0 at 0
    pos = [0, 70, S_LEN - t_q - 3]
    case = make_case("cpu", b=3, n_layers=2, s_len=S_LEN, kh=kh, hd=hd,
                     cache=cache, psz=psz, pos=pos, t_q=t_q,
                     seed=kh * 1000 + hd + t_q + psz)
    kw = dict(n_kv=kh, scale=hd ** -0.5, softcap=50.0 if window else None,
              window=window)
    return case, kw


def _q4d(case, t_q):
    q = case["q"].numpy()
    return jnp.asarray(q if t_q > 1 else q[:, 0])


@pytest.mark.parametrize("cache", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("t_q", [1, 5])
@pytest.mark.parametrize("window", [WINDOW, None])
def test_batched_plain_matches_flash_decode_batched(cache, t_q, window):
    kh, hd = 2, 128
    case, kw = _case(cache, kh, hd, t_q, 64, window)
    k, v, ks, vs = case["contig"]
    want = np.asarray(flash_decode_batched(
        _q4d(case, t_q), _np(k), _np(v), jnp.int32(1),
        jnp.asarray(case["pos"].numpy()), attn_len=S_LEN, s_blk=64,
        interpret=True, k_scale=_np(ks), v_scale=_np(vs), **kw))
    if t_q == 1:
        want = want[:, None]
    reset_launches()
    got = flash_attention_batched(case["q"], k, v, 1, case["pos"],
                                  k_scale=ks, v_scale=vs, **kw)
    assert launches()["flash_attention_batched"] == 0   # CPU: plain version
    tol = flash_attention_batched_tol(case["q"], k, v, 1, case["pos"],
                                      k_scale=ks, v_scale=vs, **kw).numpy()
    # per element within the plain version's bound (module note)
    assert (np.abs(got.numpy() - want) <= tol).all()


@pytest.mark.parametrize("cache,kh,hd", [("bf16", 2, 128), ("f32", 2, 128),
                                         ("int8", 2, 128),
                                         ("int4", 2, 256),    # half
                                         ("int4", 2, 128)])   # pair
@pytest.mark.parametrize("t_q", [1, 5])
@pytest.mark.parametrize("psz", [64, 16])
def test_paged_plain_matches_flash_decode_paged(cache, kh, hd, t_q, psz):
    case, kw = _case(cache, kh, hd, t_q, psz, WINDOW)
    kp, vp, table, ks, vs = case["paged"]
    want = np.asarray(flash_decode_paged(
        _q4d(case, t_q), _np(kp), _np(vp), _np(table), jnp.int32(1),
        jnp.asarray(case["pos"].numpy()), interpret=True, k_scale=_np(ks),
        v_scale=_np(vs), packed4=cache == "int4", **kw))
    if t_q == 1:
        want = want[:, None]
    reset_launches()
    got = flash_attention_paged(case["q"], kp, vp, table, 1, case["pos"],
                                k_scale=ks, v_scale=vs, **kw)
    assert launches()["flash_attention_paged"] == 0
    tol = flash_attention_paged_tol(case["q"], kp, vp, table, 1, case["pos"],
                                    k_scale=ks, v_scale=vs, **kw).numpy()
    # per element within the plain version's bound (module note)
    assert (np.abs(got.numpy() - want) <= tol).all()
    if cache != "int4":
        # the pool holds the per-slot cache's rows: bit for bit kernel I
        k, v, cks, cvs = case["contig"]
        same = flash_attention_batched(case["q"], k, v, 1, case["pos"],
                                       k_scale=cks, v_scale=cvs, **kw)
        assert torch.equal(got, same)


@pytest.mark.parametrize("t_q", [1, 5])
def test_batched_einsum_attention_matches_jax(t_q):
    """ops.attention.attention_batched[_multi], the plain versions' core,
    against the JAX einsum ops on finite rows (1e-5 of the output scale:
    the same bf16 roundings, f32 sums in another order)."""
    from lmrs_tpu.ops.attention import attention_batched as jax_ab
    from lmrs_tpu.ops.attention import attention_batched_multi as jax_abm

    from lmrs_tpu_torch.ops.attention import (attention_batched,
                                              attention_batched_multi)

    rng = np.random.default_rng(t_q)
    b, s, kh, g, hd = 3, 96, 2, 2, 64
    q = rng.standard_normal((b, t_q, kh * g, hd), dtype=np.float32)
    k, v = (rng.standard_normal((b, s, kh, hd), dtype=np.float32)
            for _ in range(2))
    pos = np.array([0, 40, s - t_q], np.int32)
    kw = dict(scale=hd ** -0.5, softcap=30.0, window=32, precision="fast")
    tq, tk, tv, tp = (torch.from_numpy(a) for a in (q, k, v, pos))
    if t_q == 1:
        want = np.asarray(jax_ab(jnp.asarray(q[:, 0]), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(pos), **kw))
        got = attention_batched(tq[:, 0], tk, tv, tp, **kw).numpy()
    else:
        want = np.asarray(jax_abm(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(pos), **kw))
        got = attention_batched_multi(tq, tk, tv, tp, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
def test_slot_independence(cache):
    """Slot 1's result is bit for bit unchanged when every other slot, the
    other slots' pages and the trash page hold NaN (int caches: garbage
    bytes and NaN scales)."""
    case, kw = _case(cache, 2, 128, 5, 16, WINDOW)
    (k, v, ks, vs), paged = spoil(case, 1)
    kp, vp, table, pks, pvs = case["paged"]
    ref = flash_attention_paged(case["q"], kp, vp, table, 1, case["pos"],
                                k_scale=pks, v_scale=pvs, **kw)
    bad = flash_attention_paged(case["q"], paged[0], paged[1], paged[2], 1,
                                case["pos"], k_scale=paged[3],
                                v_scale=paged[4], **kw)
    assert torch.equal(bad[1], ref[1])
    assert torch.isnan(bad[0]).any() or cache != "bf16"
    if cache != "int4":
        got = flash_attention_batched(case["q"], k, v, 1, case["pos"],
                                      k_scale=ks, v_scale=vs, **kw)
        assert torch.equal(got[1], ref[1])
