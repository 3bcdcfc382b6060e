"""The port's batched forward (`models.transformer.forward_batched`, CPU:
the kernels' plain versions) against the JAX `forward_batched` on the same
carried-across parameters (params_from_jax), over a per-slot cache and
over a page pool, one decode step (t_q = 1) and one speculative verify
window (t_q = k + 1 = 4) of B = 3 slots at ragged positions.  Models: a
tiny Gemma Q4_0 (tiny-flash, head_dim 128) and a tiny Llama Q8_0 with
head_dim 128 (the JAX paged pool needs a head_dim that is a multiple of
128).  The caches start from the same random rows (tests/
torch_batched_cases.py), garbage past each slot's last live row and in
the pool's trash page.

Tolerances, stated at each assert:
- logits: 1e-2 of the logit scale + 1e-4, as tests/test_torch_transformer
  .py (the JAX stacked kernels round activations to bf16 at T <= 8 where
  kernel A keeps f32; bf16 K/V and softmax roundings add the rest); for Q8
  at T <= 8 (W8A8) plus twice the port's own W8A8-vs-W8A16 difference on
  the same step, as tests/test_torch_q8_model.py; for the int4 pool plus a
  tenth of the int4 cache's own effect on the step (the port on the same
  rows in bf16), as tests/test_torch_int4_model.py: the row quantizer's
  steps are 1/7 of a row's largest value, and the new rows' last-bit
  differences flip a few nibbles.
- the cache writes: bit for bit, every row that neither package wrote is
  unchanged, and the rows that changed are the same rows in both (each
  slot's t_q rows at its position, through its page table when paged).
  The written values themselves agree up to the hidden states' difference:
  layer 0's (whose input is the exact embedding) to 1e-2 of the row scale
  (float caches) or one quantization step in at most 2% of the values
  (integer caches, scales 1e-3), as the single-stream model tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lmrs_tpu.io.lmrs as jl
from lmrs_tpu.config import ModelType as JModelType
from lmrs_tpu.io.params import params_from_lmrs as jax_params_from_lmrs
from lmrs_tpu.io.synthetic import random_weights as jax_random_weights
from lmrs_tpu.io.synthetic import tiny_config as jax_tiny_config
from lmrs_tpu.models.transformer import KVCache as JKVCache
from lmrs_tpu.models.transformer import embed_tokens as jax_embed
from lmrs_tpu.models.transformer import forward_batched as jax_forward_b
from lmrs_tpu.quant import QuantType as JQuantType

import lmrs_tpu_torch.io.lmrs as tl
from lmrs_tpu_torch.io.params import params_from_jax
from lmrs_tpu_torch.kernels import launches, reset_launches
from lmrs_tpu_torch.models.transformer import (KVCache, embed_tokens,
                                               forward_batched)
from test_torch_io import jax_param_arrays
from torch_batched_cases import make_case

torch.set_num_threads(1)

S_LEN = 64
PSZ = 16
# ragged, not 0: a slot at 0 attends to its one new row, whose output is
# that row's value, and for the int4 cache a nibble that the two packages'
# last-bit differences flip shows there whole (pos 0 is held in
# tests/test_torch_batched_attention.py, on the same rows both sides)
POS = [5, 13, 40]

MODELS = {
    "gemma-q4": (JModelType.GEMMA, JQuantType.Q4_0),
    "llama-q8": (JModelType.LLAMA, JQuantType.Q8_0),
}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """name -> (JAX cfg, JAX params, port cfg, port params)."""
    out = {}
    d = tmp_path_factory.mktemp("fb")
    for name, (mt, quant) in MODELS.items():
        jcfg = jax_tiny_config(mt, quant, dim=256, hidden_dim=512,
                               n_layers=2, n_heads=4, n_kv_heads=2,
                               head_dim=128, vocab_size=512, seq_len=128,
                               group_size=32)
        path = str(d / f"{name}.lmrs")
        jl.write_lmrs(path, jcfg, jax_random_weights(jcfg, 1, 0.02))
        jf = jl.read_lmrs(path)
        jcfg = jf.cfg.replace(matmul_impl="fast")
        jp = jax_params_from_lmrs(jf, stack_layers=True, fuse_qkv=True)
        tcfg = tl.read_lmrs(path).cfg
        tp = params_from_jax(tcfg, jax_param_arrays(jp), device="cpu")
        out[name] = (jcfg, jp, tcfg, tp)
    return out


def _jnp(a):
    if a is None:
        return None
    if a.dtype == torch.bfloat16:
        return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(a.numpy())


def _np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype != np.int8 else a


# the int4 cache is paged only
@pytest.mark.parametrize("t_q", [1, 4])
@pytest.mark.parametrize("name,cache,paged", [
    ("gemma-q4", "bf16", False), ("gemma-q4", "bf16", True),
    ("gemma-q4", "int4", True),
    ("llama-q8", "int8", False), ("llama-q8", "int8", True),
    ("llama-q8", "f32", False), ("llama-q8", "f32", True)])
def test_forward_batched_matches_jax(pairs, name, cache, paged, t_q):
    jcfg, jp, tcfg, tp = pairs[name]
    case = make_case("cpu", b=3, n_layers=tcfg.n_layers, s_len=S_LEN,
                     kh=tcfg.n_kv_heads, hd=tcfg.cache_head_dim, cache=cache,
                     psz=PSZ, pos=POS, t_q=t_q, seed=7)
    if paged:
        k, v, table, ks, vs = case["paged"]
    else:
        (k, v, ks, vs), table = case["contig"], None
    before = [a.clone() for a in (k, v)]
    tcache = KVCache(k.clone(), v.clone(),
                     None if ks is None else ks.clone(),
                     None if vs is None else vs.clone())
    jcache = JKVCache(_jnp(k), _jnp(v), _jnp(ks), _jnp(vs))
    toks = np.random.default_rng(t_q).integers(0, tcfg.vocab_size,
                                               3 * t_q).astype(np.int32)
    pos = case["pos"]
    x = embed_tokens(tp, tcfg, torch.from_numpy(toks).long())
    jx = jax_embed(jp, jcfg, jnp.asarray(toks))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))   # exact
    want, jnew = jax_forward_b(jp, jcfg, jcache, jx,
                               jnp.asarray(pos.numpy()), S_LEN, t_q=t_q,
                               table=None if table is None else _jnp(table))
    want = np.asarray(want)
    reset_launches()
    got = forward_batched(tp, tcfg, tcache, x, pos, t_q=t_q, table=table)
    assert launches()["flash_attention_paged" if paged
                      else "flash_attention_batched"] == 0   # CPU: plain
    got = got.numpy()
    assert got.shape == want.shape == (3 * t_q, tcfg.vocab_size)
    tol = 1e-2 * np.abs(want).max() + 1e-4
    if name == "llama-q8" and 3 * t_q <= 8:
        # W8A8 at T <= 8: two runs draw the quantization noise anew (the
        # module note); the port's W8A8-vs-W8A16 difference measures it
        other = KVCache(k.clone(), v.clone(),
                        None if ks is None else ks.clone(),
                        None if vs is None else vs.clone())
        noise = forward_batched(tp, tcfg, other, x, pos, t_q=t_q,
                                table=table, w8a8=False).numpy()
        tol += 2 * np.abs(got - noise).max()
    if cache == "int4":
        bf = make_case("cpu", b=3, n_layers=tcfg.n_layers, s_len=S_LEN,
                       kh=tcfg.n_kv_heads, hd=tcfg.cache_head_dim,
                       cache="bf16", psz=PSZ, pos=POS, t_q=t_q, seed=7)
        bk, bv, btable, _, _ = bf["paged"]
        ref = forward_batched(tp, tcfg, KVCache(bk, bv), x, pos, t_q=t_q,
                              table=btable).numpy()
        tol += 0.1 * np.abs(got - ref).max()
    assert np.abs(got - want).max() <= tol

    # the writes: the same rows changed, the others untouched, bit for bit
    for mine, theirs, old in ((tcache.k, jnew.k, before[0]),
                              (tcache.v, jnew.v, before[1])):
        mine, theirs = _np(mine.float() if mine.dtype == torch.bfloat16
                           else mine), _np(theirs)
        old = _np(old.float() if old.dtype == torch.bfloat16 else old)
        changed_mine = (mine != old).any(axis=-1)
        changed_theirs = (theirs != old).any(axis=-1)
        np.testing.assert_array_equal(changed_mine, changed_theirs)
        np.testing.assert_array_equal(mine[~changed_mine],
                                      theirs[~changed_mine])
        l0 = (slice(None), 0) if not paged else (0,)
        d = np.abs(mine[l0].astype(np.float32)
                   - theirs[l0].astype(np.float32))
        if cache in ("bf16", "f32"):
            assert d.max() <= 1e-2 * np.abs(theirs[l0]).max()
        else:
            assert d.max() <= 1 if cache == "int8" else d.max() <= 255
            assert (d > 0).mean() < 0.02
    if ks is not None:
        ms, ts = tcache.k_scale.numpy(), np.asarray(jnew.k_scale)
        changed = ms != ks.numpy()
        np.testing.assert_array_equal(changed, ts != ks.numpy())
        l0 = (slice(None), 0) if not paged else (0,)
        np.testing.assert_allclose(ms[l0], ts[l0], rtol=1e-3)
