"""Teacher-forced logits of the port's forward (CPU, the kernels' plain
versions) against the JAX forward with matmul_impl="fast", both on the
same carried-across parameters (params_from_jax): one prefill chunk, then
decode steps on fixed tokens.  Gemma runs tiny-flash, whose head_dim 128
takes the JAX flash-attention kernel (interpret mode); Llama and a tiny Phi
with head_dim 48 (padded to a 128 cache head) take the JAX einsum.

Tolerance: max |logit difference| <= 1e-2 * max |logit| + 1e-4.  At
T <= 8 the JAX stacked kernels round activations to bf16 (relative 2^-9 a
product) where kernel A keeps them f32, and that difference runs through
every layer and the classifier; bf16 K/V and softmax-weight rounding adds
the rest.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lmrs_tpu.io.lmrs as jl
from lmrs_tpu.config import PRESETS as JAX_PRESETS
from lmrs_tpu.config import ModelType as JModelType
from lmrs_tpu.io.params import params_from_lmrs as jax_params_from_lmrs
from lmrs_tpu.io.synthetic import random_weights as jax_random_weights
from lmrs_tpu.io.synthetic import tiny_config as jax_tiny_config
from lmrs_tpu.models.transformer import init_kv_cache as jax_init_kv_cache
from lmrs_tpu.quant import QuantType as JQuantType
from lmrs_tpu.runtime.engine import _compiled_fns

import lmrs_tpu_torch.io.lmrs as tl
from lmrs_tpu_torch.io.params import params_from_jax
from lmrs_tpu_torch.models.transformer import (embed_tokens, forward,
                                               init_kv_cache)
from test_torch_io import jax_param_arrays

PHI_HD = 48


def jax_config(name, quant=JQuantType.Q4_0):
    if name == "tiny-phi":
        return jax_tiny_config(
            JModelType.PHI, quant, head_dim=PHI_HD, seq_len=256,
            rope_short_factor=tuple(1.0 + 0.05 * i
                                    for i in range(PHI_HD // 2)))
    return JAX_PRESETS[name](quant=quant)


def build_pair(tmp_path, name, seed=1, scale=0.02, quant=JQuantType.Q4_0,
               **cfg_kw):
    """(JAX cfg, JAX params, port cfg, port params) of one random .lmrs
    file (weights of std `scale`); the port's params are carried across
    from the JAX ones.  A config with fuse_ffn=True loads the JAX params
    with fuse_ffn too (Q4 w13 rows in its fused kernel's order)."""
    jcfg = jax_config(name, quant)
    path = str(tmp_path / f"{name}.lmrs")
    jl.write_lmrs(path, jcfg, jax_random_weights(jcfg, seed, scale))
    jf = jl.read_lmrs(path)
    jcfg = jf.cfg.replace(matmul_impl="fast", **cfg_kw)
    jp = jax_params_from_lmrs(jf, stack_layers=True, fuse_qkv=True,
                              fuse_ffn=cfg_kw.get("fuse_ffn", False))
    tcfg = tl.read_lmrs(path).cfg.replace(**cfg_kw)
    tp = params_from_jax(tcfg, jax_param_arrays(jp), device="cpu")
    return jcfg, jp, tcfg, tp


# Gemma's final softcap 30 hardly bends the small logits of a random tiny
# model; a cap of 0.5 makes the parity flag visible in both packages
@pytest.mark.parametrize("name,cfg_kw", [
    ("tiny-flash", {}),
    ("tiny-flash", dict(final_logit_softcap=0.5)),
    ("tiny-flash", dict(final_logit_softcap=0.5,
                        parity_gemma_softcap_bug=True)),
    ("tiny-llama", {}), ("tiny-phi", {})])
def test_forward_logits_match_jax(tmp_path, monkeypatch, name, cfg_kw):
    # the JAX flash kernel for every attention length (the suite's default
    # pins the einsum); only a head_dim-128 config is eligible
    monkeypatch.setenv("LMRS_FLASH_MIN_BUCKET", "256")
    jcfg, jp, tcfg, tp = build_pair(tmp_path, name, **cfg_kw)
    if name == "tiny-phi":
        assert tcfg.cache_head_dim == 128 != tcfg.head_dim
    embed, step, _ = _compiled_fns(jcfg)
    jcache = jax_init_kv_cache(jcfg, jnp.bfloat16)
    tcache = init_kv_cache(tcfg, "cpu")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, 24)
    pos = 0
    for chunk in (toks[:19], toks[19:20], toks[20:21], toks[21:22],
                  toks[22:23], toks[23:24]):
        x = embed(jp, tokens=jnp.asarray(chunk, jnp.int32))
        want, jcache = step(jp, jcache, x, jnp.int32(pos),
                            jnp.int32(len(chunk) - 1), attn_len=tcfg.seq_len)
        want = np.asarray(want)
        tx = embed_tokens(tp, tcfg, torch.from_numpy(chunk))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(x))  # exact
        got = forward(tp, tcfg, tcache, tx, pos, len(chunk) - 1).numpy()
        err = np.abs(got - want).max()
        # a capped logit's error is at most its uncapped error; this
        # model's uncapped logits reach ~1.3, past twice the 0.5 test cap
        scale = np.abs(want).max()
        if cfg_kw.get("final_logit_softcap") is not None:
            scale = max(scale, 2 * cfg_kw["final_logit_softcap"])
        assert err <= 1e-2 * scale + 1e-4, (pos, err)
        pos += len(chunk)
    cap = cfg_kw.get("final_logit_softcap")
    if cap is not None:
        assert np.abs(got[:tcfg.dim]).max() <= cap
        # with the lm.rs bug only the first `dim` logits are capped
        assert (np.abs(got[tcfg.dim:]).max() > cap) == \
            tcfg.parity_gemma_softcap_bug


def test_forward_refuses_a_batch(tmp_path):
    _, _, tcfg, tp = build_pair(tmp_path, "tiny-llama")
    with pytest.raises(ValueError, match="forward_batched"):
        forward(tp, tcfg, init_kv_cache(tcfg, "cpu"),
                torch.zeros(2, 3, tcfg.dim), 0, 0)
    f32 = init_kv_cache(tcfg, "cpu", dtype=torch.float32, seq_len=64)
    assert f32.k.dtype == torch.float32 and f32.k_scale is None
    i4 = init_kv_cache(tcfg, "cpu", dtype="int4", seq_len=64)
    assert i4.k.dtype == torch.int8 and i4.k.shape == (
        tcfg.n_layers, 64, tcfg.n_kv_heads * tcfg.cache_head_dim // 2)
    assert i4.k_scale.shape == (tcfg.n_layers, tcfg.n_kv_heads, 64)
    with pytest.raises(ValueError, match="no KV cache of type"):
        init_kv_cache(tcfg, "cpu", dtype="int2")
    i8 = init_kv_cache(tcfg, "cpu", dtype=torch.int8, seq_len=64)
    assert i8.k.dtype == torch.int8 and i8.k.shape == (
        tcfg.n_layers, 64, tcfg.n_kv_heads * tcfg.cache_head_dim)
    assert i8.v_scale.shape == (tcfg.n_layers, tcfg.n_kv_heads, 64)
    assert init_kv_cache(tcfg, "cpu").k_scale is None
