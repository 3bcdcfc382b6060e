"""Whole models on the port's int4 KV cache against the JAX package on the
CPU, for a pair-packed geometry (tiny-flash: 2 kv heads, head dim 128) and
a half-packed one (1 kv head, head dim 256); both take the JAX flash kernel
with packed4=True in interpret mode.  Q4_0 weights, so no activation
quantizer stands between the two packages.

Tolerances, stated at each assert:
- int4 cache against the f32 cache within the port, prefill logits of the
  model tests/test_int8_cache.py uses (the JAX tiny Llama, Q8_0, seed 3):
  12% of the logit scale, the bound that test puts on the JAX package's
  int4 cache (4-bit K and V are coarse).
- Port int4 against JAX int4, teacher-forced logits: 1e-2 of the logit
  scale, as tests/test_torch_transformer.py, plus a tenth of the int4
  cache's own effect measured on the same step (port int4 against port
  f32).  The row quantizer is a step function with steps of 1/7 of a
  row's largest value: hidden states that differ in their last bits (bf16
  roundings, sums in another order) move a few nibbles one step, so two
  int4 runs draw a small part of the quantization noise anew, as two W8A8
  runs do in tests/test_torch_q8_model.py.  (Measured: the two packages
  differ by 0.8-1.2% of the logit scale, the cache's effect is 12-22%.)
- Layer 0's rows of the first chunk: its input is the exact embedding, so
  at most 1% of the nibbles differ, by one step, and the scales agree to
  1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from lmrs_tpu_torch.quant import q4_cache_pair_mode, unpack_kv_q4
from lmrs_tpu_torch.runtime.engine import Engine
from test_torch_io import jax_param_arrays


# tiny models gain nothing from intra-op threads, and several test
# processes side by side, each with a thread per core, slow one another
# tenfold
torch.set_num_threads(1)


def _pair(tmp_path, packing):
    """(JAX cfg, JAX params, port cfg, port params) of one random Q4_0
    Gemma file whose int4 cache takes `packing`."""
    seed, scale = 1, 0.02
    if packing == "pair":
        jcfg = JAX_PRESETS["tiny-flash"](quant=JQuantType.Q4_0)
    elif packing == "tiny-llama":       # tests/test_int8_cache.py's model
        jcfg = jax_tiny_config(JModelType.LLAMA, JQuantType.Q8_0)
        seed = 3
    else:
        jcfg = jax_tiny_config(
            JModelType.GEMMA, JQuantType.Q4_0, dim=256, hidden_dim=512,
            n_layers=2, n_heads=2, head_dim=256, n_kv_heads=1,
            vocab_size=2048, seq_len=512)
    path = str(tmp_path / f"{packing}.lmrs")
    jl.write_lmrs(path, jcfg, jax_random_weights(jcfg, seed, scale))
    jf = jl.read_lmrs(path)
    jcfg = jf.cfg.replace(matmul_impl="fast")
    jp = jax_params_from_lmrs(jf, stack_layers=True, fuse_qkv=True)
    tcfg = tl.read_lmrs(path).cfg
    tp = params_from_jax(tcfg, jax_param_arrays(jp), device="cpu")
    assert q4_cache_pair_mode(tcfg.n_kv_heads, tcfg.cache_head_dim) == (
        packing != "half")
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("packing", ["pair", "half"])
def test_int4_forward_logits_match_jax(tmp_path, monkeypatch, packing):
    monkeypatch.setenv("LMRS_FLASH_MIN_BUCKET", "256")
    jcfg, jp, tcfg, tp = _pair(tmp_path, packing)
    embed, step, _ = _compiled_fns(jcfg)
    jcache = jax_init_kv_cache(jcfg, "int4")
    tcache = init_kv_cache(tcfg, "cpu", "int4")
    fcache = init_kv_cache(tcfg, "cpu", torch.float32)
    half_row = tcfg.n_kv_heads * tcfg.cache_head_dim // 2
    assert tcache.k.shape == (tcfg.n_layers, tcfg.seq_len, half_row)
    assert tcache.k.dtype == torch.int8 and tcache.k.shape == jcache.k.shape
    assert tcache.v_scale.shape == (tcfg.n_layers, tcfg.n_kv_heads,
                                    tcfg.seq_len)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, 24)
    pos = 0
    for chunk in (toks[:19], toks[19:20], toks[20:22], toks[22:23],
                  toks[23:24]):
        x = embed(jp, tokens=jnp.asarray(chunk, jnp.int32))
        want, jcache = step(jp, jcache, x, jnp.int32(pos),
                            jnp.int32(len(chunk) - 1), attn_len=tcfg.seq_len)
        want = np.asarray(want)
        tx = embed_tokens(tp, tcfg, torch.from_numpy(chunk))
        last = len(chunk) - 1
        got = forward(tp, tcfg, tcache, tx, pos, last).numpy()
        exact = forward(tp, tcfg, fcache, tx, pos, last).numpy()
        scale = np.abs(want).max()
        # the int4 cache's own effect on this step (12-22% of the scale
        # for these models); a tenth of it may be drawn anew
        effect = np.abs(got - exact).max()
        assert np.abs(got - want).max() <= 1e-2 * scale + 1e-4 + 0.1 * effect
        pos += len(chunk)
    # the first chunk's rows of layer 0: the same nibbles but for values on
    # a rounding boundary, the same scales
    n, kh, hd = 19, tcfg.n_kv_heads, tcfg.cache_head_dim
    for mine, theirs, ms, ts in (
            (tcache.k, jcache.k, tcache.k_scale, jcache.k_scale),
            (tcache.v, jcache.v, tcache.v_scale, jcache.v_scale)):
        got_q = unpack_kv_q4(mine[0, :n], kh, hd).numpy()
        want_q = unpack_kv_q4(torch.from_numpy(np.array(theirs)[0, :n]),
                              kh, hd).numpy()
        assert (got_q != want_q).mean() < 0.01
        assert np.abs(got_q - want_q).max() <= 1
        np.testing.assert_allclose(ms[0, :, :n].numpy(),
                                   np.asarray(ts)[0, :, :n], rtol=1e-5)


def test_int4_prefill_logits_close_to_f32(tmp_path):
    """The port's int4 engine against its f32 engine on the model, prompt
    and bound of tests/test_int8_cache.py's test of the JAX package: 12%
    of the logit scale."""
    _, _, tcfg, tp = _pair(tmp_path, "tiny-llama")
    prompt = [3, 11, 250, 17, 42, 9]
    ref = Engine(tcfg, tp, device="cpu",
                 cache_dtype=torch.float32).prefill(prompt)
    eng = Engine(tcfg, tp, device="cpu", cache_dtype="int4")
    got = eng.prefill(prompt)
    assert eng.cache.k.shape[-1] == \
        tcfg.n_kv_heads * tcfg.cache_head_dim // 2
    scale = max(float(ref.abs().max()), 1.0)
    assert float((got - ref).abs().max()) <= 0.12 * scale
    assert float((got - ref).abs().max()) > 0       # the cache is 4-bit
