"""The fused-FFN path (`cfg.fuse_ffn`) of the port against the JAX
package's with fuse_ffn on both sides, on the CPU (the kernels' plain
versions; the JAX fused kernels in interpret mode): tiny-gemma Q4_0 (its
loader stores the w13 rows in `ffn_split_perm` order, which
`params_from_jax` puts back in the logical order) and tiny-llama Q8_0.

The fused configs take a context length of their own (384): the JAX
package keeps its traced programs by config.

Tolerances, stated at each assert:
- logits: 1e-2 of the logit scale + 1e-4, as tests/test_torch_transformer
  .py (bf16 K/V and softmax roundings, and kernel A's f32 activations
  where the JAX stacked kernels round them to bf16, on the layers'
  other matmuls); for Q8 at T <= 8 (W8A8 on wqkv and wo) plus twice the
  port's own W8A8-vs-W8A16 difference on the same step, as
  tests/test_torch_q8_model.py.
- greedy tokens: equal up to the first step whose top-2 margin in the JAX
  run is below the logit tolerance, as tests/test_torch_engine.py.
- a batched step of 8 slots (kernel K on 8 rows) and of 16 (kernel L)
  against each slot's single-stream fused step (K on one row): 1e-2 of
  the logit scale + 1e-4 (K and L round the weights differently, L to
  bf16(bf16(q) * bf16(s)); the batched and single attention sum in
  another order).  The Q8 model runs both sides with W8A8 off: at 16 rows
  the batched step takes kernel F's bf16 activations for wqkv and wo where
  one row takes W8A8, whose noise is not the FFN's to measure.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from lmrs_tpu.quant import QuantType as JQuantType
from lmrs_tpu.runtime.engine import Engine as JaxEngine
from lmrs_tpu.runtime.engine import GenerationConfig as JaxGenerationConfig
from lmrs_tpu.runtime.engine import _compiled_fns
from lmrs_tpu.models.transformer import init_kv_cache as jax_init_kv_cache

from lmrs_tpu_torch.kernels.ffn_fused import ffn_split_perm
from lmrs_tpu_torch.models.transformer import (KVCache, embed_tokens,
                                               forward, forward_batched,
                                               init_batched_kv_cache,
                                               init_kv_cache)
from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
from test_torch_engine import PROMPT, _jax_margins
from test_torch_ffn_fused import _spy
from test_torch_transformer import build_pair

torch.set_num_threads(1)

FUSE = dict(fuse_ffn=True, seq_len=384)
MODELS = [("tiny-gemma", JQuantType.Q4_0), ("tiny-llama", JQuantType.Q8_0)]


def test_params_from_jax_restores_the_logical_w13(tmp_path):
    """A JAX load with fuse_ffn permutes Q4 w13 rows; the port's import of
    it equals, byte for byte, its import of an unfused load."""
    _, jp_f, tcfg_f, tp_f = build_pair(tmp_path, "tiny-gemma", **FUSE)
    _, jp, _, tp = build_pair(tmp_path, "tiny-gemma")
    h = tcfg_f.hidden_dim
    p = ffn_split_perm(h, tcfg_f.group_size)
    perm = np.concatenate([p, h + p])
    assert not np.array_equal(perm, np.arange(2 * h))
    np.testing.assert_array_equal(np.asarray(jp_f.layers.w13.q),
                                  np.asarray(jp.layers.w13.q)[:, perm])
    for a, b in zip(tp_f.layers, tp.layers):
        assert torch.equal(a.w13.q, b.w13.q) and torch.equal(a.w13.s, b.w13.s)
        assert torch.equal(a.w2.q, b.w2.q) and torch.equal(a.wqkv.q, b.wqkv.q)


@pytest.mark.parametrize("name,quant", MODELS)
def test_fused_forward_logits_match_jax(tmp_path, monkeypatch, name, quant):
    """A 19-row prefill chunk (unfused on both sides), then decode steps
    (T = 1) and a verify-sized chunk (T = 5) through the fused FFN."""
    calls = _spy(monkeypatch)
    jcfg, jp, tcfg, tp = build_pair(tmp_path, name, quant=quant, **FUSE)
    q8 = quant == JQuantType.Q8_0
    embed, step, _ = _compiled_fns(jcfg)
    jcache = jax_init_kv_cache(jcfg, jnp.bfloat16)
    tcache = init_kv_cache(tcfg, "cpu")
    other = init_kv_cache(tcfg, "cpu")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, 27)
    pos = 0
    for chunk in (toks[:19], toks[19:20], toks[20:25], toks[25:26],
                  toks[26:27]):
        calls.clear()
        x = embed(jp, tokens=jnp.asarray(chunk, jnp.int32))
        want, jcache = step(jp, jcache, x, jnp.int32(pos),
                            jnp.int32(len(chunk) - 1), attn_len=tcfg.seq_len)
        want = np.asarray(want)
        tx = embed_tokens(tp, tcfg, torch.from_numpy(chunk))
        last = len(chunk) - 1
        got = forward(tp, tcfg, tcache, tx, pos, last).numpy()
        fused = len(chunk) <= 8
        assert calls == ([("xe", len(chunk))] * tcfg.n_layers if fused
                         else [])
        tol = 1e-2 * np.abs(want).max() + 1e-4
        if q8 and fused:
            # W8A8 noise on wqkv and wo, measured as the port's own
            # W8A8-vs-W8A16 difference on this step (the reason stands in
            # tests/test_torch_q8_model.py)
            noise = forward(tp, tcfg, other, tx, pos, last,
                            w8a8=False).numpy()
            tol += 2 * np.abs(got - noise).max()
        else:
            forward(tp, tcfg, other, tx, pos, last)
        assert np.abs(got - want).max() <= tol, (pos, len(chunk))
        pos += len(chunk)


# seeds and weight scales whose greedy streams are not one repeated token
# (tiny-flash: Gemma, head_dim 128, the JAX flash kernel)
@pytest.mark.parametrize("name,quant,seed,scale",
                         [("tiny-flash", JQuantType.Q4_0, 5, 0.02),
                          ("tiny-llama", JQuantType.Q8_0, 4, 0.1)])
def test_fused_greedy_tokens_match_jax_engine(tmp_path, monkeypatch, name,
                                              quant, seed, scale):
    monkeypatch.setenv("LMRS_FLASH_MIN_BUCKET", "256")
    jcfg, jp, tcfg, tp = build_pair(tmp_path, name, seed=seed, scale=scale,
                                    quant=quant, **FUSE)
    n_new = 16
    want = JaxEngine(jcfg, jp).generate(
        PROMPT, JaxGenerationConfig(temperature=0.0, max_new_tokens=n_new))
    got = Engine(tcfg, tp, device="cpu").generate(
        PROMPT, GenerationConfig(temperature=0.0, max_new_tokens=n_new))
    assert len(got) == len(want) == n_new
    assert len(set(want)) >= 3
    margins, logit_scale = _jax_margins(jcfg, jp, PROMPT + want[:-1])
    tol = 1e-2 * logit_scale + 1e-4
    close = np.nonzero(margins[len(PROMPT) - 1:] < tol)[0]
    assert not close.size or close[0] >= 4, (margins, tol)
    n_eq = int(close[0]) if close.size else n_new
    assert got[:n_eq] == want[:n_eq]


@pytest.mark.parametrize("b,which", [(8, "xe"), (16, "bf16")])
@pytest.mark.parametrize("name,quant", MODELS)
def test_fused_batched_step_matches_single_stream(tmp_path, monkeypatch, b,
                                                  which, name, quant):
    """One batched decode step of b slots at ragged positions (their own
    prompts, prefilled single-stream into their slot of the per-slot
    cache) against each slot's single-stream fused decode step."""
    calls = _spy(monkeypatch)
    _, _, tcfg, tp = build_pair(tmp_path, name, quant=quant, **FUSE)
    w8a8 = quant != JQuantType.Q8_0
    rng = np.random.default_rng(b)
    lens = rng.integers(3, 30, b)
    rows = 64
    cache = init_batched_kv_cache(tcfg, "cpu", b, rows)
    singles, nxt = [], []
    for i, n in enumerate(lens):
        prompt = rng.integers(0, tcfg.vocab_size, n)
        slot = KVCache(k=cache.k[i], v=cache.v[i])
        forward(tp, tcfg, slot, embed_tokens(tp, tcfg,
                                             torch.from_numpy(prompt)), 0,
                None, w8a8=w8a8)
        singles.append(KVCache(k=slot.k.clone(), v=slot.v.clone()))
        nxt.append(int(rng.integers(0, tcfg.vocab_size)))
    calls.clear()
    x = embed_tokens(tp, tcfg, torch.tensor(nxt))
    pos = torch.tensor(lens, dtype=torch.int32)
    got = forward_batched(tp, tcfg, cache, x, pos, w8a8=w8a8)
    assert calls == [(which, b)] * tcfg.n_layers
    for i in range(b):
        want = forward(tp, tcfg, singles[i], x[i:i + 1], int(lens[i]), 0,
                       w8a8=w8a8)
        err = (got[i] - want).abs().max().item()
        assert err <= 1e-2 * want.abs().max().item() + 1e-4, (i, err)
