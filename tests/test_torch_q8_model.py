"""The port's Q8_0 model path against the JAX package on the CPU: whole
models (Q8_0 weights carried across by params_from_jax) with the bf16 and
the int8 KV cache against the JAX fast path: teacher-forced logits, then
greedy tokens of the two engines.

Tolerances, stated at each assert:
- Model logits with W8A8 off on both sides (layers and classifier on
  kernel E's numerics, where the JAX kernels round x to bf16 and E keeps
  f32): max |difference| <= 1e-2 * max |logit| + 1e-4, the bound of
  tests/test_torch_transformer.py; bf16 K/V (or the int8 rows, which tiny
  head dims send through the JAX einsum on dequantized rows instead of the
  scale-folding kernel) add the rest.  With W8A8 on (the default: layers
  on kernel D's numerics, the classifier on E's) the bound grows by twice
  the activation-quantization noise that the test measures on the same
  step; the reason stands at the assert.
- Greedy tokens agree up to the first step whose top-2 margin in the JAX
  run is below the logit tolerance, as tests/test_torch_engine.py.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.models.transformer import embed_tokens as jax_embed
from lmrs_tpu.models.transformer import forward as jax_forward
from lmrs_tpu.models.transformer import init_kv_cache as jax_init_kv_cache
from lmrs_tpu.quant import QuantType as JQuantType
from lmrs_tpu.runtime.engine import Engine as JaxEngine
from lmrs_tpu.runtime.engine import GenerationConfig as JaxGenerationConfig
from lmrs_tpu.runtime.engine import _compiled_fns

from lmrs_tpu_torch.models.transformer import (embed_tokens, forward,
                                               init_kv_cache)
from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
from test_torch_transformer import build_pair

PROMPT = [3, 17, 250, 9, 1000, 42, 7, 77, 5, 600, 11]
CACHES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


# tiny-llama and tiny-gemma (head_dim 32) take the JAX einsum attention;
# tiny-flash (Gemma, head_dim 128) the JAX flash kernel, for the int8 cache
# its quantized variant
@pytest.mark.parametrize("w8a8", [True, False], ids=["w8a8", "w8a16"])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gemma", "tiny-flash"])
def test_q8_forward_logits_match_jax(tmp_path, monkeypatch, name, cache,
                                     w8a8):
    monkeypatch.setenv("LMRS_FLASH_MIN_BUCKET", "256")
    monkeypatch.setenv("LMRS_W8A8", "1" if w8a8 else "0")
    # LMRS_W8A8 is read when a program is traced, and the JAX package keeps
    # its traced programs by config: the switched-off runs take a config of
    # their own (another context length), never traced with the switch on
    cfg_kw = {} if w8a8 else dict(seq_len=384)
    jcfg, jp, tcfg, tp = build_pair(tmp_path, name, quant=JQuantType.Q8_0,
                                    **cfg_kw)
    assert tp.layers[0].wqkv.q.dtype == torch.int8
    jdtype, tdtype = CACHES[cache]
    embed, step, _ = _compiled_fns(jcfg)
    jcache = jax_init_kv_cache(jcfg, jdtype)
    tcache = init_kv_cache(tcfg, "cpu", tdtype)
    other = init_kv_cache(tcfg, "cpu", tdtype)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, 24)
    pos = 0
    for chunk in (toks[:19], toks[19:20], toks[20:22], toks[22:23],
                  toks[23:24]):
        x = embed(jp, tokens=jnp.asarray(chunk, jnp.int32))
        want, jcache = step(jp, jcache, x, jnp.int32(pos),
                            jnp.int32(len(chunk) - 1), attn_len=tcfg.seq_len)
        want = np.asarray(want)
        tx = embed_tokens(tp, tcfg, torch.from_numpy(chunk))
        np.testing.assert_array_equal(tx.numpy(), np.asarray(x))  # exact
        last = len(chunk) - 1
        got = forward(tp, tcfg, tcache, tx, pos, last, w8a8=w8a8).numpy()
        tol = 1e-2 * np.abs(want).max() + 1e-4
        if w8a8:
            # The activation quantizer is a step function: inputs that
            # differ in their last bits (bf16 K/V, sums in another order)
            # round some values the other way, so two W8A8 runs draw the
            # quantization noise of every layer anew.  The port's own
            # W8A8-vs-W8A16 difference on this step measures that noise;
            # two draws of it differ by up to twice its size.  (For
            # tiny-llama the noise is under 1e-3 of the logit scale and
            # the bound stays near the W8A16 one.)
            noise = forward(tp, tcfg, other, tx, pos, last,
                            w8a8=False).numpy()
            tol += 2 * np.abs(got - noise).max()
            if len(chunk) <= 8:
                assert np.abs(got - noise).max() > 0    # D's numerics ran
        pos += len(chunk)
        assert np.abs(got - want).max() <= tol
    if cache == "int8":
        # The first chunk's rows.  Layer 0's input is the exact embedding
        # and its projection runs kernel F's numerics on both sides: the
        # same integers (but for a value on a rounding boundary) and the
        # same scales.  Deeper layers see hidden states that already
        # differ by the bf16 roundings of attention (up to ~1e-2 here): a
        # value then lands one step away, two where the row's scale moved
        # as well.
        n = 19
        for mine, theirs, ms, ts in (
                (tcache.k, jcache.k, tcache.k_scale, jcache.k_scale),
                (tcache.v, jcache.v, tcache.v_scale, jcache.v_scale)):
            got_q = mine[:, :n].numpy().astype(np.int32)
            want_q = np.asarray(theirs)[:, :n].astype(np.int32)
            got_s = ms[:, :, :n].numpy()
            want_s = np.asarray(ts)[:, :, :n]
            assert (got_q[0] != want_q[0]).mean() < 0.01
            np.testing.assert_allclose(got_s[0], want_s[0], rtol=1e-5)
            assert np.abs(got_q - want_q).max() <= 2
            np.testing.assert_allclose(got_s, want_s, rtol=2e-2)


def test_w8a8_switch_changes_layer_numerics_only_slightly(tmp_path):
    """Engine(w8a8=False) sends the layers through kernel E's numerics: the
    logits move by the activation-quantization error, well inside 1e-2 of
    the logit scale, but they do move."""
    _, _, tcfg, tp = build_pair(tmp_path, "tiny-llama",
                                quant=JQuantType.Q8_0)
    a = Engine(tcfg, tp, device="cpu").prefill(PROMPT[:5])
    b = Engine(tcfg, tp, device="cpu", w8a8=False).prefill(PROMPT[:5])
    diff = (a - b).abs().max()
    assert 0 < diff <= 1e-2 * a.abs().max()


def _jax_margins(jcfg, jp, tokens, jdtype):
    """Top-2 logit margin of every row of one teacher-forced JAX forward
    over `tokens` (row i predicts token i + 1)."""
    fwd = jax.jit(partial(jax_forward, cfg=jcfg, attn_len=jcfg.seq_len,
                          logit_idx="all"))
    x = jax_embed(jp, jcfg, jnp.asarray(tokens, jnp.int32))
    logits, _ = fwd(jp, cache=jax_init_kv_cache(jcfg, jdtype), x=x,
                    pos=jnp.int32(0))
    top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0], np.abs(np.asarray(logits)).max()


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_q8_greedy_tokens_match_jax_engine(tmp_path, monkeypatch, cache):
    monkeypatch.delenv("LMRS_W8A8", raising=False)
    jcfg, jp, tcfg, tp = build_pair(tmp_path, "tiny-llama", seed=4,
                                    scale=0.1, quant=JQuantType.Q8_0)
    jdtype, tdtype = CACHES[cache]
    n_new = 12
    want = JaxEngine(jcfg, jp, cache_dtype=jdtype).generate(
        PROMPT, JaxGenerationConfig(temperature=0.0, max_new_tokens=n_new))
    eng = Engine(tcfg, tp, device="cpu", cache_dtype=tdtype)
    gen = GenerationConfig(temperature=0.0, max_new_tokens=n_new)
    got = eng.generate(PROMPT, gen)
    assert len(got) == len(want) == n_new
    margins, logit_scale = _jax_margins(jcfg, jp, PROMPT + want[:-1], jdtype)
    tol = 1e-2 * logit_scale + 1e-4
    close = np.nonzero(margins[len(PROMPT) - 1:] < tol)[0]
    n_eq = int(close[0]) if close.size else n_new
    assert n_eq >= 4, (margins, tol)
    assert got[:n_eq] == want[:n_eq]
    eng.reset()
    assert eng.generate(PROMPT, gen) == got     # deterministic across reset
