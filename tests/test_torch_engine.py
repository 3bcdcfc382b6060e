"""The port's Engine against the JAX Engine (matmul_impl="fast") on the
same carried-across parameters, plus the engine's own contracts.

Greedy tokens: the two engines' logits differ by up to the tolerance of
tests/test_torch_transformer.py (1e-2 of the logit scale), so a step whose
top-2 logit margin in the JAX run is below that tolerance may pick either
token.  The tokens are compared up to the first such step, located from
the JAX model's own logits along its token stream, and never fewer than
six steps are compared.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from lmrs_tpu.models.transformer import embed_tokens as jax_embed
from lmrs_tpu.models.transformer import forward as jax_forward
from lmrs_tpu.models.transformer import init_kv_cache as jax_init_kv_cache
from lmrs_tpu.runtime.engine import Engine as JaxEngine
from lmrs_tpu.runtime.engine import GenerationConfig as JaxGenerationConfig

from lmrs_tpu_torch.models.transformer import embed_tokens, forward
from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
from test_torch_transformer import build_pair

PROMPT = [3, 17, 250, 9, 1000, 42, 7, 77, 5, 600, 11]


def _jax_margins(jcfg, jp, tokens):
    """Top-2 logit margin of every row of one teacher-forced JAX forward
    over `tokens` (row i predicts token i + 1)."""
    fwd = jax.jit(partial(jax_forward, cfg=jcfg, attn_len=jcfg.seq_len,
                          logit_idx="all"))
    x = jax_embed(jp, jcfg, jnp.asarray(tokens, jnp.int32))
    logits, _ = fwd(jp, cache=jax_init_kv_cache(jcfg, jnp.bfloat16), x=x,
                    pos=jnp.int32(0))
    top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0], np.abs(np.asarray(logits)).max()


# seeds and weight scales whose greedy streams are not one repeated token
@pytest.mark.parametrize("name,seed,scale", [("tiny-flash", 5, 0.02),
                                             ("tiny-llama", 4, 0.1)])
def test_greedy_tokens_match_jax_engine(tmp_path, monkeypatch, name, seed,
                                        scale):
    monkeypatch.setenv("LMRS_FLASH_MIN_BUCKET", "256")
    jcfg, jp, tcfg, tp = build_pair(tmp_path, name, seed=seed, scale=scale)
    n_new = 16
    want = JaxEngine(jcfg, jp).generate(
        PROMPT, JaxGenerationConfig(temperature=0.0, max_new_tokens=n_new))
    got = Engine(tcfg, tp, device="cpu").generate(
        PROMPT, GenerationConfig(temperature=0.0, max_new_tokens=n_new))
    assert len(got) == len(want) == n_new
    assert len(set(want)) >= 3
    margins, logit_scale = _jax_margins(jcfg, jp, PROMPT + want[:-1])
    tol = 1e-2 * logit_scale + 1e-4
    step_margins = margins[len(PROMPT) - 1:]
    close = np.nonzero(step_margins < tol)[0]
    assert not close.size or close[0] >= 6, (step_margins, tol)
    # tokens agree before the first near-tie step, which may go either way
    n_eq = int(close[0]) if close.size else n_new
    assert got[:n_eq] == want[:n_eq]


def test_greedy_is_deterministic_across_reset(tmp_path):
    _, _, tcfg, tp = build_pair(tmp_path, "tiny-flash", seed=4)
    eng = Engine(tcfg, tp, device="cpu")
    gen = GenerationConfig(temperature=0.0, max_new_tokens=10)
    a = eng.generate(PROMPT, gen)
    assert eng.pos == len(PROMPT) + 9        # the last token is not cached
    eng.reset()
    assert eng.pos == 0
    assert eng.generate(PROMPT, gen) == a
    eng.reset()
    s1 = eng.generate(PROMPT, GenerationConfig(seed=5, max_new_tokens=10))
    eng.reset()
    s2 = eng.generate(PROMPT, GenerationConfig(seed=5, max_new_tokens=10))
    assert s1 == s2 and all(0 <= t < tcfg.vocab_size for t in s1)


def test_chunked_prefill_matches_token_by_token(tmp_path):
    _, _, tcfg, tp = build_pair(tmp_path, "tiny-flash", seed=4)
    prompt = list(np.random.default_rng(2).integers(0, tcfg.vocab_size, 40))
    chunked = Engine(tcfg, tp, device="cpu", prefill_chunk=16)
    want = chunked.prefill(prompt)
    one = Engine(tcfg, tp, device="cpu", prefill_chunk=1)
    got = one.prefill(prompt)
    assert chunked.pos == one.pos == 40
    # T=16 chunks take kernel B's numerics (bf16 activations), T=1 steps
    # kernel A's (f32): agreement to the transformer test's tolerance
    assert (got - want).abs().max() <= 1e-2 * want.abs().max() + 1e-4
    # and a decode step after either prefill sees the same cache
    a, b = chunked.decode_step(5), one.decode_step(5)
    assert (a - b).abs().max() <= 1e-2 * a.abs().max() + 1e-4


def test_max_new_tokens_and_stop_tokens(tmp_path):
    _, _, tcfg, tp = build_pair(tmp_path, "tiny-llama", seed=4)
    eng = Engine(tcfg, tp, device="cpu")
    gen = GenerationConfig(temperature=0.0, max_new_tokens=7)
    free = eng.generate(PROMPT, gen)
    assert len(free) == 7
    eng.reset()
    seen = []
    stopped = eng.generate(PROMPT, gen, stop_tokens=[free[3]],
                           on_token=seen.append)
    first = free.index(free[3])
    assert stopped == free[:first + 1] == seen


def test_engine_needs_a_device_or_a_gpu(tmp_path, monkeypatch):
    _, _, tcfg, tp = build_pair(tmp_path, "tiny-llama", seed=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(tcfg, tp)
    eng = Engine(tcfg, tp, device="cpu")
    # speculative decoding and every cache type are served
    want = eng.generate(PROMPT, GenerationConfig(temperature=0.0,
                                                 max_new_tokens=6))
    eng.reset()
    assert eng.generate(PROMPT, GenerationConfig(
        temperature=0.0, max_new_tokens=6, speculative_k=3)) == want
    assert eng.metrics.spec_proposed > 0
    for dtype, store in ((torch.float32, torch.float32), ("float32",
                         torch.float32), ("int4", torch.int8)):
        other = Engine(tcfg, tp, device="cpu", cache_dtype=dtype)
        assert other.cache.k.dtype == store
        assert len(other.generate(PROMPT, GenerationConfig(
            temperature=0.0, max_new_tokens=3))) == 3
    with pytest.raises(ValueError, match="no KV cache of type"):
        Engine(tcfg, tp, device="cpu", cache_dtype=torch.float16)


def test_decode_step_matches_forward(tmp_path):
    """decode_step is one forward of one embedded token at `pos`."""
    _, _, tcfg, tp = build_pair(tmp_path, "tiny-llama", seed=4)
    eng = Engine(tcfg, tp, device="cpu")
    eng.prefill(PROMPT)
    logits = eng.decode_step(9)
    eng2 = Engine(tcfg, tp, device="cpu")
    eng2.prefill(PROMPT)
    x = embed_tokens(tp, tcfg, torch.tensor([9]))
    want = forward(tp, tcfg, eng2.cache, x, len(PROMPT), 0)
    assert torch.equal(logits, want)
