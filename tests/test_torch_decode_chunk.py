"""The engine's chunked decode against the JAX package on the CPU: the
port's `Engine(decode_chunk=n).generate` (`runtime.engine.decode_chunk`,
the loop of `lmrs_tpu/runtime/engine.py` generate) against the JAX
`Engine(decode_chunk=n)`, tiny-llama Q8_0 and tiny-gemma Q4_0 on bf16,
int8 and int4 KV caches; the end of the context, stop tokens inside a
chunk and the order of `on_token` calls; and the forward with its
position on the device against the forward with a host position.

Tolerances, stated at each assert:
- Greedy tokens against the JAX engine: equal up to the first step whose
  top-2 margin in a teacher-forced JAX run of the JAX stream is below
  1e-2 * max |logit| + 1e-4, the bound of tests/test_torch_engine.py (the
  two packages' logits differ by up to it); never fewer than 4 steps.
- Token counts and the final `pos` at the context end, and the tokens,
  `pos` and history after a stop token: exact (they follow from the loop's
  arithmetic, not from the logits; the seeds' streams have no near-tie
  before the stop).
- The chunk path against the engine's own `decode_step` loop, and the
  device-position forward against the host-position forward: bit for bit
  (the same plain versions on the same rows).

The JAX engine keeps its traced programs by config, so a case that needs
another context length takes a JAX config of its own (`seq_len`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.quant import QuantType as JQuantType
from lmrs_tpu.runtime.engine import Engine as JaxEngine
from lmrs_tpu.runtime.engine import GenerationConfig as JaxGenerationConfig

from lmrs_tpu_torch.models.transformer import forward, init_kv_cache
from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
from test_torch_q8_model import _jax_margins
from test_torch_transformer import build_pair

torch.set_num_threads(1)

PROMPT = [3, 17, 250, 9, 1000, 42, 7, 77, 5, 600, 11]
CACHES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8), "int4": ("int4", "int4")}
# (preset, quant, seed, weight scale): greedy streams that are not one
# repeated token
MODELS = {"llama": ("tiny-llama", JQuantType.Q8_0, 4, 0.1),
          "gemma": ("tiny-gemma", JQuantType.Q4_0, 3, 0.01)}


def _pair(tmp_path, family, **cfg_kw):
    name, quant, seed, scale = MODELS[family]
    return build_pair(tmp_path, name, seed=seed, scale=scale, quant=quant,
                      **cfg_kw)


def _near_tie_steps(jcfg, jp, stream, jdtype):
    """The steps of the JAX stream compared before its first near-tie."""
    margins, scale = _jax_margins(jcfg, jp, PROMPT + stream[:-1], jdtype)
    tol = 1e-2 * scale + 1e-4
    close = np.nonzero(margins[len(PROMPT) - 1:] < tol)[0]
    return int(close[0]) if close.size else len(stream)


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_chunk_greedy_matches_jax_engine(tmp_path, monkeypatch, family,
                                         cache):
    monkeypatch.delenv("LMRS_W8A8", raising=False)
    jcfg, jp, tcfg, tp = _pair(tmp_path, family)
    jdtype, tdtype = CACHES[cache]
    n_new = 14
    steps = None
    for n in (1, 3, 8):
        want = JaxEngine(jcfg, jp, cache_dtype=jdtype,
                         decode_chunk=n).generate(
            PROMPT, JaxGenerationConfig(temperature=0.0,
                                        max_new_tokens=n_new))
        eng = Engine(tcfg, tp, device="cpu", cache_dtype=tdtype,
                     decode_chunk=n)
        got = eng.generate(PROMPT, GenerationConfig(temperature=0.0,
                                                    max_new_tokens=n_new))
        assert len(got) == len(want) == n_new
        if steps is None:
            steps = _near_tie_steps(jcfg, jp, want, jdtype)
            assert steps >= 4, steps
        assert got[:steps] == want[:steps], (n, got, want, steps)
        # the last token stands at `pos`, not cached, as in the JAX engine
        assert eng.pos == len(PROMPT) + n_new - 1
        assert eng._hist[:eng.pos + 1].tolist() == PROMPT + got


@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_chunk_path_is_the_decode_step_loop(tmp_path, family):
    """Greedy through chunks of 1, 3 and 8 steps gives the tokens of a
    decode_step + argmax loop on the same engine bit for bit (the device
    position's forward is the host position's), and sampling is
    reproducible from its seed."""
    _, _, tcfg, tp = _pair(tmp_path, family)
    for cache in ("bf16", "int4"):
        eng = Engine(tcfg, tp, device="cpu", cache_dtype=CACHES[cache][1])
        logits = eng.prefill(PROMPT)
        loop = [int(torch.argmax(logits))]
        for _ in range(19):
            loop.append(int(torch.argmax(eng.decode_step(loop[-1]))))
        for n in (1, 3, 8):
            eng.reset()
            eng.decode_chunk = n
            assert eng.generate(PROMPT, GenerationConfig(
                temperature=0.0, max_new_tokens=20)) == loop
        sampled = []
        for _ in range(2):
            eng.reset()
            sampled.append(eng.generate(PROMPT, GenerationConfig(
                temperature=0.9, top_p=0.9, seed=3, max_new_tokens=20)))
        assert sampled[0] == sampled[1]
        assert all(0 <= t < tcfg.vocab_size for t in sampled[0])


@pytest.mark.parametrize("n", [3, 8])
def test_chunk_stops_at_the_context_end_as_jax(tmp_path, n):
    """A chunk is dispatched only while it fits whole: pos + dispatched +
    n < seq_len.  The token count and the final pos equal the JAX
    engine's, and no row past the context is written."""
    seq_len = 48 + n          # a JAX config (and traced programs) per case
    jcfg, jp, tcfg, tp = _pair(tmp_path, "llama", seq_len=seq_len)
    jeng = JaxEngine(jcfg, jp, decode_chunk=n)
    want = jeng.generate(PROMPT, JaxGenerationConfig(temperature=0.0,
                                                     max_new_tokens=500))
    eng = Engine(tcfg, tp, device="cpu", decode_chunk=n)
    got = eng.generate(PROMPT, GenerationConfig(temperature=0.0,
                                                max_new_tokens=500))
    assert len(got) == len(want) and eng.pos == jeng.pos
    assert eng.pos + n >= seq_len > eng.pos
    assert len(got) == 1 + n * ((seq_len - 1 - len(PROMPT)) // n)
    steps = _near_tie_steps(jcfg, jp, want, jnp.bfloat16)
    assert steps >= 4 and got[:steps] == want[:steps]


@pytest.mark.parametrize("streaming", ["on_token", "stop_only"])
def test_stop_token_inside_a_chunk(tmp_path, streaming):
    """A stop token in the middle of a chunk ends generation there: the
    tokens up to it, `on_token` called on each in order, `pos` and the
    history stopped at it (the overshoot rows of the chunk and of the one
    dispatched after it reset to unknown), as in the JAX engine; the
    next turn continues from there."""
    jcfg, jp, tcfg, tp = _pair(tmp_path, "llama")
    n = 8
    free = Engine(tcfg, tp, device="cpu", decode_chunk=n).generate(
        PROMPT, GenerationConfig(temperature=0.0, max_new_tokens=24))
    # a token whose first occurrence sits inside a chunk after the first
    # (chunk j holds tokens 1 + n*j .. n*(j+1)), not at its end
    i = next(i for i in range(n + 1, 24)
             if free.index(free[i]) == i and i % n)
    stop_tok = free[i]
    seen, jseen = [], []
    cb = seen.append if streaming == "on_token" else None
    jeng = JaxEngine(jcfg, jp, decode_chunk=n)
    want = jeng.generate(
        PROMPT, JaxGenerationConfig(temperature=0.0, max_new_tokens=24),
        stop_tokens=[stop_tok], on_token=jseen.append)
    eng = Engine(tcfg, tp, device="cpu", decode_chunk=n)
    got = eng.generate(PROMPT, GenerationConfig(temperature=0.0,
                                                max_new_tokens=24),
                       stop_tokens=[stop_tok], on_token=cb)
    assert got == free[:i + 1] == want
    if cb is not None:
        assert seen == got == jseen
    assert eng.pos == jeng.pos == len(PROMPT) + i
    hist = eng._hist.tolist()
    assert hist[:eng.pos + 1] == PROMPT + got
    assert set(hist[eng.pos + 1:]) == {-1}
    # the next turn: the plain engine fed the same two turns
    gen = GenerationConfig(temperature=0.0, max_new_tokens=6)
    again = Engine(tcfg, tp, device="cpu", decode_chunk=n)
    again.generate(PROMPT, GenerationConfig(temperature=0.0,
                                            max_new_tokens=i + 1))
    assert again.pos == eng.pos
    assert eng.generate([7, 7, 2], gen) == again.generate([7, 7, 2], gen)


@pytest.mark.parametrize("cache", ["bf16", "f32", "int8", "int4"])
def test_device_position_forward_is_the_host_forward(tmp_path, cache):
    """forward with its position a (1,) int32 tensor and host bounds
    equals forward with the host int bit for bit, logits and cache, at
    T = 1 and 5 across Gemma's window edge (a 16-row window)."""
    _, _, tcfg, tp = _pair(tmp_path, "gemma", sliding_window=16)
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32,
             "int8": torch.int8, "int4": "int4"}[cache]
    host = init_kv_cache(tcfg, "cpu", dtype)
    dev = init_kv_cache(tcfg, "cpu", dtype)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, tcfg.vocab_size, 40))
    for c in (host, dev):
        forward(tp, tcfg, c, toks[:12], 0)
    pos = 12
    for t_q in (1, 5, 1, 5, 5, 1):
        x = toks[pos - 12:pos - 12 + t_q]
        want = forward(tp, tcfg, host, x, pos, "all")
        got = forward(tp, tcfg, dev, x,
                      torch.tensor([pos], dtype=torch.int32), "all",
                      pos_range=(pos - 2, pos + 7))
        assert torch.equal(got, want), (pos, t_q)
        for a, b in ((host.k, dev.k), (host.v, dev.v),
                     (host.k_scale, dev.k_scale)):
            assert a is None or torch.equal(a, b)
        pos += t_q
    assert pos > 16 + 12        # the window's first row moved past row 12
    with pytest.raises(ValueError, match="host bounds"):
        forward(tp, tcfg, dev, toks[:1], torch.tensor([pos],
                                                      dtype=torch.int32))
    with pytest.raises(ValueError, match="context overflow"):
        forward(tp, tcfg, dev, toks[:1],
                torch.tensor([pos], dtype=torch.int32),
                pos_range=(pos, tcfg.seq_len))
