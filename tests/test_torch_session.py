"""Sessions of the port's Engine on the CPU: save, load into a fresh Engine,
continue; the refusals; the history; and sessions written by the JAX
Engine loaded in the port.

Tolerances, stated at each assert:
- A round trip within the port: the cache, `pos` and the history are equal
  bit for bit, and the continued tokens equal the uninterrupted engine's.
- A JAX session (int8, int4 or bf16 cache) loaded in the port: the cache
  arrays are equal bit for bit; the continued greedy tokens equal the JAX
  engine's up to the first step whose top-2 margin in the JAX run is below
  1e-2 of the logit scale, as tests/test_torch_engine.py (the two
  packages' logits differ by up to that much on the same cache).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.models.transformer import embed_tokens as jax_embed
from lmrs_tpu.models.transformer import forward as jax_forward
from lmrs_tpu.quant import QuantType as JQuantType
from lmrs_tpu.runtime.engine import Engine as JaxEngine
from lmrs_tpu.runtime.engine import GenerationConfig as JaxGenerationConfig

from lmrs_tpu_torch.io.params import kvcache_from_numpy
from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
from test_torch_transformer import build_pair

# tiny models gain nothing from intra-op threads, and several test
# processes side by side, each with a thread per core, slow one another
# tenfold
torch.set_num_threads(1)

PROMPT = [3, 17, 250, 9, 1000, 42, 7, 77, 5, 600, 11]
TURN = [7, 7, 2, 9]
CACHES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32),
          "int8": (jnp.int8, torch.int8), "int4": ("int4", "int4")}
GREEDY = GenerationConfig(temperature=0.0, max_new_tokens=10)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    # tiny-llama Q8_0, weights of std 0.1: a greedy stream of several tokens
    return build_pair(tmp_path_factory.mktemp("session"), "tiny-llama",
                      seed=4, scale=0.1, quant=JQuantType.Q8_0)


@pytest.mark.parametrize("cache", ["bf16", "f32", "int8", "int4"])
def test_session_round_trip(tmp_path, pair, cache):
    _, _, tcfg, tp = pair
    dtype = CACHES[cache][1]
    eng = Engine(tcfg, tp, device="cpu", cache_dtype=dtype)
    first = eng.generate(PROMPT, GREEDY)
    path = str(tmp_path / "s.npz")
    eng.save_session(path)
    other = Engine(tcfg, tp, device="cpu", cache_dtype=dtype)
    other.generate([1, 2, 3], GREEDY)           # another conversation's state
    other.load_session(path)
    assert other.pos == eng.pos == len(PROMPT) + len(first) - 1
    assert other.cache.k.dtype == eng.cache.k.dtype
    n = eng.pos
    assert torch.equal(other.cache.k[:, :n], eng.cache.k[:, :n])
    assert torch.equal(other.cache.v[:, :n], eng.cache.v[:, :n])
    if eng.cache.k_scale is not None:
        assert torch.equal(other.cache.k_scale[:, :, :n],
                           eng.cache.k_scale[:, :, :n])
    # the history survives: prompt and reply, the last token at index pos
    assert other._hist[:n + 1].tolist() == PROMPT + first
    assert torch.equal(other._hist, eng._hist)
    # continuing equals the engine that was never interrupted
    want = eng.generate(TURN, GREEDY)
    assert other.generate(TURN, GREEDY) == want
    # the path may leave out numpy's suffix
    third = Engine(tcfg, tp, device="cpu", cache_dtype=dtype)
    third.load_session(str(tmp_path / "s"))
    assert third.pos == n


def test_speculation_after_a_load_still_accepts(tmp_path, pair):
    """The lookup drafts from the restored history: a looping conversation
    goes on accepting drafts after a load."""
    _, _, tcfg, tp = pair
    loop = [5, 9, 11] * 6
    spec = GenerationConfig(temperature=0.0, max_new_tokens=24,
                            speculative_k=3)
    eng = Engine(tcfg, tp, device="cpu")
    eng.generate(loop, spec)
    eng.save_session(str(tmp_path / "s.npz"))
    other = Engine(tcfg, tp, device="cpu")
    other.load_session(str(tmp_path / "s.npz"))
    before = eng.metrics.spec_accepted      # the metrics add up over turns
    want = eng.generate(loop[:6], spec)
    got = other.generate(loop[:6], spec)
    assert got == want
    assert other.metrics.spec_accepted == \
        eng.metrics.spec_accepted - before > 0


def test_load_session_refusals(tmp_path, pair):
    _, _, tcfg, tp = pair
    path = {}
    for cache in ("bf16", "int8", "int4"):
        eng = Engine(tcfg, tp, device="cpu", cache_dtype=CACHES[cache][1])
        eng.prefill(PROMPT)
        path[cache] = str(tmp_path / f"{cache}.npz")
        eng.save_session(path[cache])
    # another model config
    small = Engine(tcfg.replace(seq_len=256), tp, device="cpu")
    with pytest.raises(ValueError, match="model config"):
        small.load_session(path["bf16"])
    # another cache shape: an int4 session on an int8 engine
    i8 = Engine(tcfg, tp, device="cpu", cache_dtype=torch.int8)
    with pytest.raises(ValueError, match="shape"):
        i8.load_session(path["int4"])
    # a quantized cache's session on a float engine, and the reverse
    bf = Engine(tcfg, tp, device="cpu")
    with pytest.raises(ValueError, match="int8 KV cache"):
        bf.load_session(path["int8"])
    with pytest.raises(ValueError, match="float KV cache"):
        i8.load_session(path["bf16"])
    assert i8.pos == bf.pos == 0                # a refusal changes nothing
    # a float session converts between float caches
    f32 = Engine(tcfg, tp, device="cpu", cache_dtype=torch.float32)
    f32.load_session(path["bf16"])
    assert f32.cache.k.dtype == torch.float32 and f32.pos == len(PROMPT)


def _jax_margins(jcfg, jp, jcache, tokens, pos):
    """Top-2 logit margin of every row of one teacher-forced JAX forward
    over `tokens` at `pos` on `jcache`."""
    fwd = jax.jit(partial(jax_forward, cfg=jcfg, attn_len=jcfg.seq_len,
                          logit_idx="all"))
    x = jax_embed(jp, jcfg, jnp.asarray(tokens, jnp.int32))
    logits, _ = fwd(jp, cache=jcache, x=x, pos=jnp.int32(pos))
    top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0], np.abs(np.asarray(logits)).max()


@pytest.mark.parametrize("cache", ["int8", "int4", "bf16"])
def test_jax_session_loads_in_the_port(tmp_path, monkeypatch, pair, cache):
    """A session written by the JAX Engine.  Its bf16 cache reaches numpy
    as 2-byte items (bfloat16 where ml_dtypes registers it, raw void items
    in the file): `kvcache_from_numpy` reinterprets the bits, so no
    ml_dtypes is needed to read them."""
    monkeypatch.delenv("LMRS_W8A8", raising=False)
    jcfg, jp, tcfg, tp = pair
    jdtype, tdtype = CACHES[cache]
    n_new = 10
    jgen = JaxGenerationConfig(temperature=0.0, max_new_tokens=n_new)
    jeng = JaxEngine(jcfg, jp, cache_dtype=jdtype)
    reply = jeng.generate(PROMPT, jgen)
    path = str(tmp_path / "jax.npz")
    jeng.save_session(path)
    pos = jeng.pos
    # copies: the next generation donates the engine's cache buffers
    f32 = (lambda a: a.astype(jnp.float32)) if cache == "bf16" else (
        lambda a: a)
    saved = {key: np.asarray(f32(getattr(jeng.cache, key)))
             for key in ("k", "v")}
    if cache != "bf16":
        saved["k_scale"] = np.asarray(jeng.cache.k_scale)
    want = jeng.generate(TURN, jgen)

    eng = Engine(tcfg, tp, device="cpu", cache_dtype=tdtype)
    eng.load_session(path)
    assert eng.pos == pos == len(PROMPT) + n_new - 1
    assert eng._hist[:pos + 1].tolist() == PROMPT + reply
    # the rows of the conversation are the JAX engine's, bit for bit (its
    # chunked decode also wrote a few rows past pos, which nothing reads)
    for mine, theirs in ((eng.cache.k, saved["k"]), (eng.cache.v, saved["v"])):
        np.testing.assert_array_equal(mine[:, :pos].float().numpy(),
                                      theirs[:, :pos].astype(np.float32))
    if cache != "bf16":
        np.testing.assert_array_equal(eng.cache.k_scale[:, :, :pos].numpy(),
                                      saved["k_scale"][:, :, :pos])
    got = eng.generate(TURN, GenerationConfig(temperature=0.0,
                                              max_new_tokens=n_new))
    # the JAX engine's cache at the save, made again (its own load_session
    # cannot cast a saved bf16 cache back)
    again = JaxEngine(jcfg, jp, cache_dtype=jdtype)
    assert again.generate(PROMPT, jgen) == reply
    margins, logit_scale = _jax_margins(jcfg, jp, again.cache,
                                        TURN + want[:-1], pos)
    tol = 1e-2 * logit_scale + 1e-4
    close = np.nonzero(margins[len(TURN) - 1:] < tol)[0]
    n_eq = int(close[0]) if close.size else n_new
    assert n_eq >= 3, (margins, tol)
    assert got[:n_eq] == want[:n_eq]


def test_kvcache_from_numpy_reads_bf16_bit_patterns():
    x = torch.randn(2, 5, 8).to(torch.bfloat16)
    bits = x.view(torch.int16).numpy()
    for arr in (bits, bits.view("V2")):         # this package's, and JAX's
        c = kvcache_from_numpy(dict(k=arr, v=arr), torch.bfloat16, "cpu")
        assert c.k.dtype == torch.bfloat16 and torch.equal(c.k, x)
        assert c.k_scale is None
    f = kvcache_from_numpy(dict(k=x.float().numpy(), v=x.float().numpy()),
                           torch.bfloat16, "cpu")
    assert torch.equal(f.k, x)
    with pytest.raises(ValueError, match="cannot be read"):
        kvcache_from_numpy(dict(k=np.zeros((2, 5, 8), "S3"), v=bits),
                           torch.bfloat16, "cpu")
