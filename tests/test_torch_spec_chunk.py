"""The single-stream speculative chunk against the JAX package on the CPU:
the port's `runtime.speculative.spec_chunk` against the JAX
`make_spec_chunk(cfg)` on the same loaded cache and history, greedy at
(n_steps, k) = (1, 2) and (4, 4); its sampled first token by distribution;
the host reads of a speculative and a plain generation; and
`Engine.profile_trace`.

Tolerances, stated at each assert:
- Greedy chunk: out_buf[:n_out], n_out, the accepted counts, the new
  position and the whole history equal.  The two packages' logits differ
  by up to 1e-2 of the logit scale (tests/test_torch_engine.py); the
  test asserts that no verify row of these seeds has a top-2 margin
  below that bound, so that every argmax is decided.
- Sampled: the first emitted token of a chunk is distributed as plain
  sampling from its row, `processed_probs` of the row's logits (which
  tests/test_torch_speculative.py and test_torch_sampling_batched.py hold
  against the JAX package's): a chi-square test at alpha = 0.001 over
  the nucleus, as tests/test_torch_speculative.py tests
  `rejection_accept` (the two packages' random streams differ).
- Host reads: at most one a chunk plus a constant (counted, exact).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from lmrs_tpu.models.transformer import embed_tokens as jax_embed
from lmrs_tpu.models.transformer import forward as jax_forward
from lmrs_tpu.models.transformer import init_kv_cache as jax_init_kv_cache
from lmrs_tpu.quant import QuantType as JQuantType
from lmrs_tpu.runtime.engine import Engine as JaxEngine
from lmrs_tpu.runtime.speculative import make_spec_chunk

from lmrs_tpu_torch.ops.sampling import processed_probs
from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
from lmrs_tpu_torch.runtime.speculative import spec_chunk
from test_torch_transformer import build_pair

torch.set_num_threads(1)

# a prompt whose bigrams recur, so that drafts are both taken and refused
PROMPT = [5, 9, 11, 5, 9, 11, 5, 9, 11, 5, 9, 40, 7, 40, 7]


def _pair(tmp_path):
    return build_pair(tmp_path, "tiny-llama", seed=5, scale=0.1,
                      quant=JQuantType.Q8_0)


def _loaded(jcfg, jp, tcfg, tp):
    """A JAX and a port engine with PROMPT prefilled and the JAX argmax
    at `pos` in both histories: (JAX engine, port engine, pos, numpy
    history)."""
    jeng = JaxEngine(jcfg, jp)
    first = int(np.argmax(np.asarray(jeng.prefill(PROMPT))))
    eng = Engine(tcfg, tp, device="cpu")
    assert int(torch.argmax(eng.prefill(PROMPT))) == first
    pos = len(PROMPT)
    h = np.full(tcfg.seq_len, -1, np.int64)
    h[:pos] = PROMPT
    h[pos] = first
    eng._hist.copy_(torch.from_numpy(h))
    return jeng, eng, pos, h


def _window_margins(jcfg, jp, tokens):
    """Top-2 margin of every row of a teacher-forced JAX forward over
    `tokens` and the largest |logit|."""
    x = jax_embed(jp, jcfg, jnp.asarray(tokens, jnp.int32))
    logits, _ = jax.jit(lambda p, c, x: jax_forward(
        p, jcfg, c, x, jnp.int32(0), jcfg.seq_len, "all"))(
        jp, jax_init_kv_cache(jcfg, jnp.bfloat16), x)
    logits = np.asarray(logits)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0], np.abs(logits).max()


@pytest.mark.parametrize("n_steps,k", [(1, 2), (4, 4)])
def test_greedy_spec_chunk_matches_jax(tmp_path, monkeypatch, n_steps, k):
    monkeypatch.delenv("LMRS_W8A8", raising=False)
    jcfg, jp, tcfg, tp = _pair(tmp_path)
    jeng, eng, pos, h = _loaded(jcfg, jp, tcfg, tp)
    spec = make_spec_chunk(jcfg)
    j_out, j_n, _, j_h, j_p, j_accs = spec(
        jp, jeng.cache, jnp.asarray(h, jnp.int32), jnp.int32(pos),
        jax.random.PRNGKey(0), n_steps=n_steps, k=k, attn_len=jcfg.seq_len,
        temperature=0.0, top_p=0.9)
    j_n = int(j_n)
    out, n_out, accs, new_pos = spec_chunk(
        eng._run, tcfg, eng._hist, pos, n_steps, k, 0.0, 0.9)
    # every token of the JAX stream is decided: no near-tie on the way
    stream = np.asarray(j_out)[:j_n].tolist()
    margins, scale = _window_margins(jcfg, jp, PROMPT + [h[pos]] + stream)
    assert margins[pos:].min() > 1e-2 * scale + 1e-4
    assert int(n_out) == j_n
    assert out[:j_n].tolist() == stream
    assert accs.tolist() == np.asarray(j_accs).tolist()
    assert int(new_pos) == int(j_p) == pos + j_n
    assert eng._hist.tolist() == np.asarray(j_h).tolist()
    if n_steps > 1:
        # drafts were both accepted and refused
        assert 0 < int(accs.sum()) < n_steps * k


def test_sampled_spec_chunk_first_token_by_distribution(tmp_path):
    """At temperature > 0 a chunk's first token is accepted draft or
    resample, and either way distributed as plain sampling from its row:
    `processed_probs` of the row's logits (the port's forward at pos; the
    JAX package's sampler distribution, tests/test_torch_speculative.py)."""
    jcfg, jp, tcfg, tp = _pair(tmp_path)
    _, eng, pos, h = _loaded(jcfg, jp, tcfg, tp)
    temperature, top_p = 0.03, 0.7
    row = Engine(tcfg, tp, device="cpu")
    row.prefill(PROMPT)
    p0 = processed_probs(row.decode_step(int(h[pos])), temperature,
                         top_p).double().numpy()
    support = np.nonzero(p0 > 0)[0]
    assert 3 <= len(support) <= 40, len(support)
    # the draft's first token is the row's most likely one, so that both
    # the acceptance and the resample branch run: the history (drafts
    # only; the cache holds the prompt) gets the current bigram followed
    # by it just before the bigram itself
    top = int(np.argmax(p0))
    hist = eng._hist
    hist[pos - 4], hist[pos - 3], hist[pos - 2] = hist[pos - 1], hist[pos], top
    n, k = 1000, 2
    gen = torch.Generator().manual_seed(0)
    firsts, accepted = [], 0
    for _ in range(n):
        out, _, accs, _ = spec_chunk(eng._run, tcfg, eng._hist, pos, 1, k,
                                     temperature, top_p, gen)
        firsts.append(int(out[0]))
        accepted += int(accs[0])
    counts = np.bincount(firsts, minlength=tcfg.vocab_size)
    assert counts[p0 == 0].sum() == 0        # nothing outside the nucleus
    exp = p0[support] * n
    chi2 = float(((counts[support] - exp) ** 2 / exp).sum())
    assert chi2 < scipy.stats.chi2.ppf(0.999, len(support) - 1), chi2
    assert 0 < accepted < n


def test_one_host_read_a_chunk(tmp_path, monkeypatch):
    """A non-streaming speculative generation reads the device once a
    chunk plus a constant (the first token); a plain chunked generation
    once in all.  Counted on Tensor.item, .tolist and .cpu."""
    _, _, tcfg, tp = _pair(tmp_path)
    eng = Engine(tcfg, tp, device="cpu", decode_chunk=4)
    reads = []
    for name in ("item", "tolist", "cpu"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            reads.append(_name)
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    k, n_new = 3, 40
    out = eng.generate(PROMPT, GenerationConfig(
        temperature=0.0, max_new_tokens=n_new, speculative_k=k))
    chunks = eng.metrics.spec_proposed // (eng.decode_chunk * k)
    assert len(out) == n_new and chunks >= 2
    assert len(reads) <= chunks + 1, (reads, chunks)
    reads.clear()
    eng.reset()
    out = eng.generate(PROMPT, GenerationConfig(temperature=0.0,
                                                max_new_tokens=n_new))
    assert len(out) == n_new and reads == ["tolist"]


def test_profile_trace_writes_a_trace(tmp_path):
    _, _, tcfg, tp = _pair(tmp_path)
    eng = Engine(tcfg, tp, device="cpu")
    eng.warmup()
    assert eng.pos == 0
    log_dir = tmp_path / "trace"
    with eng.profile_trace(str(log_dir)) as prof:
        eng.generate(PROMPT, GenerationConfig(temperature=0.0,
                                              max_new_tokens=10))
    files = glob.glob(os.path.join(str(log_dir), "*.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    assert any("aten::" in e.key for e in prof.key_averages())
