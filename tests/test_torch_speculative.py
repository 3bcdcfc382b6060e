"""The port's prompt-lookup speculative decoding against the JAX package on
the CPU: `lookup_draft` (equal integers), `rejection_accept` (its
deterministic parts exactly, its draws by distribution: the two packages'
random streams differ), `forward(..., logit_idx="all")` against the JAX
forward, and the Engine's speculative loop against its own plain greedy
decoding.

Tolerances, stated at each assert:
- lookup_draft: equal integers.
- rejection_accept: chi-square against the analytic distribution at
  alpha = 0.001 with fixed seeds, as tests/test_speculative_sampling.py.
- All-row logits: max |difference| <= 1e-2 * max |logit| + 1e-4, the bound
  of tests/test_torch_transformer.py (plus the W8A8 noise term of
  tests/test_torch_q8_model.py for Q8_0 weights).
- Speculative greedy vs plain greedy: equal tokens up to the first plain
  step whose top-2 logit margin is below 1e-4 of the logit scale.  On the
  CPU the plain versions of the kernels compute each row of a T = k+1
  window with one matrix product over all rows, whose sums may be taken in
  another order than a single row's: a near-tie may then fall the other
  way.  (With these seeds every run is in fact equal to the end.)
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
from lmrs_tpu.runtime.speculative import lookup_draft as jax_lookup_draft

from lmrs_tpu_torch.config import QuantType, tiny_gemma, tiny_llama
from lmrs_tpu_torch.io.lmrs import read_lmrs
from lmrs_tpu_torch.io.params import params_from_lmrs
from lmrs_tpu_torch.io.synthetic import write_synthetic_lmrs
from lmrs_tpu_torch.models.transformer import (embed_tokens, forward,
                                               init_kv_cache)
from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
from lmrs_tpu_torch.runtime.speculative import (first_miss, lookup_draft,
                                                rejection_accept)
from test_torch_transformer import build_pair

# tiny models gain nothing from intra-op threads, and several test
# processes side by side, each with a thread per core, slow one another
# tenfold
torch.set_num_threads(1)

# chi-square critical values at alpha = 0.001 (7 degrees of freedom)
CHI2_001_7 = 24.32

# the three prompts of tests/test_speculative.py
PROMPTS = [[3, 17, 42, 7, 99, 23, 5],
           [5, 9, 11, 5, 9, 11, 5, 9, 11, 5, 9],     # bigrams match at once
           [2]]
CACHES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
          "int4": "int4"}


# ---------------------------------------------------------------- lookup
def _history_cases():
    rng = np.random.default_rng(0)
    S = 64
    cases = []
    for i in range(12):                      # random, small alphabet, -1 runs
        h = rng.integers(0, 4, S).astype(np.int32)
        a = int(rng.integers(0, S - 8))
        h[a:a + int(rng.integers(1, 8))] = -1
        cases.append((h, int(rng.integers(2, S - 1)), 1 + i % 4))
    h = np.arange(S, dtype=np.int32)         # no bigram occurs twice
    cases.append((h.copy(), 40, 4))
    h = rng.integers(10, 50, S).astype(np.int32)
    h[0:2] = [7, 8]                          # the match at the very start
    h[30:32] = [7, 8]
    cases.append((h.copy(), 31, 4))
    h[S - 3:S - 1] = [7, 8]                  # p near S - k: the slice clamps
    cases.append((h.copy(), S - 2, 4))
    cases.append((h.copy(), S - 1, 3))
    cases.append((np.full(S, -1, np.int32), 20, 4))   # nothing known
    cases.append((h.copy(), 1, 2))           # no earlier bigram can exist
    return cases


@pytest.mark.parametrize("case", range(18))
def test_lookup_draft_matches_jax(case):
    h, p, k = _history_cases()[case]
    vmax = 40
    want = np.asarray(jax_lookup_draft(jnp.asarray(h), jnp.int32(p), k, vmax))
    got = lookup_draft(torch.from_numpy(h).long(), p, k, vmax)
    assert got.shape == (k,) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() <= vmax


def test_lookup_draft_takes_the_latest_earlier_occurrence():
    h = torch.full((32,), -1, dtype=torch.long)
    h[:12] = torch.tensor([1, 2, 3, 4, 1, 2, 5, 6, 9, 9, 1, 2])
    # (1, 2) occurs at 0, 4 and 10 = p - 1: the latest with idx < p - 1 is 4
    assert lookup_draft(h, 11, 3, 99).tolist() == [5, 6, 9]
    # unknown rows are clamped to valid ids
    assert lookup_draft(h, 11, 8, 99).tolist() == [5, 6, 9, 9, 1, 2, 0, 0]


# ------------------------------------------------------ rejection sampling
def _chi2(counts, probs):
    exp = probs * counts.sum()
    keep = exp > 1e-9
    return float(((counts[keep] - exp[keep]) ** 2 / exp[keep]).sum())


def _run_many(probs, draft, n_trials, seed):
    gen = torch.Generator().manual_seed(seed)
    p, d = torch.from_numpy(probs), torch.tensor(draft)
    oks, ems = [], []
    for _ in range(n_trials):
        ok, emitted = rejection_accept(p, d, gen)
        oks.append(ok)
        ems.append(emitted)
    return torch.stack(oks).numpy(), torch.stack(ems).numpy()


def test_rejection_accept_first_token_matches_target():
    """The marginal of emitted[0] is p_0, acceptance included."""
    V, k, N = 8, 3, 20000
    p = np.random.default_rng(1).dirichlet(np.ones(V) * 0.7,
                                           size=k + 1).astype(np.float32)
    ok, emitted = _run_many(p, [2, 5, 1], N, seed=0)
    resid = p[0].copy()
    resid[2] = 0.0
    resid /= resid.sum()
    counts = np.bincount(emitted[:, 0][~ok[:, 0]], minlength=V)
    assert _chi2(counts, resid) < CHI2_001_7, "residual draw off target"
    assert abs(ok[:, 0].mean() - p[0][2]) < 4 * np.sqrt(p[0][2] / N) + 0.01
    assert (emitted[ok[:, 0], 0] == 2).all()     # accepted: the draft itself
    assert _chi2(np.bincount(emitted[:, 0], minlength=V),
                 p[0]) < CHI2_001_7


def test_rejection_accept_bonus_token_matches_row_k():
    """Full acceptance draws the bonus from row k without zeroing."""
    V, k = 8, 2
    p = np.full((k + 1, V), 0.02, np.float32)
    p[0, 3] = p[1, 6] = 1 - 0.02 * (V - 1)
    p[2] = np.random.default_rng(2).dirichlet(np.ones(V)).astype(np.float32)
    ok, emitted = _run_many(p, [3, 6], 20000, seed=3)
    full = ok.all(1)
    assert full.mean() > 0.5
    assert _chi2(np.bincount(emitted[full, k], minlength=V),
                 p[2]) < CHI2_001_7


def test_rejection_accept_deterministic_parts():
    V, k = 6, 3
    draft = torch.tensor([1, 4, 2])
    gen = torch.Generator().manual_seed(5)
    # probs one-hot on the draft: every draft is accepted whatever the
    # uniforms, and the bonus comes from row k
    p = torch.zeros(k + 1, V)
    p[torch.arange(k), draft] = 1.0
    p[k, 5] = 1.0
    for _ in range(20):
        ok, emitted = rejection_accept(p, draft, gen)
        assert ok.all() and int(first_miss(ok)) == k
        assert emitted.tolist() == [1, 4, 2, 5]
    # probs[i, draft[i]] = 0: the first rejection is at i, the resample is
    # never the draft token, and the accepted prefix is the draft verbatim
    rows = torch.from_numpy(np.random.default_rng(4).dirichlet(
        np.ones(V), size=k + 1).astype(np.float32))
    for i in range(k):
        q = rows.clone()
        q[:i] = 0.0
        q[torch.arange(i), draft[:i]] = 1.0
        q[i, draft[i]] = 0.0
        q[i] /= q[i].sum()
        for _ in range(50):
            ok, emitted = rejection_accept(q, draft, gen)
            assert int(first_miss(ok)) == i
            assert emitted[:i].tolist() == draft[:i].tolist()
            assert int(emitted[i]) != int(draft[i])
    # fixed uniforms fix the acceptance tests
    u = torch.tensor([0.0, 0.999, 0.0])
    ok, emitted = rejection_accept(rows, draft, gen, uniforms=u)
    assert ok.tolist() == [True, bool(0.999 < rows[1, 4]), True]
    assert first_miss(torch.tensor([True, True, False])).item() == 2
    assert first_miss(torch.tensor([False, True, True])).item() == 0


# ------------------------------------------------------- all-row logits
@pytest.mark.parametrize("name,quant,cfg_kw", [
    ("tiny-gemma", JQuantType.Q4_0, dict(final_logit_softcap=0.5)),
    ("tiny-gemma", JQuantType.Q4_0, dict(final_logit_softcap=0.5,
                                         parity_gemma_softcap_bug=True)),
    ("tiny-llama", JQuantType.Q8_0, {})])
def test_all_row_logits_match_jax(tmp_path, monkeypatch, name, quant, cfg_kw):
    """A verify window (T = 5 after a 19-token prompt) with logits for
    every row, the Gemma softcap on all logits and on the first `dim`
    only."""
    monkeypatch.delenv("LMRS_W8A8", raising=False)
    jcfg, jp, tcfg, tp = build_pair(tmp_path, name, quant=quant, **cfg_kw)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, 24)
    fwd = jax.jit(partial(jax_forward, cfg=jcfg, attn_len=jcfg.seq_len,
                          logit_idx="all"))
    jcache = jax_init_kv_cache(jcfg, jnp.bfloat16)
    tcache = init_kv_cache(tcfg, "cpu")
    other = init_kv_cache(tcfg, "cpu")
    pos = 0
    for chunk in (toks[:19], toks[19:24]):
        x = jax_embed(jp, jcfg, jnp.asarray(chunk, jnp.int32))
        want, jcache = fwd(jp, cache=jcache, x=x, pos=jnp.int32(pos))
        want = np.asarray(want)
        tx = embed_tokens(tp, tcfg, torch.from_numpy(chunk))
        got = forward(tp, tcfg, tcache, tx, pos, "all").numpy()
        assert got.shape == want.shape == (len(chunk), tcfg.vocab_size)
        scale = np.abs(want).max()
        if cfg_kw.get("final_logit_softcap") is not None:
            scale = max(scale, 2 * cfg_kw["final_logit_softcap"])
        tol = 1e-2 * scale + 1e-4
        # the same rows with W8A8 off: for Q8_0 weights two W8A8 runs draw
        # the activation-quantization noise anew
        # (tests/test_torch_q8_model.py), so twice its measured size is
        # added; for Q4_0 weights the switch changes nothing
        noise = forward(tp, tcfg, other, tx, pos, "all", w8a8=False).numpy()
        if quant == JQuantType.Q8_0:
            tol += 2 * np.abs(got - noise).max()
        else:
            np.testing.assert_array_equal(got, noise)
        assert np.abs(got - want).max() <= tol
        pos += len(chunk)
    cap = cfg_kw.get("final_logit_softcap")
    if cap is not None:
        assert np.abs(got[:, :tcfg.dim]).max() <= cap
        assert (np.abs(got[:, tcfg.dim:]).max() > cap) == \
            tcfg.parity_gemma_softcap_bug
    with pytest.raises(ValueError, match="'all'"):
        forward(tp, tcfg, tcache, tx, 0, "every")


# ------------------------------------------------------------ the engine
def _engine(tmp_path, family, cache, seed=11, **cfg_kw):
    """tiny-llama Q8_0 or tiny-gemma Q4_0 with weights of std 0.1 (greedy
    streams that are not one repeated token)."""
    make, quant = {"llama": (tiny_llama, QuantType.Q8_0),
                   "gemma": (tiny_gemma, QuantType.Q4_0)}[family]
    cfg = make(quant=quant).replace(**cfg_kw)
    path = str(tmp_path / f"{family}{seed}.lmrs")
    write_synthetic_lmrs(path, cfg, seed=seed, scale=0.1)
    f = read_lmrs(path)
    return Engine(f.cfg, params_from_lmrs(f, device="cpu"), device="cpu",
                  cache_dtype=CACHES[cache], prefill_chunk=8)


def plain_greedy(eng, prompt, n):
    """(tokens, top-2 margin of each step over its largest |logit|) of
    plain greedy decoding, step by step."""
    eng.reset()
    logits = eng.prefill(prompt)
    toks, margins = [], []
    for _ in range(n):
        top = torch.topk(logits, 2)
        toks.append(int(top.indices[0]))
        margins.append(float(top.values[0] - top.values[1])
                       / float(logits.abs().max()))
        if eng.pos >= eng.cfg.seq_len:
            break
        logits = eng.decode_step(toks[-1])
    return toks, margins


def assert_same_up_to_near_tie(got, want, margins, least):
    close = [i for i, m in enumerate(margins) if m < 1e-4]
    n_eq = close[0] if close else len(want)
    assert n_eq >= least, margins
    assert got[:n_eq] == want[:n_eq]


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_speculative_greedy_matches_plain_greedy(tmp_path, family, cache):
    eng = _engine(tmp_path, family, cache)
    n_new = 32
    for prompt, k in zip(PROMPTS, (4, 3, 4)):
        want, margins = plain_greedy(eng, prompt, n_new)
        eng.reset()
        assert eng.generate(prompt, GenerationConfig(
            temperature=0.0, max_new_tokens=n_new)) == want
        eng.reset()
        got = eng.generate(prompt, GenerationConfig(
            temperature=0.0, max_new_tokens=n_new, speculative_k=k))
        assert len(got) == n_new
        assert_same_up_to_near_tie(got, want, margins, least=8)
        m = eng.metrics
        assert m.spec_proposed > 0 and m.spec_proposed % k == 0
        assert 0 <= m.spec_accepted <= m.spec_proposed
        assert m.decode_tokens == n_new - 1


def test_speculative_accepts_on_looping_output(tmp_path):
    """Once a greedy stream cycles, the lookup's draft is the argmax
    continuation and drafts are accepted; fewer verify steps than
    tokens."""
    eng = _engine(tmp_path, "llama", "f32")
    want, margins = plain_greedy(eng, [3, 8, 1], 64)
    seen, cyclic = {}, False
    for i in range(len(want) - 2):
        key = (want[i], want[i + 1])
        if key in seen and want[seen[key] + 2] == want[i + 2]:
            cyclic = True
            break
        seen[key] = i
    assert cyclic, "the plain output does not loop; pick another seed"
    eng.reset()
    got = eng.generate([3, 8, 1], GenerationConfig(
        temperature=0.0, max_new_tokens=64, speculative_k=4))
    assert_same_up_to_near_tie(got, want, margins, least=24)
    m = eng.metrics
    assert m.spec_accepted > 0
    assert m.spec_proposed // 4 < 63        # fewer steps than tokens


def test_speculative_stop_token_and_second_turn(tmp_path):
    """A stop token inside an accepted run truncates `pos` and the history
    at that token: the second turn equals the plain engine's."""
    eng_p = _engine(tmp_path, "llama", "f32")
    eng_s = _engine(tmp_path, "llama", "f32")
    gen0 = GenerationConfig(temperature=0.0, max_new_tokens=40)
    genk = GenerationConfig(temperature=0.0, max_new_tokens=40,
                            speculative_k=3)
    plain = eng_p.generate(PROMPTS[0], gen0)
    stop_tok = plain[len(plain) // 2]
    eng_p.reset()
    want = eng_p.generate(PROMPTS[0], gen0, stop_tokens=[stop_tok])
    seen = []
    got = eng_s.generate(PROMPTS[0], genk, stop_tokens=[stop_tok],
                         on_token=seen.append)
    assert got == want == seen and got[-1] == stop_tok
    assert eng_p.pos == eng_s.pos
    n = eng_s.pos + 1
    assert torch.equal(eng_s._hist[:n], eng_p._hist[:n])
    assert eng_s._hist[:n].tolist() == PROMPTS[0] + got
    want2 = eng_p.generate([7, 7, 2], gen0)
    got2 = eng_s.generate([7, 7, 2], genk)
    assert got2 == want2


def test_speculative_stops_before_the_context_end(tmp_path):
    """The loop dispatches a chunk of n_steps verify steps only while its
    worst case fits, pos + n_steps * (k+1) + 1 < seq_len (the JAX engine's
    rule): no row and no history entry is written past seq_len, and the
    tokens are a prefix of the plain run's."""
    eng = _engine(tmp_path, "llama", "f32", seq_len=48)
    eng.decode_chunk = n_steps = 2
    prompt = PROMPTS[1]
    want, margins = plain_greedy(eng, prompt, 64)
    assert len(want) == 48 - len(prompt) + 1        # plain fills the context
    eng.reset()
    k = 4
    got = eng.generate(prompt, GenerationConfig(
        temperature=0.0, max_new_tokens=64, speculative_k=k))
    assert eng.pos + n_steps * (k + 1) + 1 >= eng.cfg.seq_len > eng.pos
    assert eng.metrics.spec_proposed > 0
    assert len(got) == eng.pos - len(prompt) + 1
    assert_same_up_to_near_tie(got, want[:len(got)], margins[:len(got)],
                               least=8)
    assert eng._hist.shape == (48,)
    # a k too large for the context never verifies: one token, no proposal
    eng.reset()
    one = eng.generate(prompt, GenerationConfig(
        temperature=0.0, max_new_tokens=64, speculative_k=40))
    assert one == want[:1] and eng.metrics.spec_proposed == 0


def test_speculative_sampling_is_reproducible_and_degenerates_to_greedy(
        tmp_path):
    eng = _engine(tmp_path, "llama", "bf16")
    outs = []
    for seed in (7, 7, 8):
        eng.reset()
        outs.append(eng.generate([1, 5, 9, 2, 5, 9], GenerationConfig(
            temperature=0.9, top_p=0.9, seed=seed, max_new_tokens=24,
            speculative_k=3)))
        assert len(outs[-1]) == 24 and eng.metrics.spec_proposed > 0
    assert outs[0] == outs[1] and outs[0] != outs[2]
    # top_p -> 0 leaves the argmax alone in the nucleus: the sampled
    # speculative stream is the greedy stream
    want, margins = plain_greedy(eng, [1, 5, 9], 16)
    eng.reset()
    got = eng.generate([1, 5, 9], GenerationConfig(
        temperature=1.5, top_p=1e-6, seed=3, max_new_tokens=16,
        speculative_k=3))
    assert_same_up_to_near_tie(got, want, margins, least=8)
