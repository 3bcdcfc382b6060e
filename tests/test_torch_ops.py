"""lmrs_tpu_torch.ops against lmrs_tpu.ops: norms, activations, RoPE
tables and rotation, the plain attention in both precisions, the sampler's
distribution, greedy argmax, and a chi-squared test of top-p draws.

Tolerances (each stated at its assert): RoPE tables are bit-exact (the
same float64 numpy code); elementwise float32 ops agree to 1e-6 relative
(libm vs XLA's tanh/exp differ in the last ulps); attention agrees to
2e-5 (highest: float32 sums in another order) and 2e-3 (fast: bf16
operands, as tests/test_kernels.py holds the bf16 kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import lmrs_tpu.config as jc
import lmrs_tpu.ops.activations as ja
import lmrs_tpu.ops.norms as jn
import lmrs_tpu.ops.rope as jr
import lmrs_tpu.ops.sampling as js
from lmrs_tpu.ops.attention import attention as jax_attention

import lmrs_tpu_torch.config as tc
import lmrs_tpu_torch.ops.activations as ta
import lmrs_tpu_torch.ops.norms as tn
import lmrs_tpu_torch.ops.rope as tr
import lmrs_tpu_torch.ops.sampling as ts
from lmrs_tpu_torch.ops.attention import attention

RNG = np.random.default_rng(0)


@pytest.mark.parametrize("unit_offset", [False, True])
def test_rmsnorm(unit_offset):
    x = RNG.normal(0, 2, (7, 96)).astype(np.float32)
    w = RNG.normal(0, 0.1, (96,)).astype(np.float32)
    want = np.asarray(jn.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6,
                                 unit_offset))
    got = tn.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6,
                     unit_offset).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fn", ["gelu_tanh", "silu"])
def test_activations(fn):
    x = RNG.normal(0, 3, (4, 257)).astype(np.float32)
    want = np.asarray(getattr(ja, fn)(jnp.asarray(x)))
    got = getattr(ta, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("preset", ["gemma2-9b", "llama3.2-1b",
                                    "phi3.5-mini"])
def test_rope_tables_and_rotation(preset):
    jcfg = jc.PRESETS[preset]().replace(seq_len=1024)
    tcfg = tc.PRESETS[preset]().replace(seq_len=1024)
    jcos, jsin = jr.rope_tables(jcfg)
    tcos, tsin = tr.rope_tables(tcfg)
    np.testing.assert_array_equal(tcos, jcos)       # bit-exact: same numpy
    np.testing.assert_array_equal(tsin, jsin)
    x = RNG.normal(0, 1, (5, 3, tcfg.head_dim)).astype(np.float32)
    rows = slice(700, 705)
    want = np.asarray(jr.apply_rope(jnp.asarray(x), jnp.asarray(jcos[rows]),
                                    jnp.asarray(jsin[rows])))
    got = tr.apply_rope(torch.from_numpy(x), torch.from_numpy(tcos[rows]),
                        torch.from_numpy(tsin[rows])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("precision,tol", [("highest", 2e-5),
                                           ("fast", 2e-3)])
@pytest.mark.parametrize("softcap,window", [(None, None), (50.0, 4096),
                                            (50.0, 40)])
def test_attention_matches_jax(precision, tol, softcap, window):
    t, h, kh, hd, s = 5, 8, 2, 64, 96
    q = RNG.normal(0, 1, (t, h, hd)).astype(np.float32)
    k = RNG.normal(0, 1, (s, kh, hd)).astype(np.float32)
    v = RNG.normal(0, 1, (s, kh, hd)).astype(np.float32)
    for pos in (0, 50, s - t):
        want = np.asarray(jax_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
            scale=hd ** -0.5, softcap=softcap, window=window,
            precision=precision))
        got = attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), pos, scale=hd ** -0.5,
                        softcap=softcap, window=window,
                        precision=precision).numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("temperature,top_p", [(0.7, 0.9), (1.3, 0.5),
                                               (0.8, 1.0)])
def test_processed_probs_match_jax(temperature, top_p):
    logits = RNG.normal(0, 2, (3, 500)).astype(np.float32)
    want = np.asarray(js.processed_probs(jnp.asarray(logits),
                                         jnp.float32(temperature),
                                         jnp.float32(top_p)))
    got = ts.processed_probs(torch.from_numpy(logits), temperature,
                             top_p).numpy()
    # float32 softmax/cumsum in another summation order: 1e-6 absolute
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert ((got > 0) == (want > 0)).all()      # the same nucleus


def test_greedy_argmax_matches_jax():
    logits = RNG.normal(0, 1, (64, 1000)).astype(np.float32)
    logits[3, [10, 700]] = 9.0                  # tie: the earliest index
    want = np.asarray(js.sample_argmax(jnp.asarray(logits)))
    got = ts.sample_argmax(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[3] == 10
    assert ts.sample(torch.from_numpy(logits[0]), 0.0, 0.9, None) == want[0]


def test_topp_samples_chi_squared():
    """Draws of sample_topp follow processed_probs (chi-squared goodness of
    fit at p > 1e-3), and never leave the nucleus."""
    logits = torch.from_numpy(RNG.normal(0, 1.5, (40,)).astype(np.float32))
    temperature, top_p, n = 0.8, 0.85, 8000
    p = ts.processed_probs(logits, temperature, top_p).numpy()
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([ts.sample_topp(logits, temperature, top_p, gen)
                         for _ in range(n)]).numpy()
    counts = np.bincount(draws, minlength=40)
    assert counts[p == 0].sum() == 0
    keep = p > 0
    pk = p[keep].astype(np.float64)
    _, pval = stats.chisquare(counts[keep], pk / pk.sum() * n)
    assert pval > 1e-3, pval
    # and the JAX package's sampler draws from the same distribution
    keys = jax.random.split(jax.random.PRNGKey(0), 2000)
    jd = np.asarray(jax.vmap(lambda k: js.sample_topp(
        jnp.asarray(logits.numpy()), temperature, top_p, k))(keys))
    jcounts = np.bincount(jd, minlength=40)
    assert jcounts[p == 0].sum() == 0
    _, pval = stats.chisquare(jcounts[keep], pk / pk.sum() * len(jd))
    assert pval > 1e-3, pval
