"""Kernels K (`ffn_fused_xe`) and L (`ffn_fused`), the fused FFN, on the
CPU (their plain versions) against the JAX package's fused FFN kernels in
interpret mode, and the FFN dispatch of `models.transformer._layer_post`.

- K against `ffn_fused_xe_stacked` (`_ffn_xe_kernel`, weights stacked to
  one layer) at T 1, 5 and 8; L against `ffn_fused_pallas`
  (`_ffn_kernel`) at T 9 and 16; Q4_0 and Q8_0, silu and tanh-GELU.  The
  JAX side takes its loader's Q4 w13 rows in `ffn_split_perm` order, the
  port the logical order.
- Tolerance: 1e-3 of max|y|.  Both sides take the same bf16 operands,
  exact products and f32 sums, in another order; the GLU output is
  rounded to bf16 once on each side, and a last-bit difference of the f32
  gate or up flips the rounding of a few g values by one bf16 step (2^-8
  of the value).  One flip moves an output by |w2 * dg|, at most ~2e-4 of
  max|y| here (|y| ~ sqrt(H) |w2| |g|); the bound leaves room for a few
  on one output.  Measured: 1e-7 of max|y| without a flip, 1e-5 with one.
  The JAX package's own tolerance for these kernels against float math is
  rtol 5e-2, atol 0.12 (tests/test_kernels.py).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.kernels.fused_ffn import ffn_fused_pallas, ffn_fused_xe_stacked
from lmrs_tpu.kernels.fused_ffn import ffn_split_perm as jax_split_perm
from lmrs_tpu.quant import QuantType as JQuantType
from lmrs_tpu.quant import qtensor_from_float_np

from lmrs_tpu_torch.config import ModelType, QuantType
from lmrs_tpu_torch.io.lmrs import read_lmrs
from lmrs_tpu_torch.io.params import params_from_lmrs
from lmrs_tpu_torch.io.synthetic import tiny_config, write_synthetic_lmrs
from lmrs_tpu_torch.kernels import launches, reset_launches
from lmrs_tpu_torch.kernels.ffn_fused import (ffn_fused, ffn_fused_xe,
                                              ffn_split_perm)
from lmrs_tpu_torch.models import transformer
from lmrs_tpu_torch.models.transformer import (embed_tokens, forward,
                                               init_kv_cache)

torch.set_num_threads(1)
# the module: the package's `kernels.ffn_fused` attribute is the wrapper
ffn_module = importlib.import_module("lmrs_tpu_torch.kernels.ffn_fused")

D, H, GS = 256, 512, 64
TOL = 1e-3


def _case(quant, t, seed):
    """x (T, D) and the FFN's weights: the JAX QTensors (w13 rows
    permuted for Q4, stacked to one layer when `stacked`) and the port's
    (q, s) tensors in the logical order."""
    rng = np.random.default_rng(seed)
    w13 = rng.normal(0, 0.1, (2 * H, D)).astype(np.float32)
    w2 = rng.normal(0, 0.1, (D, H)).astype(np.float32)
    x = rng.normal(0, 1, (t, D)).astype(np.float32)
    jq = JQuantType.Q4_0 if quant == "q4" else JQuantType.Q8_0
    perm = np.arange(2 * H)
    if quant == "q4":
        p = jax_split_perm(H, GS)
        perm = np.concatenate([p, H + p])
    port = [qtensor_from_float_np(w, jq, GS) for w in (w13, w2)]
    port = [t_ for qt in port for t_ in (torch.from_numpy(np.array(qt.q)),
                                         torch.from_numpy(np.array(qt.s)))]
    return x, w13[perm], w2, jq, port


def _jax_pair(w13p, w2, jq, stacked):
    lead = (lambda w: w[None]) if stacked else (lambda w: w)
    return (qtensor_from_float_np(lead(w13p), jq, GS),
            qtensor_from_float_np(lead(w2), jq, GS))


def test_split_perm_is_the_jax_one():
    for h, gs in ((512, 64), (14336, 128), (8192, 32)):
        np.testing.assert_array_equal(ffn_split_perm(h, gs),
                                      jax_split_perm(h, gs))


@pytest.mark.parametrize("quant", ["q4", "q8"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("t", [1, 5, 8])
def test_ffn_fused_xe_plain_matches_jax(quant, act, t):
    """Reference: ffn_fused_xe_stacked -> _ffn_xe_kernel (fused_ffn.py:526)."""
    x, w13p, w2, jq, port = _case(quant, t, seed=10 * t + len(act))
    j13, j2 = _jax_pair(w13p, w2, jq, stacked=True)
    want = np.asarray(ffn_fused_xe_stacked(jnp.asarray(x), j13, j2, 0,
                                           act=act, interpret=True))
    reset_launches()
    got = ffn_fused_xe(torch.from_numpy(x), *port, GS, act).numpy()
    assert launches()["ffn_fused_xe"] == 0      # CPU: the plain version
    assert got.shape == (t, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("quant", ["q4", "q8"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("t", [9, 16])
def test_ffn_fused_plain_matches_jax(quant, act, t):
    """Reference: ffn_fused_pallas -> _ffn_kernel (fused_ffn.py:242)."""
    x, w13p, w2, jq, port = _case(quant, t, seed=10 * t + len(act))
    j13, j2 = _jax_pair(w13p, w2, jq, stacked=False)
    want = np.asarray(ffn_fused_pallas(jnp.asarray(x), j13, j2, act=act,
                                       interpret=True))
    reset_launches()
    got = ffn_fused(torch.from_numpy(x), *port, GS, act).numpy()
    assert launches()["ffn_fused"] == 0
    assert got.shape == (t, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_plain_versions_reject_an_unknown_activation():
    x, _, _, _, port = _case("q8", 1, seed=0)
    with pytest.raises(ValueError, match="act"):
        ffn_fused_xe(torch.from_numpy(x), *port, GS, "relu")


def _tiny(tmp_path, quant):
    """A tiny Llama with fuse_ffn on, weights of std 0.1 from seed 2."""
    cfg = tiny_config(ModelType.LLAMA, quant, dim=128, hidden_dim=256,
                      n_layers=2, seq_len=64)
    path = str(tmp_path / "m.lmrs")
    write_synthetic_lmrs(path, cfg, seed=2, scale=0.1)
    f = read_lmrs(path)
    return f.cfg.replace(fuse_ffn=True), params_from_lmrs(f, device="cpu")


def _spy(monkeypatch):
    """Count the fused wrappers' calls from _layer_post by row count."""
    calls = []

    def wrap(name, fn):
        def spy(x, *a):
            calls.append((name, x.shape[0]))
            return fn(x, *a)
        return spy
    monkeypatch.setattr(transformer, "ffn_fused_xe",
                        wrap("xe", ffn_module.ffn_fused_xe))
    monkeypatch.setattr(transformer, "ffn_fused",
                        wrap("bf16", ffn_module.ffn_fused))
    return calls


@pytest.mark.parametrize("quant", [QuantType.Q4_0, QuantType.Q8_0])
def test_layer_post_dispatch(tmp_path, monkeypatch, quant):
    """fuse_ffn on: T <= 8 rows take K, 9..16 take L, more the unfused
    matmuls; the fused FFN holds the unfused one's logits to 1e-2 of
    their scale (bf16 g and bf16 x in place of kernel A's / D's f32 or
    W8A8 activations)."""
    calls = _spy(monkeypatch)
    cfg, params = _tiny(tmp_path, quant)
    ref_cfg = cfg.replace(fuse_ffn=False)
    toks = torch.arange(3, 3 + 24) % cfg.vocab_size
    for t, want in ((1, "xe"), (5, "xe"), (8, "xe"), (9, "bf16"),
                    (16, "bf16"), (17, None), (24, None)):
        calls.clear()
        x = embed_tokens(params, cfg, toks[:t])
        got = forward(params, cfg, init_kv_cache(cfg, "cpu"), x, 0, t - 1)
        assert calls == ([] if want is None else
                         [(want, t)] * cfg.n_layers), (t, calls)
        ref = forward(params, ref_cfg, init_kv_cache(ref_cfg, "cpu"), x, 0,
                      t - 1)
        if want is None:
            assert torch.equal(got, ref)
        else:
            err = (got - ref).abs().max().item()
            assert err <= 1e-2 * ref.abs().max().item() + 1e-4, (t, err)


def test_float_weights_take_the_unfused_path(tmp_path, monkeypatch):
    """NONE weights ignore fuse_ffn: the JAX dispatch checks no weight type
    and sends float weights into its Q4 branch (ffn_fused_xe_stacked) or
    raises (ffn_fused_pallas); the port runs the f32 matmuls."""
    calls = _spy(monkeypatch)
    cfg, params = _tiny(tmp_path, QuantType.NONE)
    ref_cfg = cfg.replace(fuse_ffn=False)
    for t in (1, 5, 12):
        x = embed_tokens(params, cfg, torch.arange(1, 1 + t))
        got = forward(params, cfg, init_kv_cache(cfg, "cpu"), x, 0, t - 1)
        ref = forward(params, ref_cfg, init_kv_cache(ref_cfg, "cpu"), x, 0,
                      t - 1)
        assert torch.equal(got, ref)
    assert calls == []
