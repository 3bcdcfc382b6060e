"""The port's perplexity harness, `scripts/torch_perplexity.py` (CPU, the
kernels' plain versions), against the JAX harness `scripts/perplexity.py`
on the same dense weights (through each package's
`params_from_weights`), and `io.params.params_from_weights` against the
JAX one.

Tolerances (NLL per token):
- f32 weights: 1e-4.  Both sides take f32 products; the caches and
  softmax differ in rounding only.
- Q8_0 and Q4_0 weights: 1e-3.  Every chunk has more than 8 rows, so both
  sides take their bf16-activation GEMM (the JAX stacked kernels in
  interpret mode, the port's B and F plain versions) with f32 sums in
  another order; bf16 K/V and softmax-weight rounding add the rest.
- chunk invariance and the seq_len boundary: 1e-4, as the JAX tests.
- params_from_weights: bit for bit.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

from lmrs_tpu.config import ModelType as JModelType  # noqa: E402
from lmrs_tpu.io.params import \
    params_from_weights as jax_params_from_weights  # noqa: E402
from lmrs_tpu.io.synthetic import \
    random_weights as jax_random_weights  # noqa: E402
from lmrs_tpu.io.synthetic import tiny_config as jax_tiny_config  # noqa: E402
from lmrs_tpu.quant import QuantType as JQuantType  # noqa: E402
from lmrs_tpu.runtime.engine import CACHE_DTYPES as JAX_CACHE  # noqa: E402
from perplexity import _compare as jax_compare  # noqa: E402
from perplexity import score_tokens as jax_score_tokens  # noqa: E402
from torch_perplexity import (MATCHED, _compare, main,  # noqa: E402
                              score_tokens)

from lmrs_tpu_torch.config import ModelType, QuantType  # noqa: E402
from lmrs_tpu_torch.io.lmrs import write_lmrs  # noqa: E402
from lmrs_tpu_torch.io.params import (params_from_jax,  # noqa: E402
                                      params_from_weights)
from lmrs_tpu_torch.io.synthetic import random_weights, tiny_config  # noqa
from lmrs_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from test_torch_io import jax_param_arrays  # noqa: E402

torch.set_num_threads(1)

# 137 tokens in chunks of 32: four full chunks and a 9-row tail, so every
# chunk takes the T > 8 kernels
N_TOKENS, CHUNK = 137, 32
TOL = {"NONE": 1e-4, "Q8_0": 1e-3, "Q4_0": 1e-3}


def tiny(mt=ModelType.LLAMA, quant=QuantType.NONE, **kw):
    """The port's config and the JAX package's of one tiny model (the JAX
    harness's `_compare` sizes; its matmul_impl: "exact" for f32 weights,
    "fast" for quantized ones)."""
    kw = dict(dim=128, hidden_dim=256, n_layers=2, vocab_size=512,
              group_size=32, seq_len=256, **kw)
    impl = "exact" if quant == QuantType.NONE else "fast"
    return (tiny_config(mt, quant, **kw),
            jax_tiny_config(JModelType(int(mt)), JQuantType(int(quant)),
                            **kw).replace(matmul_impl=impl))


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8", "int4"])
@pytest.mark.parametrize("quant", ["NONE", "Q8_0", "Q4_0"])
def test_score_tokens_matches_jax(quant, cache):
    """The same dense weights through each package's params_from_weights
    (the JAX one as its harness calls it; the port's equals params_from_jax
    of the JAX one, below)."""
    tcfg, jcfg = tiny(quant=QuantType[quant])
    weights = random_weights(tcfg, seed=0)
    jp = jax_params_from_weights(jcfg, weights)
    tp = params_from_weights(tcfg, weights, device="cpu")
    tokens = np.random.default_rng(4).integers(1, 511, N_TOKENS)
    want = jax_score_tokens(jcfg, jp, tokens, chunk=CHUNK,
                            cache_dtype=JAX_CACHE[cache])
    got = score_tokens(tcfg, tp, tokens, chunk=CHUNK, cache_dtype=cache)
    assert got["tokens_scored"] == want["tokens_scored"] == N_TOKENS - 1
    assert np.isfinite(got["nll_per_token"])
    assert abs(got["nll_per_token"] - want["nll_per_token"]) < TOL[quant], \
        (got, want)


def test_compare_quant_matched_and_as_jax(capsys):
    r = _compare("tiny-llama", n_tokens=128, gs=32, seed=0, device="cpu")
    out = capsys.readouterr().out
    f32 = r["NONE"]["nll_per_token"]
    assert np.isfinite(f32) and f32 > 0
    for name in ("Q8_0", "Q4_0"):
        assert abs(r[name]["nll_per_token"] - f32) < MATCHED, (name, r)
        assert f"{name} nll delta vs f32" in out and "(matched)" in out
    # the same weights and tokens as the JAX study (its f32 model takes
    # matmul_impl "exact", whose f32 products agree to the same 1e-4)
    want = jax_compare("tiny-llama", n_tokens=128, gs=32, seed=0,
                       impl="fast")
    for name in ("NONE", "Q8_0", "Q4_0"):
        assert abs(r[name]["nll_per_token"]
                   - want[name]["nll_per_token"]) < TOL[name], name


@pytest.mark.parametrize("quant", ["Q8_0", "Q4_0"])
def test_score_chunking_invariant(quant):
    """Chunks of 16 and of 64 rows (tails of 9 and 41): teacher-forced
    prefill is position-exact across chunk boundaries."""
    cfg = tiny_config(ModelType.GEMMA, QuantType[quant], dim=64,
                      hidden_dim=128, n_layers=2, vocab_size=256,
                      group_size=32, seq_len=128)
    params = params_from_weights(cfg, random_weights(cfg, seed=5), "cpu")
    tokens = np.random.default_rng(2).integers(1, 250, size=105)
    a = score_tokens(cfg, params, tokens, chunk=16)
    b = score_tokens(cfg, params, tokens, chunk=64)
    assert a["tokens_scored"] == b["tokens_scored"] == 104
    assert abs(a["nll_per_token"] - b["nll_per_token"]) < 1e-4, (a, b)


def test_score_up_to_seq_len():
    """A stream of exactly seq_len tokens whose last chunk is shorter than
    the chunk scores as with plenty of headroom (the JAX harness once
    clamped such a tail's cache write back over real history)."""
    cfg = tiny_config(ModelType.LLAMA, QuantType.Q8_0, dim=64,
                      hidden_dim=128, n_layers=2, vocab_size=256,
                      group_size=32, seq_len=300)
    weights = random_weights(cfg, seed=5)
    tokens = np.random.default_rng(3).integers(1, 250, size=300)
    a = score_tokens(cfg, params_from_weights(cfg, weights, "cpu"), tokens,
                     chunk=128)
    big = cfg.replace(seq_len=512)
    b = score_tokens(big, params_from_weights(big, weights, "cpu"), tokens,
                     chunk=128)
    assert a["tokens_scored"] == b["tokens_scored"] == 299
    assert abs(a["nll_per_token"] - b["nll_per_token"]) < 1e-4, (a, b)
    with pytest.raises(ValueError, match="seq_len"):
        score_tokens(cfg, params_from_weights(cfg, weights, "cpu"),
                     np.ones(301, np.int64))


@pytest.mark.parametrize("quant", ["NONE", "Q8_0", "Q4_0"])
@pytest.mark.parametrize("mt", [ModelType.GEMMA, ModelType.PHI])
def test_params_from_weights_equals_params_from_jax(mt, quant):
    kw = {"n_kv_heads": 4} if mt == ModelType.PHI else {}
    tcfg, jcfg = tiny(mt, QuantType[quant], **kw)
    weights = random_weights(tcfg, seed=7)
    jp = jax_params_from_weights(jcfg, jax_random_weights(jcfg, 7),
                                 stack_layers=True, fuse_qkv=True)
    want = params_from_jax(tcfg, jax_param_arrays(jp), device="cpu")
    got = params_from_weights(tcfg, weights, device="cpu")

    def same(a, b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)

    def same_q(a, b):
        same(a.q, b.q)
        assert (a.s is None) == (b.s is None)
        if a.s is not None:
            same(a.s, b.s)
        assert (a.qtype, a.group_size, a.out_features, a.in_features) == \
            (b.qtype, b.group_size, b.out_features, b.in_features)

    same_q(got.embed, want.embed)
    assert (got.lm_head is None) == (mt != ModelType.PHI)
    if got.lm_head is not None:
        same_q(got.lm_head, want.lm_head)
    same(got.final_norm, want.final_norm)
    same(got.rope_cos, want.rope_cos)
    for lg, lw in zip(got.layers, want.layers, strict=True):
        for name in ("wqkv", "wo", "w13", "w2"):
            same_q(getattr(lg, name), getattr(lw, name))
        for name in ("att_norm", "post_att_norm", "pre_ffn_norm",
                     "post_ffn_norm"):
            a, b = getattr(lg, name), getattr(lw, name)
            assert (a is None) == (b is None)
            if a is not None:
                same(a, b)


def test_cli_scores_a_model_file(tmp_path, capsys):
    cfg = tiny_config(ModelType.LLAMA, QuantType.Q8_0, dim=64,
                      hidden_dim=128, n_layers=2, vocab_size=300,
                      group_size=32, seq_len=128)
    weights = random_weights(cfg, seed=1)
    model = str(tmp_path / "m.lmrs")
    write_lmrs(model, cfg, weights)
    tokens = np.random.default_rng(0).integers(1, 299, 100)
    np.save(tmp_path / "ids.npy", tokens)
    main(["--model", model, "--tokens", str(tmp_path / "ids.npy"),
          "--device", "cpu", "--chunk", "64", "--cache-dtype", "int8"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    want = score_tokens(cfg, params_from_weights(cfg, weights, "cpu"),
                        tokens, chunk=64, cache_dtype="int8")
    assert line.endswith("over 99 tok")
    assert f"nll/tok {want['nll_per_token']:.9f}" in line

    vocab = ["<pad>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    vocab += list("abcdefghij ") + [f"t{i}" for i in range(30)]
    Tokenizer(vocab, [0.0] * len(vocab), 1, 2).save(str(tmp_path / "t.bin"))
    (tmp_path / "corpus.txt").write_text("a bad cafe " * 8)
    main(["--model", model, "--tokenizer", str(tmp_path / "t.bin"),
          "--text", str(tmp_path / "corpus.txt"), "--device", "cpu"])
    assert "over 88 tok" in capsys.readouterr().out


def test_cli_without_a_device_raises_off_the_card(tmp_path):
    """No CUDA device and no --device cpu: the harness refuses to run."""
    out = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_perplexity.py"),
         "--compare", "tiny-llama", "--n-tokens", "16"],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
