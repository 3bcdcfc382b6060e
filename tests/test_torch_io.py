"""lmrs_tpu_torch.io against lmrs_tpu.io: the .lmrs reader and writer in
both directions, params_from_lmrs after the on-device Q4 repack, and
params_from_jax.

Tolerance: bit-exact.  Headers, tensors and repacked bytes are copies or
byte permutations; nothing is computed in floating point.
"""

import dataclasses

import numpy as np
import pytest
import torch

import lmrs_tpu.io.lmrs as jl
from lmrs_tpu.config import ModelType as JModelType
from lmrs_tpu.io.params import params_from_lmrs as jax_params_from_lmrs
from lmrs_tpu.io.synthetic import random_weights as jax_random_weights
from lmrs_tpu.io.synthetic import tiny_config as jax_tiny_config
from lmrs_tpu.io.synthetic import write_synthetic_lmrs as jax_write_synth
from lmrs_tpu.models.transformer import LayerWeights as JLayerWeights
from lmrs_tpu.quant import QTensor as JQTensor
from lmrs_tpu.quant import QuantType as JQuantType

import lmrs_tpu_torch.io.lmrs as tl
from lmrs_tpu_torch.config import ModelType, QuantType
from lmrs_tpu_torch.io.params import params_from_jax, params_from_lmrs
from lmrs_tpu_torch.io.synthetic import random_weights, tiny_config
from lmrs_tpu_torch.io.synthetic import write_synthetic_lmrs
from lmrs_tpu_torch.models.transformer import LayerWeights

FAMILIES = [ModelType.GEMMA, ModelType.LLAMA, ModelType.PHI]


def jax_param_arrays(params):
    """The JAX package's stacked params flattened to numpy, in the naming
    params_from_jax reads ("layers.wqkv.q", "embed.s", "final_norm", ...)."""
    out = {}

    def put(key, v):
        if v is None:
            return
        if isinstance(v, JQTensor):
            out[key + ".q"] = np.array(v.q)
            if v.s is not None:                 # float weights: no scales
                out[key + ".s"] = np.array(v.s)
        else:
            out[key] = np.array(v)

    for name in ("embed", "lm_head", "final_norm", "rope_cos", "rope_sin"):
        put(name, getattr(params, name))
    for f in dataclasses.fields(JLayerWeights):
        put("layers." + f.name, getattr(params.layers, f.name))
    return out


def _assert_same_cfg(tcfg, jcfg):
    for f in dataclasses.fields(tcfg):
        tv, jv = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name == "rope_scaling" and tv is not None:
            tv, jv = dataclasses.astuple(tv), dataclasses.astuple(jv)
        assert (int(tv) if f.name in ("model_type", "quant") else tv) == \
            (int(jv) if f.name in ("model_type", "quant") else jv), f.name


def _assert_same_tensors(tf, jf):
    assert list(tf.tensors) == list(jf.tensors)
    for name, (tq, ts) in tf.tensors.items():
        jq, js = jf.tensors[name]
        np.testing.assert_array_equal(tq, jq)
        assert tq.dtype == jq.dtype
        if js is None:
            assert ts is None
        else:
            np.testing.assert_array_equal(ts, js)


@pytest.mark.parametrize("family", FAMILIES)
def test_lmrs_files_cross_read(tmp_path, family):
    jcfg = jax_tiny_config(JModelType(int(family)), JQuantType.Q4_0)
    tcfg = tiny_config(family, QuantType.Q4_0)
    weights = jax_random_weights(jcfg, 5)
    # the two packages generate the same random weights
    for k, w in random_weights(tcfg, 5).items():
        np.testing.assert_array_equal(w, weights[k])
    jl.write_lmrs(str(tmp_path / "j.lmrs"), jcfg, weights)
    tl.write_lmrs(str(tmp_path / "t.lmrs"), tcfg, weights)
    assert (tmp_path / "j.lmrs").read_bytes() == \
        (tmp_path / "t.lmrs").read_bytes()
    tf = tl.read_lmrs(str(tmp_path / "j.lmrs"))
    jf = jl.read_lmrs(str(tmp_path / "t.lmrs"))
    _assert_same_cfg(tf.cfg, jf.cfg)
    _assert_same_tensors(tf, jf)
    assert tf.text_end_offset == jf.text_end_offset


def test_synthetic_writer_matches_jax(tmp_path):
    """The streaming synthetic writer (pooled tensors above 2M values)
    writes the same bytes as the JAX package's."""
    cfg = tiny_config(ModelType.GEMMA, QuantType.Q4_0, vocab_size=32768,
                      dim=128)
    jcfg = jax_tiny_config(JModelType.GEMMA, JQuantType.Q4_0,
                           vocab_size=32768, dim=128)
    write_synthetic_lmrs(str(tmp_path / "t.lmrs"), cfg, seed=3)
    jax_write_synth(str(tmp_path / "j.lmrs"), jcfg, seed=3)
    assert (tmp_path / "t.lmrs").read_bytes() == \
        (tmp_path / "j.lmrs").read_bytes()


def _assert_params_equal(a, b):
    def eq(x, y):
        if x is None or y is None:
            assert x is None and y is None
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)
        else:   # QTensor
            assert (x.qtype, x.group_size, x.out_features, x.in_features) \
                == (y.qtype, y.group_size, y.out_features, y.in_features)
            eq(x.q, y.q)
            eq(x.s, y.s)

    for name in ("embed", "lm_head", "final_norm", "rope_cos", "rope_sin"):
        eq(getattr(a, name), getattr(b, name))
    assert len(a.layers) == len(b.layers)
    for la, lb in zip(a.layers, b.layers):
        for f in dataclasses.fields(LayerWeights):
            eq(getattr(la, f.name), getattr(lb, f.name))


def _check_params_match_jax(tmp_path, family, quant):
    cfg = tiny_config(family, quant)
    path = str(tmp_path / "m.lmrs")
    tl.write_lmrs(path, cfg, random_weights(cfg, 2))
    jp = jax_params_from_lmrs(jl.read_lmrs(path), stack_layers=True,
                              fuse_qkv=True)
    arrays = jax_param_arrays(jp)
    tp = params_from_lmrs(tl.read_lmrs(path), device="cpu")
    for l, lw in enumerate(tp.layers):
        for name in ("wqkv", "wo", "w13", "w2"):
            w = getattr(lw, name)
            assert w.q.is_contiguous()
            np.testing.assert_array_equal(w.q.numpy(),
                                          arrays[f"layers.{name}.q"][l])
            if quant == QuantType.NONE:
                assert w.s is None and f"layers.{name}.s" not in arrays
            else:
                np.testing.assert_array_equal(w.s.numpy(),
                                              arrays[f"layers.{name}.s"][l])
    np.testing.assert_array_equal(tp.embed.q.numpy(), arrays["embed.q"])
    assert tp.embed.q.dtype == {QuantType.Q4_0: torch.uint8,
                                QuantType.Q8_0: torch.int8,
                                QuantType.NONE: torch.float32}[quant]
    _assert_params_equal(params_from_jax(tl.read_lmrs(path).cfg, arrays,
                                         device="cpu"), tp)


@pytest.mark.parametrize("family", FAMILIES)
def test_params_match_jax_byte_for_byte(tmp_path, family):
    """The port's on-device repack gives the JAX loader's runtime bytes,
    and params_from_jax equals params_from_lmrs."""
    _check_params_match_jax(tmp_path, family, QuantType.Q4_0)


@pytest.mark.parametrize("quant", [QuantType.Q8_0, QuantType.NONE])
@pytest.mark.parametrize("family", FAMILIES)
def test_q8_and_float_params_match_jax_byte_for_byte(tmp_path, family,
                                                     quant):
    """Q8_0 and float weights reach the device as the file stores them:
    the JAX loader's bytes, contiguous after the row concatenations."""
    _check_params_match_jax(tmp_path, family, quant)


@pytest.mark.parametrize("family", [ModelType.LLAMA, ModelType.PHI])
@pytest.mark.parametrize("quant", [QuantType.Q4_0, QuantType.Q8_0])
def test_params_refuse_what_the_slice_does_not_cover(tmp_path, family,
                                                     quant):
    """The JAX package's K-major decode tiles (`kmajor_params`, with a tile
    that pads the rows: Phi's lm_head and a 96-row tile) carried through
    params_from_jax equal the row-major carry bit for bit; tiles of a
    rank that is neither layout still raise."""
    from lmrs_tpu.io.lmrs import read_lmrs as jax_read
    from lmrs_tpu.io.params import params_from_lmrs as jax_params
    from lmrs_tpu.kernels.vpu_matvec import kmajor_params

    cfg = tiny_config(family, quant, vocab_size=608)
    path = str(tmp_path / "m.lmrs")
    tl.write_lmrs(path, cfg, random_weights(cfg, 4))
    jp = jax_params(jax_read(path), stack_layers=True, fuse_qkv=True)
    rows = jax_param_arrays(jp)
    tiles = jax_param_arrays(kmajor_params(jp, o_tile=128, donate=False))
    assert tiles["layers.wqkv.q"].ndim == 4 and tiles["embed.q"].ndim == 4
    assert tiles["embed.q"].shape[1] * 128 > cfg.vocab_size  # padded rows
    _assert_params_equal(params_from_jax(cfg, tiles, device="cpu"),
                         params_from_jax(cfg, rows, device="cpu"))
    bad = dict(tiles, **{"layers.wo.q": tiles["layers.wo.q"][0]})
    with pytest.raises(ValueError, match="K-major"):
        params_from_jax(cfg, bad, device="cpu")
