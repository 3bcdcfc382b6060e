"""The port's vision stack against the JAX package's on the CPU: layernorm
and QuickGELU, the exact (integer) matmul, the CLIP encoder, the image
processor and projector, the host-side image preprocessing, and the
vision and processor sections of the `.lmrs` file in both directions.

Tolerances:
- the exact matmul's activation quantization and integer group dots: bit
  for bit (integers, exact in float32 below 2^24);
- the exact matmul's output, layernorm and QuickGELU: 1e-6 of the output
  scale (f32 elementwise arithmetic and a sum in another order);
- vision_forward and processor_forward: 1e-5 of the output scale on at
  least 99% of the rows (a token's features), and 1e-3 on every value.
  The two packages' f32 sums (the patch embedding, layernorm, attention)
  differ in the last bit, so now and then an activation that lies within
  that bit of a rounding boundary of the Q8 quantizer rounds the other
  way, and one such step moves the row it feeds: in the tiny Q8_0 encoder
  one row of 1,731 at 3.6e-5 of the scale, the rest within 5e-7; in the
  projector's output 1 or 2 rows of 764 at up to 2.6e-4.  Float weights
  stay within 1e-6 everywhere, and so do Q4_0 weights in the encoder;
- the resize (against PIL), hd_transform, preprocess_image, the 2x2 merge
  and the newlines: bit for bit; the file sections: byte for byte.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lmrs_tpu.io.lmrs as jl
from lmrs_tpu.config import ModelType as JModelType
from lmrs_tpu.io.params import vision_params_from_lmrs as jax_vparams
from lmrs_tpu.io.synthetic import \
    random_multimodal_weights as jax_random_mm_weights
from lmrs_tpu.io.synthetic import tiny_config as jax_tiny_config
from lmrs_tpu.io.synthetic import \
    tiny_processor_config as jax_tiny_processor_config
from lmrs_tpu.io.synthetic import tiny_vision_config as jax_tiny_vision_config
from lmrs_tpu.models import phi3v as jphi3v
from lmrs_tpu.models.phi3v import processor_forward as jax_processor_forward
from lmrs_tpu.models.vision import VisionLayerWeights as JVisionLayerWeights
from lmrs_tpu.models.vision import vision_forward as jax_vision_forward
from lmrs_tpu.ops.activations import quick_gelu as jax_quick_gelu
from lmrs_tpu.ops.matmul import qmatmul as jax_qmatmul
from lmrs_tpu.ops.norms import layernorm as jax_layernorm
from lmrs_tpu.quant import QTensor as JQTensor
from lmrs_tpu.quant import QuantType as JQuantType
from lmrs_tpu.quant import quantize_q4_act as jax_q4_act
from lmrs_tpu.quant import quantize_q8_act as jax_q8_act
from lmrs_tpu.quant import unpack_q4 as jax_unpack_q4

import lmrs_tpu_torch.io.lmrs as tl
from lmrs_tpu_torch.config import ModelType, QuantType
from lmrs_tpu_torch.io.params import (vision_params_from_jax,
                                      vision_params_from_lmrs)
from lmrs_tpu_torch.io.synthetic import (random_multimodal_weights,
                                         tiny_config, tiny_processor_config,
                                         tiny_vision_config)
from lmrs_tpu_torch.models import phi3v
from lmrs_tpu_torch.models.vision import vision_forward
from lmrs_tpu_torch.ops.activations import quick_gelu
from lmrs_tpu_torch.ops.matmul import group_ints, qmatmul_exact
from lmrs_tpu_torch.ops.norms import layernorm
from lmrs_tpu_torch.quant import (QTensor, dequantize, q4_file_to_runtime_np,
                                  quantize_q4_act, quantize_q8_act,
                                  quantize_q40_np, quantize_q80_np)

torch.set_num_threads(1)

QUANTS = [QuantType.Q8_0, QuantType.Q4_0, QuantType.NONE]


def _scale_tol(want, rel):
    return rel * float(np.abs(want).max()) + 1e-12


def assert_close_up_to_rounding_steps(got, want):
    """1e-5 of the scale on at least 99% of the rows (the last axis is a
    row's), 1e-3 on every value (see the module note)."""
    err = np.abs(got - want).reshape(-1, want.shape[-1])
    assert err.max() <= _scale_tol(want, 1e-3)
    assert (err > _scale_tol(want, 1e-5)).any(axis=1).mean() <= 1e-2


def test_layernorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (5, 37, 96)).astype(np.float32)
    w = rng.normal(1, 0.1, 96).astype(np.float32)
    b = rng.normal(0, 0.1, 96).astype(np.float32)
    want = np.asarray(jax_layernorm(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), 1e-5))
    got = layernorm(torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), 1e-5).numpy()
    assert np.abs(got - want).max() <= _scale_tol(want, 1e-6)


def test_quick_gelu_matches_jax():
    x = np.random.default_rng(1).normal(0, 4, (64, 80)).astype(np.float32)
    want = np.asarray(jax_quick_gelu(jnp.asarray(x)))
    got = quick_gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= _scale_tol(want, 1e-6)


def _weight_pair(quant, o, k, gs, rng):
    """(JAX QTensor, port QTensor) of one random (o, k) weight, the same
    bytes in both (Q4 in the runtime layout, as both exact matmuls read
    it)."""
    w = rng.normal(0, 0.05, (o, k)).astype(np.float32)
    if quant == QuantType.NONE:
        return (JQTensor(jnp.asarray(w), None, JQuantType.NONE, gs, o, k),
                QTensor(torch.from_numpy(w), None, quant, gs, o, k))
    if quant == QuantType.Q8_0:
        q, s, _ = quantize_q80_np(w, gs)
        q = q.reshape(o, k)
    else:
        q, s, _ = quantize_q40_np(w, gs)
        q = q4_file_to_runtime_np(q.reshape(o, k // 2), gs)
    s = s.reshape(o, k // gs)
    return (JQTensor(jnp.asarray(q), jnp.asarray(s), JQuantType(int(quant)),
                     gs, o, k),
            QTensor(torch.from_numpy(q.copy()), torch.from_numpy(s.copy()),
                    quant, gs, o, k))


@pytest.mark.parametrize("quant", QUANTS)
def test_exact_matmul_matches_jax(quant):
    rng = np.random.default_rng(int(quant) + 3)
    gs, b, o, k = 32, 37, 48, 128
    jw, tw = _weight_pair(quant, o, k, gs, rng)
    x = rng.normal(0, 1, (b, k)).astype(np.float32)
    x[3, :gs] = 0.0                           # an all-zero group
    want = np.asarray(jax_qmatmul(jnp.asarray(x), jw, "exact"))
    got = qmatmul_exact(torch.from_numpy(x), tw).numpy()
    assert got.shape == (b, o)
    assert np.abs(got - want).max() <= _scale_tol(want, 1e-6)
    if quant == QuantType.NONE:
        return
    # the integer part: the quantized activations and every group's dot
    jq, tq = ((jax_q8_act, quantize_q8_act) if quant == QuantType.Q8_0
              else (jax_q4_act, quantize_q4_act))
    jxq, jxs = jq(jnp.asarray(x), gs)
    txq, txs = tq(torch.from_numpy(x), gs)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    jwq = (np.asarray(jw.q) if quant == QuantType.Q8_0
           else np.asarray(jax_unpack_q4(jw.q, gs)))
    g = k // gs
    want_ints = jax.lax.dot_general(
        jnp.asarray(np.asarray(jxq).reshape(b, g, gs).transpose(1, 0, 2)),
        jnp.asarray(jwq.reshape(o, g, gs).transpose(1, 0, 2)),
        (((2,), (2,)), ((0,), (0,))), preferred_element_type=jnp.int32)
    wq = tw.q if quant == QuantType.Q8_0 else torch.from_numpy(jwq.copy())
    ints = group_ints(txq, wq, gs)
    np.testing.assert_array_equal(ints.numpy(),
                                  np.asarray(want_ints).astype(np.float32))


def _jax_arrays(obj, prefix=""):
    """A JAX vision/processor params dataclass flattened to numpy in the
    naming vision_params_from_jax reads."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = prefix + f.name
        if isinstance(v, JVisionLayerWeights):
            out.update(_jax_arrays(v, "layers."))
        elif isinstance(v, JQTensor):
            out[key + ".q"] = np.array(v.q)
            if v.s is not None:
                out[key + ".s"] = np.array(v.s)
        else:
            out[key] = np.array(v)
    return out


def _tiny_mm(tmp_path, quant, seed=4):
    """A tiny multimodal file written by the JAX writer: (path, JAX vision
    config, processor config, params...)."""
    cfg = jax_tiny_config(JModelType.PHI, JQuantType(int(quant)),
                          multimodal=True)
    vc = jax_tiny_vision_config(JQuantType(int(quant)))
    pc = jax_tiny_processor_config(JQuantType(int(quant)), cfg.dim)
    path = str(tmp_path / f"mm{int(quant)}.lmrs")
    jl.write_lmrs(path, cfg, jax_random_mm_weights(cfg, vc, pc, seed),
                  vision_cfg=vc, processor_cfg=pc)
    return path


def _pair_params(tmp_path, quant):
    """The JAX vision and processor params of one tiny file and the port's
    copies of them (vision_params_from_jax)."""
    jf = jl.read_lmrs(_tiny_mm(tmp_path, quant))
    jvc, jvp, jpc, jpp = jax_vparams(jf)
    tf = tl.read_lmrs(jf.path)
    tvc, tpc = tf.cfg_vision_processor()
    tvp, tpp = vision_params_from_jax(tvc, tpc, _jax_arrays(jvp),
                                      _jax_arrays(jpp), device="cpu")
    return (jvc, jvp, jpc, jpp), (tvc, tvp, tpc, tpp)


@pytest.mark.parametrize("quant", QUANTS)
def test_vision_forward_matches_jax(tmp_path, quant):
    (jvc, jvp, _, _), (tvc, tvp, _, _) = _pair_params(tmp_path, quant)
    patches = np.random.default_rng(5).normal(
        0, 1, (3, tvc.n_patches, 3 * tvc.patch_size ** 2)).astype(np.float32)
    want = np.asarray(jax_vision_forward(jvp, jvc, jnp.asarray(patches)))
    got = vision_forward(tvp, tvc, torch.from_numpy(patches)).numpy()
    assert got.shape == want.shape == (3, tvc.n_patches, tvc.dim)
    assert_close_up_to_rounding_steps(got, want)
    if quant != QuantType.Q8_0:
        assert np.abs(got - want).max() <= _scale_tol(want, 1e-6)


@pytest.mark.parametrize("quant", QUANTS)
def test_processor_forward_matches_jax(tmp_path, quant):
    (_, _, jpc, jpp), (tvc, _, tpc, tpp) = _pair_params(tmp_path, quant)
    h_crop, w_crop = 1, 2
    feats = np.random.default_rng(6).normal(
        0, 1, (1 + h_crop * w_crop, 576, tvc.dim)).astype(np.float32)
    want = np.asarray(jax_processor_forward(jpp, jpc, jnp.asarray(feats),
                                            w_crop, h_crop))
    got = phi3v.processor_forward(tpp, tpc, torch.from_numpy(feats), w_crop,
                                  h_crop).numpy()
    # (12 * 24 + 12 sub rows with newlines) + glb_GN + (12 * 13) global
    assert got.shape == want.shape == (12 * 25 + 1 + 12 * 13, tpc.text_dim)
    assert_close_up_to_rounding_steps(got, want)


@pytest.mark.parametrize("src,dst", [
    ((64, 96), (37, 53)), ((300, 401), (672, 504)), ((121, 77), (336, 336)),
    ((1, 5), (3, 1)), ((755, 1009), (336, 336)), ((90, 90), (90, 45)),
    ((33, 47), (47, 33))])
def test_resize_matches_pil_bit_for_bit(src, dst):
    from PIL import Image

    img = np.random.default_rng(sum(src)).integers(0, 256, src + (3,),
                                                   dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst, Image.BILINEAR))
    got = phi3v.resize_bilinear(img, *dst)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,hd_num", [
    ((400, 800), 4), ((800, 400), 4), ((336, 336), 1), ((756, 1008), 4),
    ((333, 517), 16), ((64, 96), 1), ((517, 333), 9)])
def test_preprocess_matches_jax_bit_for_bit(shape, hd_num):
    img = np.random.default_rng(shape[0]).integers(0, 256, shape + (3,),
                                                   dtype=np.uint8)
    want = jphi3v.hd_transform(img, hd_num)
    got = phi3v.hd_transform(img, hd_num)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    want = jphi3v.preprocess_image(img, hd_num)
    got = phi3v.preprocess_image(img, hd_num)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("h_crop,w_crop", [(1, 1), (2, 1), (2, 2), (1, 3)])
def test_merge_and_newline_match_jax_exactly(h_crop, w_crop):
    rng = np.random.default_rng(h_crop * 10 + w_crop)
    feats = rng.normal(size=(h_crop * w_crop, 36, 8)).astype(np.float32)
    sep = rng.normal(size=(32,)).astype(np.float32)
    want = jphi3v.reshape_hd_patches_2x2merge(jnp.asarray(feats), h_crop,
                                              w_crop)
    got = phi3v.reshape_hd_patches_2x2merge(torch.from_numpy(feats), h_crop,
                                            w_crop)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jphi3v.add_image_newline(want, jnp.asarray(sep))
    got = phi3v.add_image_newline(got, torch.from_numpy(sep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _assert_same_sections(tf, jf):
    tvc, tpc = tf.cfg_vision_processor()
    jvc, jpc = jf.cfg_vision_processor()
    for t, j in ((tvc, jvc), (tpc, jpc)):
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    names = [n for n in jf.tensors if n.startswith(("v.", "p."))]
    assert sorted(names) == sorted(n for n in tf.tensors
                                   if n.startswith(("v.", "p.")))
    for n in names:
        for a, b in zip(tf.tensors[n], jf.tensors[n]):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quant", QUANTS)
def test_lmrs_sections_round_trip_both_ways(tmp_path, quant):
    # a file of the JAX writer, read by the port
    path = _tiny_mm(tmp_path, quant)
    jf, tf = jl.read_lmrs(path), tl.read_lmrs(path)
    assert tf.cfg.multimodal
    _assert_same_sections(tf, jf)
    assert tf.text_end_offset < tf.data.size
    # a file of the port's writer, read by the JAX package
    cfg = tiny_config(ModelType.PHI, quant, multimodal=True)
    vc = tiny_vision_config(quant)
    pc = tiny_processor_config(quant, cfg.dim)
    weights = random_multimodal_weights(cfg, vc, pc, 7)
    mine = str(tmp_path / "port.lmrs")
    tl.write_lmrs(mine, cfg, weights, vision_cfg=vc, processor_cfg=pc)
    _assert_same_sections(tl.read_lmrs(mine), jl.read_lmrs(mine))
    # the two writers give the same bytes for the same weights
    ref = str(tmp_path / "jax.lmrs")
    jcfg = jl.read_lmrs(mine).cfg
    jl.write_lmrs(ref, jcfg, weights, vision_cfg=jl.read_lmrs(mine).vision_cfg,
                  processor_cfg=jl.read_lmrs(mine).processor_cfg)
    assert open(mine, "rb").read() == open(ref, "rb").read()


def test_vision_loader_repacks_q4_file_bytes(tmp_path):
    """The port's loader dequantizes a Q4_0 vision weight to the file's
    values (file bytes repacked into the runtime layout, as the text
    weights are).  The JAX loader hands the file's bytes to a matmul that
    reads the runtime layout, which is a fault of the reference
    (ROADMAP.md C): its Q4 weights are not the file's."""
    path = _tiny_mm(tmp_path, QuantType.Q4_0)
    tf = tl.read_lmrs(path)
    vc, vp, _, pp = vision_params_from_lmrs(tf, device="cpu")
    from lmrs_tpu.quant import unpack_q4_file

    q, s = tf.tensors["v.w1@1"]
    vals = np.asarray(unpack_q4_file(jnp.asarray(q))).astype(np.float32)
    gs = vc.group_size
    want = (vals.reshape(q.shape[0], -1, gs) * s[..., None]).reshape(
        q.shape[0], -1)
    got = dequantize(vp.layers.at(1).w1).numpy()
    np.testing.assert_array_equal(got, want)
    q, s = tf.tensors["p.proj1"]
    vals = np.asarray(unpack_q4_file(jnp.asarray(q))).astype(np.float32)
    want = (vals.reshape(q.shape[0], -1, gs) * s[..., None]).reshape(
        q.shape[0], -1)
    np.testing.assert_array_equal(dequantize(pp.proj1).numpy(), want)
    # the reference's own reading of the same bytes differs
    jw1 = jax_vparams(jl.read_lmrs(path))[1].layers.w1
    jvals = np.asarray(jax_unpack_q4(jw1.q[1], gs)).astype(np.float32)
    assert not np.array_equal(jvals, np.asarray(
        unpack_q4_file(jnp.asarray(tf.tensors["v.w1@1"][0]))))
