"""Build TransformerParams on a device from a .lmrs file, or from the JAX
package's parameters.

Quantized tensors go to the device as the file stores them (int8 Q8 values
or packed Q4 bytes, + f32 scales).  Q8_0 bytes stay as they are; Q4_0's
adjacent-pair file bytes are repacked into the runtime group-half layout ON
THE DEVICE with torch ops (a host repack of a 9B model's ~4.9 GB is slow).
The [q; k; v] and [gate; up] row concatenations are built once at load from
per-tensor device copies, contiguous, as the kernels need them.  A
multimodal file's vision and processor weights load with
`vision_params_from_lmrs`, the vision layers stacked on a leading axis.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from lmrs_tpu_torch.config import (ModelConfig, ModelType, QuantType,
                                   resolve_device)
from lmrs_tpu_torch.io.lmrs import LmrsFile, _tensor_layout
from lmrs_tpu_torch.kernels.ffn_fused import ffn_split_perm
from lmrs_tpu_torch.models.transformer import (KVCache, LayerWeights,
                                               TransformerParams)
from lmrs_tpu_torch.ops.rope import rope_tables
from lmrs_tpu_torch.quant import (QTensor, q4_file_to_runtime,
                                  quantize_q40_np, quantize_q80_np)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A private device copy of a host array (memmap views are read-only,
    so the host tensor is never handed out)."""
    arr = np.ascontiguousarray(arr)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # non-writable memmap
        t = torch.from_numpy(arr)
    return t.to(device, copy=True)


def params_from_lmrs(f: LmrsFile, device=None) -> TransformerParams:
    """From a parsed .lmrs file's zero-copy tensor views, onto `device`
    (default cuda; raises without a GPU)."""
    return _params_from_tensors(f.cfg, f.tensors, resolve_device(device))


def params_from_weights(cfg: ModelConfig, weights: Dict[str, np.ndarray],
                        device=None) -> TransformerParams:
    """From dense float weights under the .lmrs layout names ("embed",
    "wq@0", ...), the matrices quantized per `cfg.quant` at
    `cfg.group_size` as the .lmrs writer quantizes them, onto `device`
    (default cuda; raises without a GPU).  The same weights give the
    params that `params_from_lmrs` loads from the file `io.lmrs.write_lmrs`
    writes of them: one set of dense weights at f32, Q8_0 and Q4_0 at one
    group size, as the perplexity comparison needs."""
    device = resolve_device(device)
    gs = cfg.group_size
    tensors = {}
    for name, shape, quantized in _tensor_layout(cfg):
        w = np.ascontiguousarray(weights[name], dtype=np.float32)
        if w.shape != shape:
            raise ValueError(f"{name}: shape {w.shape}, layout {shape}")
        if not quantized:
            tensors[name] = (w, None)
            continue
        quantize = (quantize_q80_np if cfg.quant == QuantType.Q8_0
                    else quantize_q40_np)
        q, s, _ = quantize(w, gs)
        # Q4_0: file-layout bytes, repacked once on the device below
        tensors[name] = (q.reshape(shape[0], -1),
                         s.reshape(shape[0], shape[1] // gs))
    return _params_from_tensors(cfg, tensors, device)


def _params_from_tensors(cfg: ModelConfig, t, device) -> TransformerParams:
    """TransformerParams on `device` from (values, scales) host arrays in
    the .lmrs file's form, keyed by layout name."""
    gs = cfg.group_size

    def qt(names, l=None):
        keys = [n if l is None else f"{n}@{l}" for n in names]
        q = torch.cat([_to_device(t[k][0], device) for k in keys])
        if cfg.quant == QuantType.NONE:
            return QTensor(q, None, cfg.quant, gs, q.shape[0], q.shape[1])
        s = torch.cat([_to_device(t[k][1], device) for k in keys])
        if cfg.quant == QuantType.Q4_0:
            return QTensor(q4_file_to_runtime(q, gs).contiguous(), s,
                           cfg.quant, gs, q.shape[0], q.shape[1] * 2)
        return QTensor(q, s, cfg.quant, gs, q.shape[0], q.shape[1])

    def norm(name, l=None):
        key = name if l is None else f"{name}@{l}"
        return _to_device(t[key][0], device)

    gemma = cfg.model_type == ModelType.GEMMA
    layers = [LayerWeights(
        att_norm=norm("att_norm", l),
        wqkv=qt(("wq", "wk", "wv"), l),
        wo=qt(("wo",), l),
        post_att_norm=norm("post_att_norm", l),
        pre_ffn_norm=norm("pre_ffn_norm", l) if gemma else None,
        w13=qt(("w1", "w3"), l),
        w2=qt(("w2",), l),
        post_ffn_norm=norm("post_ffn_norm", l) if gemma else None,
    ) for l in range(cfg.n_layers)]
    cos, sin = rope_tables(cfg)
    return TransformerParams(
        embed=qt(("embed",)), layers=layers, final_norm=norm("final_norm"),
        lm_head=qt(("lm_head",)) if cfg.model_type == ModelType.PHI else None,
        rope_cos=_to_device(cos, device), rope_sin=_to_device(sin, device))


def params_from_jax(cfg: ModelConfig, arrays: Dict[str, np.ndarray],
                    device=None) -> TransformerParams:
    """From the JAX package's row-major stacked parameters
    (`lmrs_tpu.io.params.params_from_lmrs(f, stack_layers=True,
    fuse_qkv=True)`) flattened to numpy: "embed.q", "embed.s",
    "layers.wqkv.q" (L, O, K/2) runtime-layout Q4 bytes or (L, O, K) int8
    Q8 values, "layers.wqkv.s" (L, O, G), "layers.att_norm" (L, D), ...,
    "final_norm", "lm_head.q", "rope_cos", "rope_sin".  Its Q4 bytes are
    already in the runtime layout, so they are copied as they are, but for
    the w13 rows of a load with `fuse_ffn` (`cfg.fuse_ffn`), which are put
    back in their logical order.  Float (NONE) weights have no ".s".
    The JAX package's K-major decode tiles (`lmrs_tpu.kernels.vpu_matvec.
    kmajor_params`) are taken too: `row_major_arrays` undoes them first."""
    device = resolve_device(device)
    gs = cfg.group_size
    arrays = row_major_arrays(cfg, arrays)
    per_byte = 2 if cfg.quant == QuantType.Q4_0 else 1
    # a JAX load with fuse_ffn stores Q4 w13 rows in its fused kernel's
    # split order; this package keeps the logical [gate; up] order
    w13_rows = None
    if cfg.fuse_ffn and cfg.quant == QuantType.Q4_0:
        p = ffn_split_perm(cfg.hidden_dim, gs)
        w13_rows = np.argsort(np.concatenate([p, cfg.hidden_dim + p]))

    def qt(prefix, l=None):
        q, s = arrays[f"{prefix}.q"], arrays.get(f"{prefix}.s")
        if l is not None:
            q, s = q[l], None if s is None else s[l]
        if prefix == "layers.w13" and w13_rows is not None:
            q, s = q[w13_rows], s[w13_rows]
        return QTensor(_to_device(q, device),
                       None if s is None else _to_device(s, device),
                       cfg.quant, gs, q.shape[0], q.shape[1] * per_byte)

    def norm(name, l):
        key = f"layers.{name}"
        return _to_device(arrays[key][l], device) if key in arrays else None

    layers: List[LayerWeights] = [LayerWeights(
        att_norm=norm("att_norm", l), wqkv=qt("layers.wqkv", l),
        wo=qt("layers.wo", l), post_att_norm=norm("post_att_norm", l),
        pre_ffn_norm=norm("pre_ffn_norm", l), w13=qt("layers.w13", l),
        w2=qt("layers.w2", l), post_ffn_norm=norm("post_ffn_norm", l),
    ) for l in range(cfg.n_layers)]
    lm_head: Optional[QTensor] = (qt("lm_head") if "lm_head.q" in arrays
                                  else None)
    return TransformerParams(
        embed=qt("embed"), layers=layers,
        final_norm=_to_device(arrays["final_norm"], device), lm_head=lm_head,
        rope_cos=_to_device(arrays["rope_cos"], device),
        rope_sin=_to_device(arrays["rope_sin"], device))


def row_major_arrays(cfg: ModelConfig,
                     arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """`params_from_jax`'s arrays with the JAX package's K-major tiles
    (`kmajor_params`: a quantized (L, O, Kb) tensor, or (O, Kb) with L = 1,
    stored as (L, O_pad / o_t, Kb, o_t), O padded with zero-scale rows up
    to a whole tile) put back in row-major (L, O, Kb) order, the padding
    rows cut: the row-major bytes, bit for bit.  Row-major arrays pass
    unchanged; a quantized tensor of any other rank raises."""
    if arrays["embed.q"].ndim == 2 and arrays["layers.wqkv.q"].ndim == 3:
        return arrays
    att, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    rows = {"embed": cfg.vocab_size, "lm_head": cfg.vocab_size,
            "layers.wqkv": att + 2 * kv, "layers.wo": cfg.dim,
            "layers.w13": 2 * cfg.hidden_dim, "layers.w2": cfg.dim}
    out = dict(arrays)
    for prefix, n in rows.items():
        for key in (f"{prefix}.q", f"{prefix}.s"):
            if key not in arrays:
                continue
            a = np.asarray(arrays[key])
            if a.ndim != 4:
                raise ValueError(f"{key}: K-major tiles are (L, O/o_t, Kb, "
                                 f"o_t), got {a.shape}")
            lead, n_o, kb, o_t = a.shape
            a = a.transpose(0, 1, 3, 2).reshape(lead, n_o * o_t, kb)[:, :n]
            out[key] = np.ascontiguousarray(
                a if prefix.startswith("layers.") else a[0])
    return out


def kvcache_from_numpy(arrays: Dict[str, np.ndarray], dtype: torch.dtype,
                       device) -> KVCache:
    """A KVCache on `device` from the arrays of a saved session: "k", "v"
    (L, S, row) and, for a quantized cache, "k_scale", "v_scale" (L, KH, S)
    f32.  `dtype` is the storage type of the engine's cache.  int8 arrays
    (an int8 or int4 cache, of this package or of the JAX one) are taken
    as they are.  A bf16 cache arrives as 2-byte items, this package's
    int16 bit pattern or the raw void items numpy makes of a JAX bfloat16
    array, and is reinterpreted; any other float array is converted."""
    def rows(a: np.ndarray) -> torch.Tensor:
        if a.dtype.itemsize == 2 and a.dtype.kind in "iV":
            t = _to_device(a.view(np.int16), device).view(torch.bfloat16)
        elif a.dtype.kind in "fi":
            t = _to_device(a, device)
        else:
            raise ValueError(f"session cache items of type {a.dtype} cannot "
                             f"be read as {dtype}")
        return t.to(dtype)

    scales = {key: _to_device(arrays[key].astype(np.float32), device)
              for key in ("k_scale", "v_scale") if key in arrays}
    return KVCache(k=rows(arrays["k"]), v=rows(arrays["v"]), **scales)


def vision_params_from_lmrs(f: LmrsFile, device=None):
    """(VisionConfig, VisionParams, ProcessorConfig, ProcessorParams) of a
    multimodal file, onto `device` (default cuda; raises without a GPU).
    The vision layers' tensors are stacked (L, ...); Q4_0 bytes are
    repacked into the runtime layout, as the text weights are."""
    from lmrs_tpu_torch.models.phi3v import ProcessorParams
    from lmrs_tpu_torch.models.vision import (VISION_MATRICES,
                                              VISION_VECTORS,
                                              VisionLayerWeights,
                                              VisionParams)

    device = resolve_device(device)
    vc, pc = f.cfg_vision_processor()
    t = f.tensors

    def qt(q, s, quant, gs):
        q = _to_device(q, device)
        if quant == QuantType.NONE:
            return QTensor(q, None, quant, gs, q.shape[-2], q.shape[-1])
        s = _to_device(s, device)
        if quant == QuantType.Q4_0:
            return QTensor(q4_file_to_runtime(q, gs).contiguous(), s, quant,
                           gs, q.shape[-2], q.shape[-1] * 2)
        return QTensor(q, s, quant, gs, q.shape[-2], q.shape[-1])

    def stacked(name):
        return [t[f"v.{name}@{l}"] for l in range(vc.n_layers)]

    def vec(name):
        return _to_device(np.stack([a for a, _ in stacked(name)]), device)

    layers = {name: qt(np.stack([q for q, _ in stacked(name)]),
                       None if vc.quant == QuantType.NONE
                       else np.stack([s for _, s in stacked(name)]),
                       vc.quant, vc.group_size)
              for name in VISION_MATRICES}
    layers.update({name: vec(name) for name in VISION_VECTORS})
    top = {name: _to_device(t[f"v.{name}"][0], device)
           for name in ("class_embedding", "patch_embedding",
                        "position_embedding", "pre_ln_w", "pre_ln_b")}
    vparams = VisionParams(layers=VisionLayerWeights(**layers), **top)
    pparams = ProcessorParams(
        glb_gn=_to_device(t["p.glb_gn"][0], device),
        sub_gn=_to_device(t["p.sub_gn"][0], device),
        proj0=qt(*t["p.proj0"], pc.quant, pc.group_size),
        proj0_b=_to_device(t["p.proj0_b"][0], device),
        proj1=qt(*t["p.proj1"], pc.quant, pc.group_size),
        proj1_b=_to_device(t["p.proj1_b"][0], device))
    return vc, vparams, pc, pparams


def vision_params_from_jax(vc, pc, varrays: Dict[str, np.ndarray],
                           parrays: Dict[str, np.ndarray], device=None):
    """(VisionParams, ProcessorParams) on `device` from the JAX package's
    vision and processor parameters flattened to numpy: `varrays` holds
    "class_embedding", "patch_embedding", "position_embedding",
    "pre_ln_w", "pre_ln_b", "layers.<vector>" (L, n) and
    "layers.<matrix>.q" / ".s" (stacked); `parrays` "glb_gn", "sub_gn",
    "proj0.q", "proj0.s", "proj0_b", "proj1.q", "proj1.s", "proj1_b".  The
    bytes are copied as they are: a JAX QTensor's Q4 bytes are taken in
    the runtime layout, which is how the JAX exact matmul reads them."""
    from lmrs_tpu_torch.models.phi3v import ProcessorParams
    from lmrs_tpu_torch.models.vision import (VISION_MATRICES,
                                              VISION_VECTORS,
                                              VisionLayerWeights,
                                              VisionParams)

    device = resolve_device(device)
    dev = lambda a: _to_device(np.asarray(a), device)  # noqa: E731

    def qt(arrays, prefix, quant, gs):
        q, s = arrays[f"{prefix}.q"], arrays.get(f"{prefix}.s")
        per_byte = 2 if quant == QuantType.Q4_0 else 1
        return QTensor(dev(q), None if s is None else dev(s), quant, gs,
                       q.shape[-2], q.shape[-1] * per_byte)

    layers = {n: qt(varrays, f"layers.{n}", vc.quant, vc.group_size)
              for n in VISION_MATRICES}
    layers.update({n: dev(varrays[f"layers.{n}"]) for n in VISION_VECTORS})
    vparams = VisionParams(
        layers=VisionLayerWeights(**layers),
        **{n: dev(varrays[n]) for n in ("class_embedding", "patch_embedding",
                                        "position_embedding", "pre_ln_w",
                                        "pre_ln_b")})
    pparams = ProcessorParams(
        glb_gn=dev(parrays["glb_gn"]), sub_gn=dev(parrays["sub_gn"]),
        proj0=qt(parrays, "proj0", pc.quant, pc.group_size),
        proj0_b=dev(parrays["proj0_b"]),
        proj1=qt(parrays, "proj1", pc.quant, pc.group_size),
        proj1_b=dev(parrays["proj1_b"]))
    return vparams, pparams
