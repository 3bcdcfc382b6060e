"""CLIP ViT-L/14-336 vision encoder (Phi-3.5-vision).

Counterpart of `lmrs_tpu/models/vision.py`: one pass batched over the
image crops, the patch-embedding convolution written as one matmul over
the extracted patches, and full (non-causal) attention as plain float32
products and a softmax over (C, H, 577, 577).  Every weight matmul is
`ops.matmul.qmatmul_exact`, lm.rs's integer arithmetic, as the JAX
package's vision matmuls are (`matmul_impl="exact"`, which no `.lmrs`
loader overrides): none of it reaches a TPU kernel there, so none of it
has a CUDA kernel here.

lm.rs quirks kept: only the first n_layers - 1 layers run (Phi-3 takes the
penultimate layer's hidden states); queries are divided by
sqrt(head_dim) right after the bias add; the CLS token is prepended before
the position embeddings and stripped at the end.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from lmrs_tpu_torch.config import QuantType
from lmrs_tpu_torch.kernels import cuda
from lmrs_tpu_torch.ops.activations import quick_gelu
from lmrs_tpu_torch.ops.matmul import qmatmul_exact
from lmrs_tpu_torch.ops.norms import layernorm
from lmrs_tpu_torch.quant import QTensor, _const, dequantize

N_POSITIONS = 577  # 24 * 24 patches + CLS


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """The vision section's header (37 bytes in a `.lmrs` file)."""

    dim: int = 1024
    hidden_dim: int = 4096
    n_layers: int = 24
    n_heads: int = 16
    head_dim: int = 64
    layernorm_eps: float = 1e-5
    patch_size: int = 14
    image_size: int = 336
    quant: QuantType = QuantType.NONE
    group_size: int = 128

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def n_patches(self) -> int:
        return self.patches_per_side ** 2


# the per-layer weights: the quantized matrices, then the float vectors
VISION_MATRICES = ("wq", "wk", "wv", "wo", "w1", "w2")
VISION_VECTORS = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "wq_b", "wk_b", "wv_b",
                  "wo_b", "w1_b", "w2_b")


@dataclasses.dataclass
class VisionLayerWeights:
    """The encoder layers' weights, each stacked on a leading (L,) axis:
    QTensors (Q4 bytes in the runtime layout) for the matrices, f32 for
    the layernorms and biases.  `at(l)` is layer l's views."""

    ln1_w: torch.Tensor
    ln1_b: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    wq: QTensor
    wq_b: torch.Tensor
    wk: QTensor
    wk_b: torch.Tensor
    wv: QTensor
    wv_b: torch.Tensor
    wo: QTensor
    wo_b: torch.Tensor
    w1: QTensor
    w1_b: torch.Tensor
    w2: QTensor
    w2_b: torch.Tensor

    def at(self, l: int) -> "VisionLayerWeights":
        def one(v):
            if isinstance(v, QTensor):
                return dataclasses.replace(
                    v, q=v.q[l], s=None if v.s is None else v.s[l])
            return v[l]

        return VisionLayerWeights(**{f.name: one(getattr(self, f.name))
                                     for f in dataclasses.fields(self)})


@dataclasses.dataclass
class VisionParams:
    class_embedding: torch.Tensor      # (D,)
    patch_embedding: torch.Tensor      # (D, 3 * ps * ps) f32, never quantized
    position_embedding: torch.Tensor   # (577, D) f32
    layers: VisionLayerWeights         # stacked (L, ...)
    pre_ln_w: torch.Tensor             # (D,)
    pre_ln_b: torch.Tensor             # (D,)


def vision_params_dequantized(params: VisionParams) -> VisionParams:
    """The encoder's params with every quantized matrix dequantized to f32
    (float QTensors): the same tower without lm.rs's activation quantizer,
    whose rounding steps an f32 sum's last bit can flip."""
    lw = params.layers
    return dataclasses.replace(params, layers=dataclasses.replace(lw, **{
        n: QTensor(dequantize(getattr(lw, n)), None, QuantType.NONE,
                   getattr(lw, n).group_size, getattr(lw, n).out_features,
                   getattr(lw, n).in_features)
        for n in VISION_MATRICES}))


def _vlayer(cfg: VisionConfig, h: torch.Tensor, lw: VisionLayerWeights,
            matmul=qmatmul_exact) -> torch.Tensor:
    """One CLIP encoder layer over (C, T, D)."""
    c, t, d = h.shape
    hs = cfg.head_dim
    e = layernorm(h, lw.ln1_w, lw.ln1_b, cfg.layernorm_eps).reshape(c * t, d)
    q = matmul(e, lw.wq) + lw.wq_b
    # a tensor divisor: on the card a tensor divided by a Python scalar is
    # a multiply by its reciprocal, not the quotient
    q = q / _const(q, math.sqrt(hs))
    k = matmul(e, lw.wk) + lw.wk_b
    v = matmul(e, lw.wv) + lw.wv_b

    def heads(a):                                   # (C, H, T, hs)
        return a.reshape(c, t, cfg.n_heads, hs).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    if h.is_cuda:
        cuda.plain_numerics()
    scores = q @ k.transpose(-1, -2)                # (C, H, T, T)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = p / p.sum(dim=-1, keepdim=True)
    att = (p @ v).transpose(1, 2).reshape(c * t, d)

    o = matmul(att, lw.wo) + lw.wo_b
    h = h + o.reshape(c, t, d)
    e2 = layernorm(h, lw.ln2_w, lw.ln2_b, cfg.layernorm_eps)
    hid = quick_gelu(matmul(e2.reshape(c * t, d), lw.w1) + lw.w1_b)
    mlp = matmul(hid, lw.w2) + lw.w2_b
    return h + mlp.reshape(c, t, d)


def vision_forward(params: VisionParams, cfg: VisionConfig,
                   patches: torch.Tensor,
                   matmul=qmatmul_exact) -> torch.Tensor:
    """patches (C, n_patches, 3 * ps * ps) float32 -> features (C,
    n_patches, D): the penultimate layer's hidden states with the CLS
    token stripped.  Runs on the patches' device.  `matmul(x, w)` computes
    every weight product of the layers (a check wraps it to hold each call
    on its own)."""
    c = patches.shape[0]
    if patches.is_cuda:
        cuda.plain_numerics()
    pe = patches.float() @ params.patch_embedding.float().t()   # (C, P, D)
    cls = params.class_embedding.float().expand(c, 1, cfg.dim)
    h = torch.cat([cls, pe], dim=1) + params.position_embedding[None]
    h = layernorm(h, params.pre_ln_w, params.pre_ln_b, cfg.layernorm_eps)
    for l in range(cfg.n_layers - 1):
        h = _vlayer(cfg, h, params.layers.at(l), matmul)
    return h[:, 1:, :]


def recording_matmul(matmul=qmatmul_exact):
    """(a `matmul` for vision_forward that keeps every call's (x, w, y),
    the list it appends them to): a check holds each call on its own."""
    calls = []

    def rec(x, w):
        y = matmul(x, w)
        calls.append((x, w, y))
        return y

    return rec, calls


def worst_call_error(calls) -> float:
    """The largest error of the recorded calls' outputs against
    qmatmul_exact on the CPU on each call's own input and weights, each
    relative to its output's scale."""
    worst = 0.0
    for x, w, y in calls:
        wc = dataclasses.replace(w, q=w.q.cpu(),
                                 s=None if w.s is None else w.s.cpu())
        want = qmatmul_exact(x.cpu(), wc)
        err = (y.cpu() - want).abs().max().item()
        worst = max(worst, err / want.abs().max().item())
    return worst
