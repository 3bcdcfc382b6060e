"""Phi-3.5-vision (`model_type` phi3_v): the Phi-3 text decoder of
`phi3.py` with the CLIP ViT-L/14-336 tower and the projector beside it
(the port's `models.vision` and `models.phi3v`), whose rows a turn's image
becomes.

The benchmark's weights are `MultiWeights`: the text decoder's, made as
`phi3.make_weights` makes them, and the tower's and projector's
(`make_vision_weights`, from salts of their own).  The text decoder's
costs are `phi3.py`'s; an image's tower and projector are counted by
`roofline.image_cost` where `images.py` runs them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from portbench import weights as W
from portbench.arch import phi3
from portbench.arch.phi3 import COUNTERS, attention_cost, forward_cost  # noqa


def port_config(conf: dict):
    from lmrs_tpu_torch.config import ModelConfig, ModelType

    return ModelConfig.make(ModelType.PHI, multimodal=True,
                            **phi3.config_kw(conf))


class MultiWeights:
    """A multimodal model's weights: `text` (phi3.TextWeights) and
    `vision` (VisionWeights)."""

    def __init__(self, text, vision):
        self.text, self.vision = text, vision


def vision_dims(conf: dict) -> dict:
    v = conf["vision"]
    return dict(dim=v["hidden_size"], hidden_dim=v["intermediate_size"],
                n_layers=v["num_hidden_layers"],
                n_heads=v["num_attention_heads"],
                head_dim=v["hidden_size"] // v["num_attention_heads"],
                layernorm_eps=v["layer_norm_eps"],
                patch_size=v["patch_size"], image_size=v["image_size"],
                text_dim=conf["hidden_size"])


def make_weights(cfg, conf: dict, seed: int, device) -> MultiWeights:
    s = conf["serve"]
    return MultiWeights(
        phi3.make_weights(cfg, conf, seed, device),
        make_vision_weights(vision_dims(conf), s["quant"], s["group_size"],
                            seed, device))


def port_params(cfg, w: MultiWeights):
    return phi3.port_params(cfg, w.text)


# the CLIP tower's per-layer matrices (out, in) and vectors, by the names
# of the port's `models.vision`
def vision_shapes(d: int, h: int) -> Dict[str, Tuple[int, int]]:
    return {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
            "w1": (h, d), "w2": (d, h)}


@dataclasses.dataclass
class VisionWeights:
    """The CLIP tower and the projector, as the benchmark made them."""

    dims: Dict[str, int]              # dim, hidden, layers, heads, ...
    stacks: Dict[str, Tuple[torch.Tensor, torch.Tensor]]   # (L, ...) q, s
    layers: List[Dict[str, object]]   # per layer: QMat views and vectors
    vectors: Dict[str, torch.Tensor]  # (L, n) each
    class_embedding: torch.Tensor
    patch_embedding: torch.Tensor     # (D, 3 * ps * ps) float32
    position_embedding: torch.Tensor  # (positions, D)
    pre_ln_w: torch.Tensor
    pre_ln_b: torch.Tensor
    glb_gn: torch.Tensor
    sub_gn: torch.Tensor
    proj0: W.QMat
    proj0_b: torch.Tensor
    proj1: W.QMat
    proj1_b: torch.Tensor


def make_vision_weights(dims: Dict[str, int], quant: str, gs: int,
                        seed: int, device) -> VisionWeights:
    """Random tower and projector weights: quantized matrices as the text
    model's; layer-norm weights U(0.9, 1.1), biases and the separators
    U(-0.05, 0.05), the patch embedding and the class embedding at the
    input's scale, positions U(-0.1, 0.1)."""
    gen = torch.Generator(device=device)
    d, h, n = dims["dim"], dims["hidden_dim"], dims["n_layers"]
    ps, td = dims["patch_size"], dims["text_dim"]
    npos = (dims["image_size"] // ps) ** 2 + 1
    stacks = {}
    for salt, (name, (o, i)) in enumerate(vision_shapes(d, h).items()):
        stacks[name] = W.random_stack(W.seed_gen(gen, seed, 100 + salt), n,
                                      o, i, quant, gs, device)
    u = lambda shape, salt, lo, hi: lo + (hi - lo) * torch.rand(  # noqa
        shape, device=device, generator=W.seed_gen(gen, seed, salt))
    vectors = {"ln1_w": u((n, d), 120, 0.9, 1.1),
               "ln2_w": u((n, d), 121, 0.9, 1.1)}
    for k, (name, width) in enumerate((("ln1_b", d), ("ln2_b", d),
                                       ("wq_b", d), ("wk_b", d),
                                       ("wv_b", d), ("wo_b", d),
                                       ("w1_b", h), ("w2_b", d))):
        vectors[name] = u((n, width), 122 + k, -0.05, 0.05)
    layers = []
    for l in range(n):
        lw = {name: W.QMat(q[l], s[l], quant, gs,
                           *vision_shapes(d, h)[name])
              for name, (q, s) in stacks.items()}
        lw.update({k: v[l] for k, v in vectors.items()})
        layers.append(lw)
    k_in = 3 * ps * ps
    proj0 = W.random_qmats(W.seed_gen(gen, seed, 140), 1, td, 4 * d, quant,
                           gs, device)[0]
    proj1 = W.random_qmats(W.seed_gen(gen, seed, 141), 1, td, td, quant,
                           gs, device)[0]
    return VisionWeights(
        dims=dict(dims), stacks=stacks, layers=layers, vectors=vectors,
        class_embedding=u((d,), 130, -1.0, 1.0),
        patch_embedding=u((d, k_in), 131, -1.0, 1.0) * (3.0 / k_in) ** 0.5,
        position_embedding=u((npos, d), 132, -0.1, 0.1),
        pre_ln_w=u((d,), 133, 0.9, 1.1), pre_ln_b=u((d,), 134, -0.05, 0.05),
        glb_gn=u((4 * d,), 135, -0.05, 0.05),
        sub_gn=u((4 * d,), 136, -0.05, 0.05),
        proj0=proj0, proj0_b=u((td,), 137, -0.05, 0.05),
        proj1=proj1, proj1_b=u((td,), 138, -0.05, 0.05))


def port_vision(weights: MultiWeights):
    """The port's (VisionConfig, VisionParams, ProcessorConfig,
    ProcessorParams) over the same tensors (`models.phi3v.
    encode_image_to_embeds` takes them)."""
    from lmrs_tpu_torch.config import QuantType
    from lmrs_tpu_torch.models.phi3v import ProcessorConfig, ProcessorParams
    from lmrs_tpu_torch.models.vision import (VisionConfig,
                                              VisionLayerWeights,
                                              VisionParams)
    from lmrs_tpu_torch.quant import QTensor

    w = weights.vision
    dm = w.dims
    quant = w.proj0.quant
    qt = QuantType[quant]
    gs = w.proj0.gs
    vc = VisionConfig(dim=dm["dim"], hidden_dim=dm["hidden_dim"],
                      n_layers=dm["n_layers"], n_heads=dm["n_heads"],
                      head_dim=dm["head_dim"],
                      layernorm_eps=dm["layernorm_eps"],
                      patch_size=dm["patch_size"],
                      image_size=dm["image_size"], quant=qt, group_size=gs)
    shapes = vision_shapes(dm["dim"], dm["hidden_dim"])
    mats = {name: QTensor(q, s, qt, gs, *shapes[name])
            for name, (q, s) in w.stacks.items()}
    layers = VisionLayerWeights(**mats, **w.vectors)
    vp = VisionParams(class_embedding=w.class_embedding,
                      patch_embedding=w.patch_embedding,
                      position_embedding=w.position_embedding,
                      layers=layers, pre_ln_w=w.pre_ln_w,
                      pre_ln_b=w.pre_ln_b)
    pc = ProcessorConfig(hidden_dim=4 * dm["dim"], text_dim=dm["text_dim"],
                         quant=qt, group_size=gs)
    pp = ProcessorParams(glb_gn=w.glb_gn, sub_gn=w.sub_gn,
                         proj0=W.port_qtensor(w.proj0), proj0_b=w.proj0_b,
                         proj1=W.port_qtensor(w.proj1), proj1_b=w.proj1_b)
    return vc, vp, pc, pp
