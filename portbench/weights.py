"""Random model weights made on the card from the run's seed.

The weights are inputs of the benchmark, made by it and handed to both
sides: the port gets them as its `TransformerParams` (quantized matrices in
the runtime layout the port's loader builds), the plain reference reads the
same bytes and scales through its own decoding (`reference/`).  Each kind
of matrix is made for all layers in one call of a `torch.Generator` on the
card, in the type it is served in, and the layers are views of it.

Values: uniform and centred, -7..7 (Q4_0) or -127..127 (Q8_0), as the
exporter's symmetric rounding leaves them: a value range with a mean off 0
(all 16 nibbles, say) gives every row of every matrix a shared component,
the residual stream a fixed direction, and the logits the same few
winners by wide margins whatever the input.  A group's scale |s| =
U(0.5, 1.5) / (std(values) sqrt(fan_in)), so a matrix keeps its input's
scale; negative for Q4_0 as the exporter writes it (absmax / -7.5).  Norm
weights are U(0.9, 1.1).

Outlier lanes (`kv_outliers`, from the configuration's
`synthetic_weights`): the K and V rows of the lowest-frequency rotary
pairs of every head get scales `scale` times larger, as trained decoders'
keys carry a few large fixed channels.  A cached row's largest value is
then an outlier's, and a cache that rounds each row to its absmax (int8)
loses the rest of the row as such caches do on a trained model; bf16
rounds each value on its own and does not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

# the spread of a uniform value in -7..7 or -127..127
VALUE_STD = {"Q4_0": math.sqrt((15 ** 2 - 1) / 12),
             "Q8_0": math.sqrt((255 ** 2 - 1) / 12)}


@dataclasses.dataclass
class QMat:
    """A quantized (out, in) matrix as the benchmark made it: `q` uint8
    runtime-layout Q4 bytes (out, in/2) or int8 values (out, in), `s` f32
    group scales (out, in/gs)."""

    q: torch.Tensor
    s: torch.Tensor
    quant: str
    gs: int
    out_f: int
    in_f: int


@dataclasses.dataclass
class TextWeights:
    """Every weight of a decoder, by the names the reference uses."""

    embed: QMat
    lm_head: Optional[QMat]           # None: tied to the embedding
    final_norm: torch.Tensor
    # per layer: att_norm, wqkv, wo, post_att_norm, w13, w2
    layers: List[Dict[str, object]]


def _seed(gen: torch.Generator, seed: int, salt: int) -> torch.Generator:
    gen.manual_seed((seed * 1_000_003 + salt) % (1 << 63))
    return gen


def random_qmats(gen: torch.Generator, n: int, out_f: int, in_f: int,
                 quant: str, gs: int, device) -> List[QMat]:
    """n quantized (out_f, in_f) matrices made in two calls, views of one
    stacked (n, ...) tensor each."""
    q, s = random_stack(gen, n, out_f, in_f, quant, gs, device)
    return [QMat(q[i], s[i], quant, gs, out_f, in_f) for i in range(n)]


def random_stack(gen: torch.Generator, n: int, out_f: int, in_f: int,
                 quant: str, gs: int, device):
    """(values, scales) of n quantized matrices, stacked on a leading
    axis."""
    if quant == "Q4_0":
        # nibble codes 1..15 (values -7..7), two to a byte: the runtime
        # layout's byte is (lo | hi << 4) ^ 0x80
        shape = (n, out_f, in_f // 2)
        lo = torch.randint(1, 16, shape, dtype=torch.uint8, device=device,
                           generator=gen)
        hi = torch.randint(1, 16, shape, dtype=torch.uint8, device=device,
                           generator=gen)
        q = (lo | (hi << 4)) ^ 0x80
        del lo, hi
        sign = -1.0
    elif quant == "Q8_0":
        q = torch.randint(-127, 128, (n, out_f, in_f), dtype=torch.int8,
                          device=device, generator=gen)
        sign = 1.0
    else:
        raise ValueError(f"no random weights of type {quant!r}")
    mag = 1.0 / (VALUE_STD[quant] * math.sqrt(in_f))
    s = torch.rand((n, out_f, in_f // gs), device=device, generator=gen)
    s = (s + 0.5) * (sign * mag)
    return q, s


def text_shapes(cfg) -> Dict[str, Tuple[int, int]]:
    """(out, in) of each layer matrix of a port `ModelConfig`."""
    att, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {"wqkv": (att + 2 * kv, cfg.dim), "wo": (cfg.dim, att),
            "w13": (2 * cfg.hidden_dim, cfg.dim),
            "w2": (cfg.dim, cfg.hidden_dim)}


def kv_outlier_rows(cfg, pairs: int) -> List[int]:
    """Rows of the fused qkv matrix that hold the K and V lanes of each
    head's `pairs` lowest-frequency rotary pairs (half-split rotation: lane
    j turns with lane j + head_dim / 2)."""
    hd, half = cfg.head_dim, cfg.head_dim // 2
    lanes = [half - pairs + j for j in range(pairs)]
    lanes += [hd - pairs + j for j in range(pairs)]
    att, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    return [base + h * hd + lane for base in (att, att + kv)
            for h in range(cfg.n_kv_heads) for lane in lanes]


def make_text_weights(cfg, quant: str, gs: int, seed: int, device,
                      kv_outliers: Optional[dict] = None) -> TextWeights:
    """`kv_outliers`: {"pairs": p, "scale": x} (module note), or None."""
    gen = torch.Generator(device=device)
    n = cfg.n_layers
    mats = {}
    for salt, (name, (o, i)) in enumerate(text_shapes(cfg).items()):
        q, s = random_stack(_seed(gen, seed, salt + 1), n, o, i, quant, gs,
                            device)
        if name == "wqkv" and kv_outliers:
            rows = torch.as_tensor(kv_outlier_rows(cfg,
                                                   kv_outliers["pairs"]),
                                   device=device)
            s[:, rows] *= float(kv_outliers["scale"])
        mats[name] = [QMat(q[l], s[l], quant, gs, o, i) for l in range(n)]
    norms = _seed(gen, seed, 10)
    vec = torch.rand((2 * n + 1, cfg.dim), device=device, generator=norms)
    vec = 0.9 + 0.2 * vec
    embed = random_qmats(_seed(gen, seed, 11), 1, cfg.vocab_size, cfg.dim,
                         quant, gs, device)[0]
    lm_head = None if cfg.tied_lm_head else random_qmats(
        _seed(gen, seed, 12), 1, cfg.vocab_size, cfg.dim, quant, gs,
        device)[0]
    layers = [dict(att_norm=vec[2 * l], post_att_norm=vec[2 * l + 1],
                   **{k: mats[k][l] for k in mats}) for l in range(n)]
    return TextWeights(embed=embed, lm_head=lm_head, final_norm=vec[-1],
                       layers=layers)


def port_params(cfg, w: TextWeights):
    """The port's `TransformerParams` over the same tensors (no copy), with
    the rope tables the port's loader computes."""
    from lmrs_tpu_torch.config import QuantType
    from lmrs_tpu_torch.models.transformer import (LayerWeights,
                                                   TransformerParams)
    from lmrs_tpu_torch.ops.rope import rope_tables
    from lmrs_tpu_torch.quant import QTensor

    def qt(m: QMat) -> QTensor:
        return QTensor(m.q, m.s, QuantType[m.quant], m.gs, m.out_f, m.in_f)

    dev = w.final_norm.device
    layers = [LayerWeights(att_norm=l["att_norm"], wqkv=qt(l["wqkv"]),
                           wo=qt(l["wo"]), post_att_norm=l["post_att_norm"],
                           pre_ffn_norm=None, w13=qt(l["w13"]),
                           w2=qt(l["w2"]), post_ffn_norm=None)
              for l in w.layers]
    cos, sin = rope_tables(cfg)
    return TransformerParams(
        embed=qt(w.embed), layers=layers, final_norm=w.final_norm,
        lm_head=None if w.lm_head is None else qt(w.lm_head),
        rope_cos=torch.from_numpy(cos).to(dev),
        rope_sin=torch.from_numpy(sin).to(dev))


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
    proj0: QMat
    proj0_b: torch.Tensor
    proj1: QMat
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
        stacks[name] = random_stack(_seed(gen, seed, 100 + salt), n, o, i,
                                    quant, gs, device)
    u = lambda shape, salt, lo, hi: lo + (hi - lo) * torch.rand(  # noqa
        shape, device=device, generator=_seed(gen, seed, salt))
    vectors = {"ln1_w": u((n, d), 120, 0.9, 1.1),
               "ln2_w": u((n, d), 121, 0.9, 1.1)}
    for k, (name, width) in enumerate((("ln1_b", d), ("ln2_b", d),
                                       ("wq_b", d), ("wk_b", d),
                                       ("wv_b", d), ("wo_b", d),
                                       ("w1_b", h), ("w2_b", d))):
        vectors[name] = u((n, width), 122 + k, -0.05, 0.05)
    layers = []
    for l in range(n):
        lw = {name: QMat(q[l], s[l], quant, gs, *vision_shapes(d, h)[name])
              for name, (q, s) in stacks.items()}
        lw.update({k: v[l] for k, v in vectors.items()})
        layers.append(lw)
    k_in = 3 * ps * ps
    proj0 = random_qmats(_seed(gen, seed, 140), 1, td, 4 * d, quant, gs,
                         device)[0]
    proj1 = random_qmats(_seed(gen, seed, 141), 1, td, td, quant, gs,
                         device)[0]
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


def port_vision(w: VisionWeights):
    """The port's (VisionConfig, VisionParams, ProcessorConfig,
    ProcessorParams) over the same tensors (`models.phi3v.
    encode_image_to_embeds` takes them)."""
    from lmrs_tpu_torch.config import QuantType
    from lmrs_tpu_torch.models.phi3v import ProcessorConfig, ProcessorParams
    from lmrs_tpu_torch.models.vision import (VisionConfig,
                                              VisionLayerWeights,
                                              VisionParams)
    from lmrs_tpu_torch.quant import QTensor

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

    def one(m: QMat) -> QTensor:
        return QTensor(m.q, m.s, qt, gs, m.out_f, m.in_f)

    pp = ProcessorParams(glb_gn=w.glb_gn, sub_gn=w.sub_gn,
                         proj0=one(w.proj0), proj0_b=w.proj0_b,
                         proj1=one(w.proj1), proj1_b=w.proj1_b)
    return vc, vp, pc, pp
