"""Phi-3 / Phi-3.5 (`model_type` phi3): a dense decoder, every layer alike
(fused qkv and gate-up matrices, full causal attention, a separate
lm_head), in the port's PHI family with the configuration's longrope
short factors.

Weights (`make_weights`, values as `weights.py` says): each kind of layer
matrix for all layers in one call of a `torch.Generator` on the card, the
layers views of it.  Outlier lanes (`kv_outliers`, from the
configuration's `synthetic_weights`): the K and V rows of the
lowest-frequency rotary pairs of every head get scales `scale` times
larger, as trained decoders' keys carry a few large fixed channels.  A
cached row's largest value is then an outlier's, and a cache that rounds
each row to its absmax (int8) loses the rest of the row as such caches do
on a trained model; bf16 rounds each value on its own and does not.

Counting rules of a dense decoder (beside `roofline.py`'s shared ones):
- every layer matrix counts once per forward, with the classifier where
  logits are made and the embedding rows gathered;
- a KV row counts at every layer, at the published head_dim (96 for
  Phi-3.5), not the cache's padded lanes; a row that several lanes read
  in one step (a shared prefix page) counts once (`roofline.unique_rows`);
- a query row at position p attends to p + 1 keys at every layer;
- Q8_0 layer products at up to 8 rows under W8A8 take integer
  activations, and count against the int8 peak.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from portbench import roofline as R
from portbench import weights as W

COUNTERS = ()


# -- the port's configuration -------------------------------------------
def config_kw(conf: dict) -> dict:
    """`ModelConfig.make`'s keywords of a Phi-3 configuration file: the
    published sizes, the served context (`max_context`) as its seq_len,
    the served weight type."""
    from lmrs_tpu_torch.config import QuantType

    heads = conf["num_attention_heads"]
    kw = dict(dim=conf["hidden_size"], hidden_dim=conf["intermediate_size"],
              n_layers=conf["num_hidden_layers"], n_heads=heads,
              head_dim=conf.get("head_dim", conf["hidden_size"] // heads),
              n_kv_heads=conf["num_key_value_heads"],
              vocab_size=conf["vocab_size"], seq_len=conf["max_context"],
              rms_norm_eps=conf["rms_norm_eps"],
              rope_theta=conf["rope_theta"],
              quant=QuantType[conf["serve"]["quant"]],
              group_size=conf["serve"]["group_size"],
              tied_lm_head=conf["tie_word_embeddings"])
    rs = conf.get("rope_scaling") or {}
    if rs.get("type") == "longrope":
        kw["rope_short_factor"] = tuple(rs["short_factor"])
    return kw


def port_config(conf: dict):
    from lmrs_tpu_torch.config import ModelConfig, ModelType

    return ModelConfig.make(ModelType.PHI, multimodal=False,
                            **config_kw(conf))


# -- the weights ----------------------------------------------------------
@dataclasses.dataclass
class TextWeights:
    """Every weight of a decoder, by the names the reference uses."""

    embed: W.QMat
    lm_head: Optional[W.QMat]         # None: tied to the embedding
    final_norm: torch.Tensor
    # per layer: att_norm, wqkv, wo, post_att_norm, w13, w2
    layers: List[Dict[str, object]]


def layer_matrices(cfg) -> Dict[str, tuple]:
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


def make_weights(cfg, conf: dict, seed: int, device) -> TextWeights:
    """Random weights of the served type; the configuration's
    `synthetic_weights` ({"pairs": p, "scale": x}, module note) or none."""
    quant, gs = conf["serve"]["quant"], conf["serve"]["group_size"]
    kv_outliers = conf.get("synthetic_weights")
    gen = torch.Generator(device=device)
    n = cfg.n_layers
    mats = {}
    for salt, (name, (o, i)) in enumerate(layer_matrices(cfg).items()):
        q, s = W.random_stack(W.seed_gen(gen, seed, salt + 1), n, o, i,
                              quant, gs, device)
        if name == "wqkv" and kv_outliers:
            rows = torch.as_tensor(kv_outlier_rows(cfg,
                                                   kv_outliers["pairs"]),
                                   device=device)
            s[:, rows] *= float(kv_outliers["scale"])
        mats[name] = [W.QMat(q[l], s[l], quant, gs, o, i) for l in range(n)]
    norms = W.seed_gen(gen, seed, 10)
    vec = torch.rand((2 * n + 1, cfg.dim), device=device, generator=norms)
    vec = 0.9 + 0.2 * vec
    embed = W.random_qmats(W.seed_gen(gen, seed, 11), 1, cfg.vocab_size,
                           cfg.dim, quant, gs, device)[0]
    lm_head = None if cfg.tied_lm_head else W.random_qmats(
        W.seed_gen(gen, seed, 12), 1, cfg.vocab_size, cfg.dim, quant, gs,
        device)[0]
    layers = [dict(att_norm=vec[2 * l], post_att_norm=vec[2 * l + 1],
                   **{k: mats[k][l] for k in mats}) for l in range(n)]
    return TextWeights(embed=embed, lm_head=lm_head, final_norm=vec[-1],
                       layers=layers)


def port_params(cfg, w: TextWeights):
    """The port's `TransformerParams` over the same tensors (no copy), with
    the rope tables the port's loader computes."""
    from lmrs_tpu_torch.models.transformer import (LayerWeights,
                                                   TransformerParams)
    from lmrs_tpu_torch.ops.rope import rope_tables

    qt = W.port_qtensor
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


# -- the costs ------------------------------------------------------------
def layer_macs(cfg) -> int:
    """Multiply-accumulates of one row through one layer's matrices."""
    return sum(o * i for o, i in layer_matrices(cfg).values())


def weight_bytes(cfg, quant: str, gs: int, logits: bool,
                 embed_rows: int) -> float:
    per_layer = sum(R.matrix_bytes(o, i, quant, gs)
                    for o, i in layer_matrices(cfg).values())
    b = cfg.n_layers * per_layer
    if logits:
        b += R.matrix_bytes(cfg.vocab_size, cfg.dim, quant, gs)
    b += embed_rows * R.matrix_bytes(1, cfg.dim, quant, gs)
    return b


def kv_row_bytes(cfg, cache_dtype: str) -> float:
    """One token's K and V over all layers, at the published head_dim."""
    return (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
            * R.CACHE_BYTES[cache_dtype])


def sizes(fwd: dict) -> tuple:
    """(KV rows read, keys summed over the query rows, embedding rows
    gathered) of a recorded forward."""
    rows = fwd["rows"]
    if fwd["kind"] == "decode":
        lanes = fwd["lanes"]
        return (R.unique_rows(lanes, fwd["page_size"]),
                sum(r for _, r in lanes), rows)
    p = fwd["start"]
    return (p + rows, rows * p + rows * (rows + 1) // 2,
            0 if fwd["kind"] == "embeds" else rows)


def forward_cost(cfg, conf: dict, fwd: dict,
                 counts: Dict[str, float]) -> Dict[str, float]:
    """Bytes and operations of one forward: its inputs and outputs
    (weights, the KV rows read and written, the logits), not what passes
    between its kernels."""
    s = conf["serve"]
    quant, gs = s["quant"], s["group_size"]
    rows, logit_rows = fwd["rows"], fwd["logit_rows"]
    kv_read, keys, embed_rows = sizes(fwd)
    int8_rows = quant == "Q8_0" and s["w8a8"] and fwd["t_q"] <= 8
    mm = 2.0 * rows * cfg.n_layers * layer_macs(cfg)
    cls = 2.0 * logit_rows * cfg.vocab_size * cfg.dim
    att = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * keys
    nbytes = (weight_bytes(cfg, quant, gs, logit_rows > 0, embed_rows)
              + (kv_read + rows) * kv_row_bytes(cfg, s["cache_dtype"])
              + 4.0 * logit_rows * cfg.vocab_size)
    return dict(bytes=nbytes, ops_bf16=(0.0 if int8_rows else mm) + cls + att,
                ops_int8=mm if int8_rows else 0.0)


def attention_cost(cfg, conf: dict, fwd: dict,
                   counts: Dict[str, float]) -> Dict[str, float]:
    """A decode step's attention over all layers: the KV rows it needs
    (each once), q in and the output out, and QK^T and PV."""
    kv_read, keys, _ = sizes(fwd)
    nbytes = (kv_read * kv_row_bytes(cfg, conf["serve"]["cache_dtype"])
              + 2 * 4.0 * fwd["rows"] * cfg.n_layers * cfg.n_heads
              * cfg.head_dim)
    ops = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * keys
    return dict(bytes=nbytes, ops_bf16=ops, ops_int8=0.0)
