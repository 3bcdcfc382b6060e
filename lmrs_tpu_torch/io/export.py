"""Hugging Face safetensors checkpoint -> .lmrs, on the host in numpy.

The output is byte for byte the JAX package's exporter's
(`lmrs_tpu/io/export.py`): the fixed tensor order, Phi's fused tensors
split (qkv_proj into thirds, gate_up_proj into halves), the group size
halved until it divides the hidden size, Q8_0 or Q4_0 quantization with
its max and mean group-error report, and a multimodal checkpoint's vision
and processor sections.  The checkpoint is read by the package's own
safetensors reader (`io.safetensors`), so neither `safetensors` nor torch
is needed.  No device is involved.

Usage:
    python -m lmrs_tpu_torch.io.export --files model-*.safetensors \
        --config config.json --save-path out --type GEMMA \
        [--quantize] [--quantize-type 1|2] [--group-size 128] \
        [--vision-config config.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np

from lmrs_tpu_torch.config import ModelConfig, ModelType, QuantType
from lmrs_tpu_torch.io.lmrs import write_lmrs
from lmrs_tpu_torch.io.safetensors import SafetensorsSource


def gather_weights(src: SafetensorsSource, model_type: ModelType,
                   n_layers: int) -> Dict[str, np.ndarray]:
    """The text weights under their .lmrs layout names."""
    w: Dict[str, np.ndarray] = {}
    w["embed"] = src.collect("model.embed_tokens.weight", m_type="")[0]

    def per_layer(name, arrs):
        if len(arrs) != n_layers:
            raise ValueError(f"{name}: {len(arrs)} tensors for {n_layers} "
                             f"layers")
        for l, a in enumerate(arrs):
            w[f"{name}@{l}"] = a

    per_layer("att_norm", src.collect("input_layernorm"))
    if model_type == ModelType.PHI:
        for i, name in enumerate(("wq", "wk", "wv")):
            per_layer(name, src.collect("self_attn.qkv_proj", splits=3,
                                        split_idx=i))
    else:
        per_layer("wq", src.collect("self_attn.q_proj"))
        per_layer("wk", src.collect("self_attn.k_proj"))
        per_layer("wv", src.collect("self_attn.v_proj"))
    per_layer("wo", src.collect("self_attn.o_proj"))
    per_layer("post_att_norm", src.collect("post_attention_layernorm"))
    if model_type == ModelType.GEMMA:
        per_layer("pre_ffn_norm", src.collect("pre_feedforward_layernorm"))
    if model_type == ModelType.PHI:
        per_layer("w1", src.collect("mlp.gate_up_proj", splits=2,
                                    split_idx=0))
        per_layer("w2", src.collect("mlp.down_proj"))
        per_layer("w3", src.collect("mlp.gate_up_proj", splits=2,
                                    split_idx=1))
    else:
        per_layer("w1", src.collect("mlp.gate_proj"))
        per_layer("w2", src.collect("mlp.down_proj"))
        per_layer("w3", src.collect("mlp.up_proj"))
    if model_type == ModelType.GEMMA:
        per_layer("post_ffn_norm", src.collect("post_feedforward_layernorm"))
    w["final_norm"] = src.collect("model.norm.weight", m_type="")[0]
    if model_type == ModelType.PHI:
        w["lm_head"] = src.collect("lm_head.weight", m_type="")[0]
    return w


def gather_vision_weights(src: SafetensorsSource) -> Dict[str, np.ndarray]:
    """The vision encoder's and the image projector's tensors under their
    .lmrs layout names ("v.*", "p.*")."""
    V = "model.vision_embed_tokens"
    w: Dict[str, np.ndarray] = {}
    w["v.class_embedding"] = src.collect("class_embedding", m_type=V)[0]
    pe = src.collect("patch_embedding.weight", m_type=V)[0]
    w["v.patch_embedding"] = pe.reshape(pe.shape[0], -1)
    w["v.position_embedding"] = src.collect("position_embedding.weight",
                                            m_type=V)[0]
    for name, hf in (("ln1_w", "layer_norm1.weight"),
                     ("ln1_b", "layer_norm1.bias"),
                     ("ln2_w", "layer_norm2.weight"),
                     ("ln2_b", "layer_norm2.bias"),
                     ("wq", "self_attn.q_proj.weight"),
                     ("wq_b", "self_attn.q_proj.bias"),
                     ("wk", "self_attn.k_proj.weight"),
                     ("wk_b", "self_attn.k_proj.bias"),
                     ("wv", "self_attn.v_proj.weight"),
                     ("wv_b", "self_attn.v_proj.bias"),
                     ("wo", "self_attn.out_proj.weight"),
                     ("wo_b", "self_attn.out_proj.bias"),
                     ("w1", "mlp.fc1.weight"), ("w1_b", "mlp.fc1.bias"),
                     ("w2", "mlp.fc2.weight"), ("w2_b", "mlp.fc2.bias")):
        for l, a in enumerate(src.collect(hf, m_type=V)):
            w[f"v.{name}@{l}"] = a
    w["v.pre_ln_w"] = src.collect("pre_layrnorm.weight", m_type=V)[0]
    w["v.pre_ln_b"] = src.collect("pre_layrnorm.bias", m_type=V)[0]

    w["p.glb_gn"] = src.collect("glb_GN", m_type=V)[0].reshape(-1)
    w["p.sub_gn"] = src.collect("sub_GN", m_type=V)[0].reshape(-1)
    projs = src.collect("img_projection", m_type="weight")
    w["p.proj0"], w["p.proj1"] = projs[0], projs[1]
    biases = src.collect("img_projection", m_type="bias")
    w["p.proj0_b"], w["p.proj1_b"] = biases[0], biases[1]
    return w


def export(files: List[str], config: str, save_path: str, model_type: str,
           quantize: bool = False, quantize_type: int = 1,
           group_size: int = 128,
           vision_config: Optional[str] = None) -> str:
    """Write `<save_path>.lmrs` from the checkpoint's `files` and its
    `config.json`; returns the path."""
    from lmrs_tpu_torch.models.phi3v import ProcessorConfig
    from lmrs_tpu_torch.models.vision import VisionConfig

    mt = ModelType[model_type.upper()]
    if vision_config and mt != ModelType.PHI:
        sys.exit("Error: --vision-config can only be used when --type is PHI.")

    with open(config) as f:
        cfg_json = json.load(f)

    qt = QuantType(quantize_type if quantize else 0)
    head_dim = cfg_json.get(
        "head_dim",
        cfg_json["hidden_size"] // cfg_json["num_attention_heads"])

    src = SafetensorsSource(files)

    if quantize:
        dim = cfg_json["hidden_size"]
        while dim % group_size != 0:
            group_size //= 2
            print(f"BACKOFF: reducing group size to {group_size} to fit"
                  " hidden_dim")

    cfg = ModelConfig.make(
        mt, dim=cfg_json["hidden_size"],
        hidden_dim=cfg_json["intermediate_size"],
        n_layers=cfg_json["num_hidden_layers"],
        n_heads=cfg_json["num_attention_heads"], head_dim=head_dim,
        n_kv_heads=cfg_json["num_key_value_heads"],
        vocab_size=cfg_json["vocab_size"],
        seq_len=cfg_json["max_position_embeddings"],
        rms_norm_eps=cfg_json["rms_norm_eps"],
        rope_theta=cfg_json["rope_theta"], quant=qt, group_size=group_size,
        multimodal=bool(vision_config))

    weights = gather_weights(src, mt, cfg.n_layers)
    vcfg = pcfg = None
    if vision_config:
        with open(vision_config) as f:
            vis_json = json.load(f)["vision_config"]
        vcfg = VisionConfig(
            dim=vis_json["hidden_size"],
            hidden_dim=vis_json["intermediate_size"],
            n_layers=vis_json["num_hidden_layers"],
            n_heads=vis_json["num_attention_heads"],
            head_dim=vis_json["hidden_size"] // vis_json["num_attention_heads"],
            layernorm_eps=vis_json["layer_norm_eps"],
            patch_size=vis_json["patch_size"],
            image_size=vis_json["image_size"], quant=qt,
            group_size=group_size)
        pcfg = ProcessorConfig(hidden_dim=vis_json["intermediate_size"],
                               text_dim=cfg_json["hidden_size"], quant=qt,
                               group_size=group_size)
        weights.update(gather_vision_weights(src))

    out_path = f"{save_path}.lmrs"
    errors = write_lmrs(out_path, cfg, weights,
                        seq_len_header=cfg_json["max_position_embeddings"],
                        vision_cfg=vcfg, processor_cfg=pcfg)
    if quantize and errors:
        ew = sorted(errors.values(), reverse=True)
        print(f"Max quantization group error across all weights: {ew[0]}."
              f" Mean: {sum(ew) / len(ew)}.")
    print(f"Successfully converted {model_type} model to lmrs format.")
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Export safetensors model to lm.rs format.")
    p.add_argument("--files", nargs="+", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--save-path", required=True)
    p.add_argument("--quantize", action="store_true")
    p.add_argument("--quantize-type", type=int, default=1,
                   help="1 = Q8_0, 2 = Q4_0")
    p.add_argument("--group-size", type=int, default=128)
    p.add_argument("--type", required=True, choices=["GEMMA", "LLAMA", "PHI"])
    p.add_argument("--vision-config")
    args = p.parse_args(argv)
    if args.quantize and args.quantize_type not in (1, 2):
        p.error("--quantize-type is 1 (Q8_0) or 2 (Q4_0)")
    export(args.files, args.config, args.save_path, args.type,
           args.quantize, args.quantize_type, args.group_size,
           args.vision_config)


if __name__ == "__main__":
    main()
