"""The system under test, built from a configuration file: the port's
`ModelConfig`, its weights from the seed, and the batched server
(`BatchScheduler` on a paged pool, stepped by a `SchedulerThread`) with the
settings `serve/backend.py` passes for `--batch N --max-ctx C
--pool-tokens P`."""

from __future__ import annotations

from portbench import weights as W

# `model_type` of a Hugging Face config -> the port's decoder family
FAMILIES = {"phi3": "PHI", "phi3_v": "PHI", "llama": "LLAMA",
            "gemma2": "GEMMA"}


def port_config(conf: dict):
    """The port's ModelConfig of a configuration file: the published sizes,
    the served context (`max_context`) as its seq_len, the served weight
    type."""
    from lmrs_tpu_torch.config import ModelConfig, ModelType, QuantType

    mt = ModelType[FAMILIES[conf["model_type"]]]
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
              multimodal=conf["model_type"] == "phi3_v",
              tied_lm_head=conf["tie_word_embeddings"])
    rs = conf.get("rope_scaling") or {}
    if rs.get("type") == "longrope":
        kw["rope_short_factor"] = tuple(rs["short_factor"])
    return ModelConfig.make(mt, **kw)


def build_text(conf: dict, seed: int, device):
    """(cfg, the benchmark's weights, the port's params over them)."""
    cfg = port_config(conf)
    s = conf["serve"]
    w = W.make_text_weights(cfg, s["quant"], s["group_size"], seed, device,
                            conf.get("synthetic_weights"))
    return cfg, w, W.port_params(cfg, w)


def build_scheduler(cfg, params, conf: dict, batch: int, seed: int, device,
                    cache_dtype=None):
    """The backend's batched scheduler (`serve/backend.py`: page 512,
    prefill chunk min(256, page), decode chunk 8, its temperature and
    top-p, W8A8 on) over a paged pool of `pool_tokens`."""
    from lmrs_tpu_torch.serve.scheduler import BatchScheduler

    s = conf["serve"]
    return BatchScheduler(
        cfg, params, max_batch=batch, max_ctx=conf["max_context"],
        cache_dtype=cache_dtype or s["cache_dtype"],
        temperature=s["temperature"], top_p=s["top_p"], seed=seed,
        pool_tokens=s["pool_tokens"], page_size=s["page_size"],
        prefill_chunk=min(s["prefill_chunk"], s["page_size"]),
        decode_chunk=s["decode_chunk"], w8a8=s["w8a8"], device=device)


class MultiWeights:
    """A multimodal model's weights: `text` (weights.TextWeights) and
    `vision` (weights.VisionWeights)."""

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


def build_vision(conf: dict, seed: int, device):
    """(the benchmark's tower and projector weights, the port's
    (VisionConfig, VisionParams, ProcessorConfig, ProcessorParams))."""
    s = conf["serve"]
    vw = W.make_vision_weights(vision_dims(conf), s["quant"],
                               s["group_size"], seed, device)
    return vw, W.port_vision(vw)
