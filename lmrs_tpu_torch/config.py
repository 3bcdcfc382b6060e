"""Model configuration for the three supported decoder families.

The `.lmrs` binary header carries the shape hyperparameters; several
per-family constants (Gemma's softcaps, sliding window and unit-offset
norms, Llama-3's RoPE rescale, Phi-3.5's longrope) are explicit fields
here.  Same fields and presets as `lmrs_tpu.config`; a rank's LOCAL
config under tensor and context parallelism is `local_config`'s.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple


class ModelType(enum.IntEnum):
    """Decoder family, as the `.lmrs` header encodes it."""

    GEMMA = 0
    LLAMA = 1
    PHI = 2


class QuantType(enum.IntEnum):
    """On-disk / on-device weight encoding, as the `.lmrs` header encodes it."""

    NONE = 0
    Q8_0 = 1
    Q4_0 = 2


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3 style RoPE frequency rescale."""

    factor: float = 32.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_context_len: float = 8192.0


# Phi-3.5 "longrope" short factors for head_dim=96 (48 rotary pairs).
PHI3_SHORT_FACTOR: Tuple[float, ...] = (
    1.08, 1.1, 1.1300000000000001, 1.2800000000000002, 1.3100000000000003,
    1.4500000000000004, 1.4500000000000004, 1.9500000000000008,
    2.030000000000001, 2.4299999999999926, 2.5699999999999896,
    2.9499999999999815, 3.729999999999965, 3.869999999999962,
    4.189999999999955, 4.43999999999995, 4.6399999999999455,
    4.979999999999938, 5.159999999999934, 5.279999999999932,
    5.759999999999922, 5.889999999999919, 5.889999999999919,
    5.969999999999917, 6.089999999999915, 6.2799999999999105,
    6.7699999999999, 6.8899999999998975, 7.109999999999893,
    7.129999999999892, 7.179999999999891, 7.289999999999889,
    7.339999999999888, 7.559999999999883, 7.619999999999882,
    7.69999999999988, 7.879999999999876, 7.879999999999876,
    7.879999999999876, 7.939999999999875, 7.949999999999875,
    7.979999999999874, 8.19999999999987, 8.439999999999864,
    8.469999999999864, 8.589999999999861, 8.809999999999857,
    8.999999999999853,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static hyperparameters of a text decoder (the `.lmrs` v4 header plus
    the per-family constants)."""

    model_type: ModelType
    dim: int
    hidden_dim: int
    n_layers: int
    n_heads: int
    head_dim: int
    n_kv_heads: int
    vocab_size: int
    seq_len: int
    rms_norm_eps: float
    rope_theta: float
    quant: QuantType = QuantType.NONE
    group_size: int = 128
    multimodal: bool = False

    # Gemma-2: attention logit softcap
    attn_logit_softcap: Optional[float] = None
    # Gemma-2: final logit softcap
    final_logit_softcap: Optional[float] = None
    # Gemma-2: sliding attention window
    sliding_window: Optional[int] = None
    # Gemma-2: rmsnorm computes (1 + w) * x_hat
    norm_unit_offset: bool = False
    # Gemma-2: embeddings scaled by sqrt(dim)
    embed_scale_by_sqrt_dim: bool = False
    # Llama-3 RoPE rescale
    rope_scaling: Optional[RopeScaling] = None
    # Phi-3.5 longrope
    rope_short_factor: Optional[Tuple[float, ...]] = None
    rope_attn_scale: float = 1.0
    # Phi has a separate lm_head; Gemma/Llama tie it to the embedding table
    tied_lm_head: bool = True
    # Replicate the lm.rs bug that applies the Gemma final softcap only to
    # the first `dim` logits.  Off by default: the softcap then covers ALL
    # logits, which is what Gemma-2 specifies.
    parity_gemma_softcap_bug: bool = False
    # Run each layer's whole FFN ([gate; up] matmul, GLU, down matmul) as
    # one fused kernel at up to 16 rows: K `ffn_fused_xe` at T <= 8, L
    # `ffn_fused` at 9..16 (`models.transformer._layer_post`).  Off by
    # default, as in the JAX package; the .lmrs header does not carry it,
    # so the CLI and the backend keep it off.  It implies the fast bf16
    # numerics for the FFN: a Q8_0 layer's FFN then takes no W8A8.
    fuse_ffn: bool = False
    # A rank's LOCAL config (`local_config`) names the parallel axes, as
    # the JAX package's does: with tp_axis set the head counts and
    # hidden_dim above are the rank's share of tp, with cp_axis set the KV
    # cache is the rank's sequence shard (cp_degree shards), and the
    # forward pass places the collectives (`models.transformer`).  None,
    # None and 1 on one device.
    tp_axis: Optional[str] = None
    cp_axis: Optional[str] = None
    cp_degree: int = 1

    # ---- derived sizes ----
    @property
    def att_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def attn_scale(self) -> float:
        return 1.0 / math.sqrt(self.head_dim)

    @property
    def cache_head_dim(self) -> int:
        """KV-cache head dim: a head_dim that neither divides nor is a
        multiple of 128 (Phi's 96) is zero-padded up to the next multiple of
        128.  Zero-padded q/k/v add nothing to scores or outputs, and the
        attention kernel then sees only the head dims it is built for."""
        hd = self.head_dim
        if hd % 128 == 0 or 128 % hd == 0:
            return hd
        return ((hd + 127) // 128) * 128

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def family_defaults(model_type: ModelType) -> dict:
        if model_type == ModelType.GEMMA:
            return dict(
                attn_logit_softcap=50.0,
                final_logit_softcap=30.0,
                sliding_window=4096,
                norm_unit_offset=True,
                embed_scale_by_sqrt_dim=True,
                tied_lm_head=True,
            )
        if model_type == ModelType.LLAMA:
            return dict(rope_scaling=RopeScaling(), tied_lm_head=True)
        if model_type == ModelType.PHI:
            return dict(
                rope_short_factor=PHI3_SHORT_FACTOR,
                # sqrt(1 + ln(131072/4096)/ln(4096))
                rope_attn_scale=math.sqrt(
                    1.0 + math.log(131072.0 / 4096.0) / math.log(4096.0)
                ),
                tied_lm_head=False,
            )
        raise ValueError(f"unknown model type {model_type}")

    @classmethod
    def make(cls, model_type: ModelType, **kw) -> "ModelConfig":
        """Build a config with the family constants filled in."""
        defaults = cls.family_defaults(model_type)
        defaults.update(kw)
        return cls(model_type=model_type, **defaults)


# Published configurations (hyperparameters from the models' config.json,
# the values the `.lmrs` header carries).

def gemma2_2b(**kw) -> ModelConfig:
    return ModelConfig.make(
        ModelType.GEMMA, dim=2304, hidden_dim=9216, n_layers=26, n_heads=8,
        head_dim=256, n_kv_heads=4, vocab_size=256000, seq_len=8192,
        rms_norm_eps=1e-6, rope_theta=10000.0, **kw)


def gemma2_9b(**kw) -> ModelConfig:
    return ModelConfig.make(
        ModelType.GEMMA, dim=3584, hidden_dim=14336, n_layers=42, n_heads=16,
        head_dim=256, n_kv_heads=8, vocab_size=256000, seq_len=8192,
        rms_norm_eps=1e-6, rope_theta=10000.0, **kw)


def llama32_1b(**kw) -> ModelConfig:
    return ModelConfig.make(
        ModelType.LLAMA, dim=2048, hidden_dim=8192, n_layers=16, n_heads=32,
        head_dim=64, n_kv_heads=8, vocab_size=128256, seq_len=8192,
        rms_norm_eps=1e-5, rope_theta=500000.0, **kw)


def llama32_3b(**kw) -> ModelConfig:
    return ModelConfig.make(
        ModelType.LLAMA, dim=3072, hidden_dim=8192, n_layers=28, n_heads=24,
        head_dim=128, n_kv_heads=8, vocab_size=128256, seq_len=8192,
        rms_norm_eps=1e-5, rope_theta=500000.0, **kw)


def phi35_mini(**kw) -> ModelConfig:
    return ModelConfig.make(
        ModelType.PHI, dim=3072, hidden_dim=8192, n_layers=32, n_heads=32,
        head_dim=96, n_kv_heads=32, vocab_size=32064, seq_len=8192,
        rms_norm_eps=1e-5, rope_theta=10000.0, **kw)


def phi35_vision(**kw) -> ModelConfig:
    """Phi-3.5-vision: the mini text backbone with the CLIP ViT-L/14-336
    encoder beside it (`phi35_vision_aux`)."""
    kw.setdefault("multimodal", True)
    return phi35_mini(**kw)


def phi35_vision_aux(quant, group_size: int = 128):
    """The full-size vision and processor configs of a Phi-3.5-vision
    export: CLIP-L dims, the 4x-merged processor into the 3,072-wide text
    embedding."""
    from lmrs_tpu_torch.models.phi3v import ProcessorConfig
    from lmrs_tpu_torch.models.vision import VisionConfig

    return (VisionConfig(dim=1024, hidden_dim=4096, n_layers=24, n_heads=16,
                         head_dim=64, layernorm_eps=1e-5, patch_size=14,
                         image_size=336, quant=quant, group_size=group_size),
            ProcessorConfig(hidden_dim=4096, text_dim=3072, quant=quant,
                            group_size=group_size))


def tiny_llama(**kw) -> ModelConfig:
    """Small synthetic config for CPU runs — not a published model."""
    kw.setdefault("group_size", 32)
    return ModelConfig.make(
        ModelType.LLAMA, dim=256, hidden_dim=512, n_layers=4, n_heads=8,
        head_dim=32, n_kv_heads=4, vocab_size=2048, seq_len=512,
        rms_norm_eps=1e-5, rope_theta=500000.0, **kw)


def tiny_gemma(**kw) -> ModelConfig:
    kw.setdefault("group_size", 32)
    return ModelConfig.make(
        ModelType.GEMMA, dim=256, hidden_dim=512, n_layers=4, n_heads=8,
        head_dim=32, n_kv_heads=4, vocab_size=2048, seq_len=512,
        rms_norm_eps=1e-6, rope_theta=10000.0, **kw)


def tiny_flash(**kw) -> ModelConfig:
    """Tiny Gemma config with head_dim 128, a head dim the attention kernel
    is built for."""
    kw.setdefault("group_size", 32)
    return ModelConfig.make(
        ModelType.GEMMA, dim=256, hidden_dim=512, n_layers=2, n_heads=4,
        head_dim=128, n_kv_heads=2, vocab_size=2048, seq_len=512,
        rms_norm_eps=1e-6, rope_theta=10000.0, **kw)


PRESETS = {
    "gemma2-2b": gemma2_2b,
    "gemma2-9b": gemma2_9b,
    "llama3.2-1b": llama32_1b,
    "llama3.2-3b": llama32_3b,
    "phi3.5-mini": phi35_mini,
    "phi3.5-vision": phi35_vision,
    "tiny-llama": tiny_llama,
    "tiny-gemma": tiny_gemma,
    "tiny-flash": tiny_flash,
}


def check_divisible(cfg: ModelConfig, tp: int) -> None:
    """Raise unless tp divides what tensor parallelism splits: the kv
    heads, the scale groups of the att and hidden axes (the row-parallel
    wo and w2 split at group edges) and the vocabulary (the embedding and
    classifier rows)."""
    reasons = []
    if cfg.n_kv_heads % tp:
        reasons.append(f"n_kv_heads {cfg.n_kv_heads} % tp")
    if (cfg.att_dim // cfg.group_size) % tp:
        reasons.append("att groups % tp")
    if (cfg.hidden_dim // cfg.group_size) % tp:
        reasons.append("hidden groups % tp")
    if cfg.vocab_size % tp:
        reasons.append("vocab % tp")
    if reasons:
        raise ValueError(f"tp={tp} incompatible: {', '.join(reasons)}")


def local_config(cfg: ModelConfig, tp: int = 1, cp: int = 1) -> ModelConfig:
    """The LOCAL config one rank runs the shared forward with: head counts
    and hidden_dim divided by tp, the axes "tp" and "cp" named where their
    degree is above 1 and cp's degree recorded (the JAX
    `parallel.tp.local_config`), so that `models.transformer` places the
    collectives itself (one forward for one rank and for many).  Raises for a tp that does not divide the model,
    and for a context that cp does not divide."""
    if tp < 1 or cp < 1:
        raise ValueError(f"tp={tp}, cp={cp}: both must be >= 1")
    if tp > 1:
        check_divisible(cfg, tp)
    if cfg.seq_len % cp:
        raise ValueError(f"cp={cp} does not divide seq_len {cfg.seq_len}")
    return cfg.replace(n_heads=cfg.n_heads // tp,
                       n_kv_heads=cfg.n_kv_heads // tp,
                       hidden_dim=cfg.hidden_dim // tp,
                       tp_axis="tp" if tp > 1 else None,
                       cp_axis="cp" if cp > 1 else None, cp_degree=cp)


def resolve_device(device=None):
    """The device an entry point runs on: `cuda` unless the caller asks for
    another one.  Without a GPU and without an explicit device this raises:
    the port never carries on quietly on the CPU."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: lmrs_tpu_torch runs on the GPU unless the "
                "caller passes device='cpu'")
        return torch.device("cuda")
    return torch.device(device)
