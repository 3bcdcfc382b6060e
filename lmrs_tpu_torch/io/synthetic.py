"""Random synthetic models — the test and smoke-run substrate.

Random weights at any size (tiny for unit tests, the full Gemma-2-9B shape
for the on-card smoke run) go through the same quantize -> serialize ->
load -> forward pipeline as a converted checkpoint; multimodal files carry
random vision and processor sections too.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from lmrs_tpu_torch.config import ModelConfig, ModelType, QuantType
from lmrs_tpu_torch.io.lmrs import (_processor_tensor_layout, _tensor_layout,
                                    _vision_tensor_layout, pack_header,
                                    pack_processor_header,
                                    pack_vision_header)
from lmrs_tpu_torch.quant import quantize_q40_np, quantize_q80_np


def random_weights(cfg: ModelConfig, seed: int = 0,
                   scale: float = 0.02) -> Dict[str, np.ndarray]:
    """Dense float32 weights for every tensor in the .lmrs layout."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, shape, _ in _tensor_layout(cfg):
        # keep norms near identity so activations stay sane
        std = 0.05 if "norm" in name else scale
        out[name] = rng.normal(0.0, std, size=shape).astype(np.float32)
    return out


def tiny_vision_config(quant: QuantType):
    """A miniature CLIP config (CLIP-L/14-336's structure scaled down; the
    577 positions stay)."""
    from lmrs_tpu_torch.models.vision import VisionConfig

    return VisionConfig(dim=32, hidden_dim=64, n_layers=3, n_heads=2,
                        head_dim=16, layernorm_eps=1e-5, patch_size=14,
                        image_size=336, quant=quant, group_size=16)


def tiny_processor_config(quant: QuantType, text_dim: int):
    from lmrs_tpu_torch.models.phi3v import ProcessorConfig

    return ProcessorConfig(hidden_dim=128, text_dim=text_dim, quant=quant,
                           group_size=16)


def random_multimodal_weights(cfg: ModelConfig, vcfg, pcfg,
                              seed: int = 0) -> Dict[str, np.ndarray]:
    """Text, vision and processor weights for a multimodal .lmrs file (the
    same values as the JAX package's function for the same seed)."""
    rng = np.random.default_rng(seed + 1)
    out = random_weights(cfg, seed)
    for name, shape, _ in (_vision_tensor_layout(vcfg)
                           + _processor_tensor_layout(pcfg)):
        std = 0.05 if ("ln" in name or "_b" in name) else 0.02
        out[name] = rng.normal(0.0, std, size=shape).astype(np.float32)
    return out


def write_synthetic_lmrs(path: str, cfg: ModelConfig, seed: int = 0,
                         scale: float = 0.02, log=None, vision_cfg=None,
                         processor_cfg=None) -> None:
    """Stream a random model of any size straight to a .lmrs file, one
    tensor at a time (a Gemma-2-9B's dense f32 weights are ~37 GB, never
    held in memory at once); a multimodal `cfg` takes its vision and
    processor sections from `vision_cfg` and `processor_cfg`.

    Tensors above 2M values are written as TILED random pools directly in
    the on-disk quantized layout: a smoke-run substrate needs the real byte
    size and layout and sane magnitudes, and generating then quantizing
    every value would take hours of single-core numpy.  Small tensors (unit
    tests, norms) take the exact generate-and-quantize path.  Same output as
    lmrs_tpu.io.synthetic.write_synthetic_lmrs for the same seed."""
    rng = np.random.default_rng(seed)
    pool_size = 1 << 22       # 4M values per pool (>> any tensor row)
    fast_min = 1 << 21        # tensors above 2M values use the pools
    pools: Dict[str, np.ndarray] = {}

    def pool(kind: str, quant, std):
        # 'q' bytes are uniform whatever the quant/std; scales depend on
        # (quant, std), dense floats on std alone
        key = {"q": "q", "s": f"s-{int(quant)}-{std}"}.get(kind, f"f-{std}")
        if key not in pools:
            if kind == "q":       # raw quantized bytes (int8 or packed Q4)
                pools[key] = rng.integers(0, 256, size=pool_size,
                                          dtype=np.uint8)
            elif kind == "s":     # per-group scales |s| ~ std/qmax, jittered
                # 0.5-1.5x; Q4 export scales are negative (absmax/-7.5)
                qmax = 127.0 if quant == QuantType.Q8_0 else 7.5
                sgn = -1.0 if quant == QuantType.Q4_0 else 1.0
                pools[key] = (sgn * (std / qmax)
                              * rng.uniform(0.5, 1.5, size=pool_size)
                              ).astype(np.float32)
            else:                 # dense f32 values
                pools[key] = rng.uniform(-2.0 * std, 2.0 * std,
                                         size=pool_size).astype(np.float32)
        return pools[key]

    def write_tiled(f, p: np.ndarray, n: int):
        reps, rem = divmod(n, p.size)
        data = memoryview(p)
        for _ in range(reps):
            f.write(data)
        if rem:
            f.write(memoryview(p[:rem]))

    def write_section(f, layout, quant, gs):
        for name, shape, quantized in layout:
            if log:
                log(f"synth {name} {shape}")
            std = 0.05 if ("norm" in name or "ln" in name
                           or name.endswith("_b")) else scale
            n = int(np.prod(shape))
            if n >= fast_min:
                if quantized:
                    if n % gs or (quant == QuantType.Q4_0 and n % 2):
                        raise ValueError(
                            f"{name}: {n} values not groupable at gs={gs}")
                    nq = n if quant == QuantType.Q8_0 else n // 2
                    write_tiled(f, pool("q", quant, std), nq)
                    write_tiled(f, pool("s", quant, std), n // gs)
                else:
                    write_tiled(f, pool("f", quant, std), n)
                continue
            w = rng.normal(0.0, std, size=shape).astype(np.float32)
            if not quantized:
                f.write(w.tobytes())
                continue
            if quant == QuantType.Q8_0:
                q, s, _ = quantize_q80_np(w, gs)
            else:
                q, s, _ = quantize_q40_np(w, gs)
            f.write(q.tobytes())
            f.write(s.astype(np.float32).tobytes())

    if cfg.multimodal and (vision_cfg is None or processor_cfg is None):
        raise ValueError("a multimodal file needs vision_cfg and "
                         "processor_cfg")
    with open(path, "wb") as f:
        f.write(pack_header(cfg))
        write_section(f, _tensor_layout(cfg), cfg.quant, cfg.group_size)
        if cfg.multimodal:
            f.write(pack_vision_header(vision_cfg))
            write_section(f, _vision_tensor_layout(vision_cfg),
                          vision_cfg.quant, vision_cfg.group_size)
            f.write(pack_processor_header(processor_cfg))
            write_section(f, _processor_tensor_layout(processor_cfg),
                          processor_cfg.quant, processor_cfg.group_size)


def tiny_config(model_type: ModelType, quant: QuantType,
                **kw) -> ModelConfig:
    """A miniature but structurally faithful config for unit tests."""
    defaults = dict(
        dim=64, hidden_dim=128, n_layers=3, n_heads=4, head_dim=16,
        n_kv_heads=2, vocab_size=512, seq_len=128, rms_norm_eps=1e-6,
        rope_theta=10000.0, quant=quant, group_size=32,
    )
    if model_type == ModelType.PHI:
        # phi's longrope needs head_dim/2 short factors; give a tiny table
        kw.setdefault("rope_short_factor",
                      tuple(1.0 + 0.1 * i for i in range(8)))
    defaults.update(kw)
    return ModelConfig.make(model_type, **defaults)
