"""Random synthetic models — the test and smoke-run substrate.

Random weights at any size (tiny for unit tests, the full Gemma-2-9B shape
for the on-card smoke run) go through the same quantize -> serialize ->
load -> forward pipeline as a converted checkpoint.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from lmrs_tpu_torch.config import ModelConfig, ModelType, QuantType
from lmrs_tpu_torch.io.lmrs import _tensor_layout, pack_header
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


def write_synthetic_lmrs(path: str, cfg: ModelConfig, seed: int = 0,
                         scale: float = 0.02, log=None) -> None:
    """Stream a random model of any size straight to a .lmrs file, one
    tensor at a time (a Gemma-2-9B's dense f32 weights are ~37 GB, never
    held in memory at once).

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

    def pool(kind: str, std):
        # 'q' bytes are uniform whatever the quant/std; scales depend on
        # (quant, std), dense floats on std alone
        key = {"q": "q", "s": f"s-{int(cfg.quant)}-{std}"}.get(kind,
                                                                f"f-{std}")
        if key not in pools:
            if kind == "q":       # raw quantized bytes (int8 or packed Q4)
                pools[key] = rng.integers(0, 256, size=pool_size,
                                          dtype=np.uint8)
            elif kind == "s":     # per-group scales |s| ~ std/qmax, jittered
                # 0.5-1.5x; Q4 export scales are negative (absmax/-7.5)
                qmax = 127.0 if cfg.quant == QuantType.Q8_0 else 7.5
                sgn = -1.0 if cfg.quant == QuantType.Q4_0 else 1.0
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

    gs = cfg.group_size
    with open(path, "wb") as f:
        f.write(pack_header(cfg))
        for name, shape, quantized in _tensor_layout(cfg):
            if log:
                log(f"synth {name} {shape}")
            std = 0.05 if "norm" in name else scale
            n = int(np.prod(shape))
            if n >= fast_min:
                if quantized:
                    if n % gs or (cfg.quant == QuantType.Q4_0 and n % 2):
                        raise ValueError(
                            f"{name}: {n} values not groupable at gs={gs}")
                    nq = n if cfg.quant == QuantType.Q8_0 else n // 2
                    write_tiled(f, pool("q", std), nq)
                    write_tiled(f, pool("s", std), n // gs)
                else:
                    write_tiled(f, pool("f", std), n)
                continue
            w = rng.normal(0.0, std, size=shape).astype(np.float32)
            if not quantized:
                f.write(w.tobytes())
                continue
            if cfg.quant == QuantType.Q8_0:
                q, s, _ = quantize_q80_np(w, gs)
            else:
                q, s, _ = quantize_q40_np(w, gs)
            f.write(q.tobytes())
            f.write(s.astype(np.float32).tobytes())


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
