"""Rotary position embeddings — plain, Llama-3-rescaled, and Phi-3 longrope.

cos/sin tables for every position are computed once on the host (float64
numpy, stored float32) and rows are gathered per step.  Pairs (j, j +
head_dim/2) rotate together (the "half-split" convention).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lmrs_tpu_torch.config import ModelConfig, ModelType


def rope_tables(cfg: ModelConfig) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables of shape (seq_len, head_dim//2), float32, with the
    Llama-3 wavelength-dependent rescale or the Phi-3 longrope short factors
    and attention scale folded in."""
    half = cfg.head_dim // 2
    j = np.arange(half, dtype=np.float64)
    freq = 1.0 / np.power(np.float64(cfg.rope_theta), 2.0 * j / cfg.head_dim)
    scaling = 1.0

    if cfg.model_type == ModelType.LLAMA and cfg.rope_scaling is not None:
        rs = cfg.rope_scaling
        wavelen = (2.0 * math.pi) / freq
        low_wl = rs.original_context_len / rs.low_freq_factor
        high_wl = rs.original_context_len / rs.high_freq_factor
        smooth = (rs.original_context_len / wavelen - rs.low_freq_factor) / (
            rs.high_freq_factor - rs.low_freq_factor)
        mid = (1.0 - smooth) * freq / rs.factor + smooth * freq
        freq = np.where(wavelen > low_wl, freq / rs.factor,
                        np.where(wavelen >= high_wl, mid, freq))

    if cfg.model_type == ModelType.PHI and cfg.rope_short_factor is not None:
        sf = np.asarray(cfg.rope_short_factor, dtype=np.float64)
        if sf.shape != (half,):
            raise ValueError(f"rope_short_factor has {sf.shape[0]} entries, "
                             f"head_dim/2={half}")
        freq = freq / sf
        scaling = cfg.rope_attn_scale

    pos = np.arange(cfg.seq_len, dtype=np.float64)
    angles = pos[:, None] * freq[None, :]
    cos = (np.cos(angles) * scaling).astype(np.float32)
    sin = (np.sin(angles) * scaling).astype(np.float32)
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate half-split pairs.  x: (T, H, head_dim); cos/sin: (T,
    head_dim//2) rows for the tokens' absolute positions."""
    half = x.shape[-1] // 2
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    c = cos[:, None, :]   # broadcast over heads
    s = sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)
