"""Normalization ops.  All statistics in float32 whatever the input dtype."""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float,
            unit_offset: bool = False) -> torch.Tensor:
    """RMS norm over the last axis:
        ss = 1/sqrt(mean(x^2) + eps);  out = w' * (ss * x)
    where w' = 1 + w when `unit_offset` (Gemma) else w."""
    x32 = x.float()
    ss = torch.mean(x32 * x32, dim=-1, keepdim=True) + eps
    inv = 1.0 / torch.sqrt(ss)
    w = weight.float()
    if unit_offset:
        w = 1.0 + w
    return (w * (inv * x32)).to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """Layer norm over the last axis with the biased variance (the CLIP
    vision encoder's)."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    diff = x32 - mean
    var = torch.mean(diff * diff, dim=-1, keepdim=True)
    inv_std = 1.0 / torch.sqrt(var + eps)
    out = diff * inv_std * weight.float() + bias.float()
    return out.to(x.dtype)
