"""Activation functions of the FFNs and of the vision encoder."""

from __future__ import annotations

import torch


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU, used by Llama/Phi FFNs."""
    x32 = x.float()
    return (x32 * (1.0 / (1.0 + torch.exp(-x32)))).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU, used by Gemma FFNs."""
    x32 = x.float()
    c = 0.7978845608028654  # sqrt(2/pi)
    inner = c * (x32 + 0.044715 * x32 * x32 * x32)
    return (x32 * 0.5 * (1.0 + torch.tanh(inner))).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """QuickGELU x * sigmoid(1.702 x), used by the CLIP encoder."""
    x32 = x.float()
    return (x32 * (1.0 / (1.0 + torch.exp(-1.702 * x32)))).to(x.dtype)
