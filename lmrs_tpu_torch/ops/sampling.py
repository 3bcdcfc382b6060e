"""Token sampling: greedy, multinomial, and nucleus (top-p), for one
sequence and per slot for a batch (`sample_batched`).

Random draws come from an explicit `torch.Generator` on the logits'
device.  Greedy decoding (temperature 0) needs none.
"""

from __future__ import annotations

import torch


def sample_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy: the first index of the max logit (torch.argmax keeps the
    earliest index on ties)."""
    return torch.argmax(logits, dim=-1)


def sample_multinomial(logits: torch.Tensor, temperature: float,
                       generator: torch.Generator) -> torch.Tensor:
    """softmax(logits / T), then one categorical draw."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)


def _nucleus(probs: torch.Tensor, top_p: float):
    """(sorted probabilities with everything past the nucleus zeroed, the
    descending order).  The nucleus is the smallest probability-sorted
    prefix whose cumulative mass exceeds top_p."""
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True)
    csum = torch.cumsum(sorted_probs, dim=-1)
    keep = torch.roll(csum, 1, dims=-1) < top_p
    keep[..., 0] = True
    return torch.where(keep, sorted_probs, 0.0), order


def sample_topp(logits: torch.Tensor, temperature: float, top_p: float,
                generator: torch.Generator) -> torch.Tensor:
    """Nucleus sampling: draw from the nucleus, renormalized."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    filtered, order = _nucleus(probs, top_p)
    idx = torch.multinomial(filtered, 1, generator=generator)
    return torch.gather(order, -1, idx).squeeze(-1)


def sample(logits: torch.Tensor, temperature: float, top_p: float,
           generator: torch.Generator) -> torch.Tensor:
    """Greedy at temperature 0, nucleus for top_p in (0, 1), plain
    multinomial otherwise.  Returns a device scalar tensor."""
    if temperature == 0.0:
        return sample_argmax(logits)
    if top_p <= 0.0 or top_p >= 1.0:
        return sample_multinomial(logits, temperature, generator)
    return sample_topp(logits, temperature, top_p, generator)


def processed_probs(logits: torch.Tensor, temperature: float,
                    top_p: float) -> torch.Tensor:
    """The exact distribution `sample` draws from at temperature > 0, as an
    explicit (..., V) probability tensor: softmax at `temperature`, then,
    when top_p is in (0, 1), the nucleus truncation, renormalized."""
    t = max(float(temperature), 1e-6)
    probs = torch.softmax(logits.float() / t, dim=-1)
    if not 0.0 < top_p < 1.0:
        return probs
    filtered, order = _nucleus(probs, top_p)
    p = torch.zeros_like(filtered).scatter(-1, order, filtered)
    return p / p.sum(dim=-1, keepdim=True)


def sample_batched(logits: torch.Tensor, temperature: torch.Tensor,
                   top_p: torch.Tensor, generator: torch.Generator,
                   any_sampled: bool) -> torch.Tensor:
    """Per-slot sampling: logits (B, V), temperature and top_p (B,) device
    tensors -> (B,) long.  Per slot: temperature 0 -> argmax; top_p in
    (0, 1) -> nucleus; otherwise plain multinomial.  A greedy slot gives
    exactly `sample_argmax` of its row whatever the other slots hold.

    `any_sampled` says whether any slot has temperature > 0.  The caller
    knows it on the host (the scheduler keeps the temperatures there), so
    an all-greedy batch skips the (B, V) sort without a device read."""
    greedy = torch.argmax(logits, dim=-1)
    if not any_sampled:
        return greedy
    t_safe = temperature.float().clamp(min=1e-6)[:, None]
    probs = torch.softmax(logits.float() / t_safe, dim=-1)
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True)
    csum = torch.cumsum(sorted_probs, dim=-1)
    # outside (0, 1) a slot keeps its whole distribution
    nucleus = (top_p > 0.0) & (top_p < 1.0)
    p_eff = torch.where(nucleus, top_p.float(), 2.0)[:, None]
    keep = torch.roll(csum, 1, dims=-1) < p_eff
    keep[:, 0] = True
    filtered = torch.where(keep, sorted_probs, 0.0)
    idx = torch.multinomial(filtered, 1, generator=generator)
    sampled = torch.gather(order, -1, idx)[:, 0]
    return torch.where(temperature == 0.0, greedy, sampled)

