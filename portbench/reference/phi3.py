"""Phi-3 / Phi-3.5 decoder, plain float32 PyTorch, after the published
description (Hugging Face `modeling_phi3.py`): RMSNorm, fused qkv and
gate_up projections, LongRoPE (half-split rotation; `short_factor` for
sequences within `original_max_position_embeddings`, cos and sin scaled by
sqrt(1 + ln(max_position_embeddings / original) / ln(original))), causal
softmax attention, SiLU GLU, a separate lm_head.

Departures, each the benchmark's: the weights are Q4_0 or Q8_0 groups
(values times their group's f32 scale, decoded here from the bytes the
benchmark made: Q4_0 in the port's runtime layout, byte j of a group
holding element j in its low nibble and element j + gs/2 in its high one,
XOR 0x80); everything else is float32 with TF32 off.

`act_quant` / `kv_quant` compute the same model in a lower precision (the
output check's control): every product's input rows quantized per weight
group, or every cached K and V row per (token, head), to int8 (absmax /
127) or to fp8 (e4m3, absmax to 448).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dequant(m) -> torch.Tensor:
    """(out, in) float32 values of a benchmark weight (attributes q, s,
    quant, gs, out_f, in_f)."""
    gs = m.gs
    if m.quant == "Q4_0":
        b = (m.q ^ 0x80).to(torch.int16)
        lo = (b & 15) - 8
        hi = (b >> 4) - 8
        g = m.q.shape[-1] // (gs // 2)
        vals = torch.cat([lo.view(m.out_f, g, gs // 2),
                          hi.view(m.out_f, g, gs // 2)], dim=-1)
    elif m.quant == "Q8_0":
        vals = m.q.to(torch.int16).view(m.out_f, -1, gs)
    else:
        raise ValueError(m.quant)
    return (vals.float() * m.s.float()[..., None]).view(m.out_f, m.in_f)


def dequant_rows(m, rows: torch.Tensor) -> torch.Tensor:
    """Rows `rows` of a weight, dequantized (the embedding gather)."""
    sub = type("Rows", (), {})()
    sub.q, sub.s, sub.quant, sub.gs = m.q[rows], m.s[rows], m.quant, m.gs
    sub.out_f, sub.in_f = rows.shape[0], m.in_f
    return dequant(sub)


def fake_int8(x: torch.Tensor, group: int) -> torch.Tensor:
    """x with each group of `group` values rounded to int8 at absmax/127."""
    g = x.reshape(*x.shape[:-1], -1, group)
    s = g.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.where(s > 0, torch.round(g / torch.where(s > 0, s, 1.0)), 0.0)
    return (q * s).reshape(x.shape)


def fake_fp8(x: torch.Tensor, group: int) -> torch.Tensor:
    """x with each group of `group` values scaled to e4m3's range (absmax
    to 448) and rounded to e4m3."""
    g = x.reshape(*x.shape[:-1], -1, group)
    s = g.abs().amax(dim=-1, keepdim=True) / 448.0
    s = torch.where(s > 0, s, 1.0)
    q = (g / s).to(torch.float8_e4m3fn).float()
    return (q * s).reshape(x.shape)


class Phi3:
    def __init__(self, conf: dict, weights, act_quant: Optional[str] = None,
                 kv_quant: Optional[str] = None):
        self.c = conf
        self.w = weights
        self.act_quant = act_quant
        self.kv_quant = kv_quant
        self.d = conf["hidden_size"]
        self.h = conf["num_attention_heads"]
        self.kh = conf["num_key_value_heads"]
        self.hd = conf.get("head_dim", self.d // self.h)
        self.ff = conf["intermediate_size"]
        self.eps = conf["rms_norm_eps"]

    # -- pieces ---------------------------------------------------------
    def rope(self, n: int, device):
        c = self.c
        half = self.hd // 2
        rs = c.get("rope_scaling") or {}
        orig = c.get("original_max_position_embeddings",
                     c["max_position_embeddings"])
        j = torch.arange(half, dtype=torch.float64)
        inv = 1.0 / (c["rope_theta"] ** (2.0 * j / self.hd))
        scale = 1.0
        if rs.get("type") in ("longrope", "su"):
            if n > orig:
                raise ValueError("long factors are not part of this "
                                 "configuration")
            inv = inv / torch.tensor(rs["short_factor"], dtype=torch.float64)
            ratio = c["max_position_embeddings"] / orig
            if ratio > 1.0:
                scale = math.sqrt(1.0 + math.log(ratio) / math.log(orig))
        ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None]
        cos = (torch.cos(ang) * scale).float().to(device)
        sin = (torch.sin(ang) * scale).float().to(device)
        return cos, sin

    def norm(self, x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.eps) \
            * w.float()

    def mm(self, x, m):
        if self.act_quant == "int8":
            x = fake_int8(x, m.gs)
        elif self.act_quant == "fp8":
            x = fake_fp8(x, m.gs)
        return x @ dequant(m).t()

    def kvq(self, t):
        if self.kv_quant == "int8":
            return fake_int8(t, t.shape[-1])
        if self.kv_quant == "fp8":
            return fake_fp8(t, t.shape[-1])
        return t

    @staticmethod
    def rot(x, cos, sin):
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        c, s = cos[:, None, :], sin[:, None, :]
        return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)

    # -- the model ------------------------------------------------------
    def rows(self, seq, device) -> torch.Tensor:
        """(n, D) float32 input rows of a sequence of token ids, in which
        an item that is not an id stands for rows of its own
        (`item_rows`)."""
        parts, ids = [], []
        for item in seq:
            if isinstance(item, int):
                ids.append(item)
                continue
            if ids:
                parts.append(self.embed_ids(ids, device))
                ids = []
            parts.append(self.item_rows(item, device))
        if ids:
            parts.append(self.embed_ids(ids, device))
        return torch.cat(parts)

    def embed_ids(self, ids, device) -> torch.Tensor:
        t = torch.as_tensor(list(ids), dtype=torch.long, device=device)
        return dequant_rows(self.w.embed, t)

    def item_rows(self, item, device) -> torch.Tensor:
        raise ValueError(f"no rows for {item!r} in a text model")

    def length(self, seq) -> int:
        """Rows of a sequence of ids and items."""
        return sum(1 if isinstance(i, int) else self.item_length(i)
                   for i in seq)

    def item_length(self, item) -> int:
        raise ValueError(f"no rows for {item!r} in a text model")

    @torch.no_grad()
    def logits(self, tokens: Sequence, at: Sequence[int],
               device) -> torch.Tensor:
        """(len(at), V) float32 logits at rows `at` of the causal pass
        over `tokens` (ids, and items with rows of their own)."""
        strict_f32()
        x = self.rows(tokens, device)
        n = x.shape[0]
        cos, sin = self.rope(n, device)
        mask = torch.ones(n, n, dtype=torch.bool, device=device).tril()
        att, kv = self.h * self.hd, self.kh * self.hd
        for lw in self.w.layers:
            xb = self.norm(x, lw["att_norm"])
            qkv = self.mm(xb, lw["wqkv"])
            q = self.rot(qkv[:, :att].view(n, self.h, self.hd), cos, sin)
            k = self.rot(qkv[:, att:att + kv].view(n, self.kh, self.hd),
                         cos, sin)
            v = qkv[:, att + kv:].view(n, self.kh, self.hd)
            k, v = self.kvq(k), self.kvq(v)
            rep = self.h // self.kh
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
            o = torch.empty(n, self.h, self.hd, device=device)
            for h0 in range(0, self.h, 8):      # 8 heads at a time
                s = torch.einsum("qhd,khd->hqk", q[:, h0:h0 + 8],
                                 k[:, h0:h0 + 8]) / math.sqrt(self.hd)
                s = s.masked_fill(~mask, float("-inf")).softmax(-1)
                o[:, h0:h0 + 8] = torch.einsum("hqk,khd->qhd", s,
                                               v[:, h0:h0 + 8])
            x = x + self.mm(o.reshape(n, att), lw["wo"])
            xb = self.norm(x, lw["post_att_norm"])
            gu = self.mm(xb, lw["w13"])
            g, u = gu[:, :self.ff], gu[:, self.ff:]
            x = x + self.mm(torch.nn.functional.silu(g) * u, lw["w2"])
        rows = torch.as_tensor(list(at), dtype=torch.long, device=device)
        xl = self.norm(x[rows], self.w.final_norm)
        head = self.w.lm_head if self.w.lm_head is not None else self.w.embed
        return self.mm(xl, head)


def served_gaps(model: Phi3, context: List, prompt: List[int],
                out: List[int], device) -> torch.Tensor:
    """Per served token, how far its reference logit lies below the
    reference's best at the row that produced it."""
    seq = list(context) + list(prompt) + list(out[:-1])
    first = model.length(context) + len(prompt) - 1
    lg = model.logits(seq, range(first, first + len(out)), device)
    got = lg.gather(1, torch.as_tensor(out, device=device)[:, None])[:, 0]
    return lg.max(dim=1).values - got


def control_gaps(model: Phi3, low: Phi3, context: List[int],
                 prompt: List[int], out: List[int], device) -> torch.Tensor:
    """At each row that produced a served token, how far below the
    reference's best lies the token that `low` (the same model in a lower
    precision, fed the same tokens) puts first."""
    seq = list(context) + list(prompt) + list(out[:-1])
    first = model.length(context) + len(prompt) - 1
    rows = range(first, first + len(out))
    ref = model.logits(seq, rows, device)
    pick = low.logits(seq, rows, device).argmax(dim=1)
    return ref.max(dim=1).values - ref.gather(1, pick[:, None])[:, 0]


MODEL = Phi3
