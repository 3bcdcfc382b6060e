"""Decoder-only transformer forward pass (Gemma-2 / Llama-3.2 / Phi-3.5).

One function serves decode steps (T = 1) and prefill chunks (T rows).  The
layers run in a Python loop over per-layer weights; every matmul goes
through `ops.matmul.qmatmul` (kernels A and B for Q4_0 weights, D, E and F
for Q8_0) and every attention through kernel C (bf16 or f32 KV cache), G
(int8 KV cache) or H (int4 KV cache), which read the cache in place.

Family deltas come from ModelConfig: Gemma-2's unit-offset rmsnorms, extra
pre/post-FFN norms, softcaps, sliding window, sqrt(dim) embedding scale and
GeGLU; Llama-3's RoPE rescale and SwiGLU; Phi-3's longrope and separate
lm_head.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Union

import torch

from lmrs_tpu_torch.config import ModelConfig, ModelType, QuantType, unsupported
from lmrs_tpu_torch.kernels.flash_attention import flash_attention
from lmrs_tpu_torch.kernels.flash_attention_i4 import flash_attention_i4
from lmrs_tpu_torch.kernels.flash_attention_i8 import flash_attention_i8
from lmrs_tpu_torch.ops.activations import gelu_tanh, silu
from lmrs_tpu_torch.ops.matmul import qmatmul
from lmrs_tpu_torch.ops.norms import rmsnorm
from lmrs_tpu_torch.ops.rope import apply_rope
from lmrs_tpu_torch.quant import (QTensor, quantize_kv_rows,
                                  quantize_kv_rows_q4, unpack_q4)


@dataclasses.dataclass
class LayerWeights:
    """Weights of one decoder layer.  wqkv and w13 are the row
    concatenations [q; k; v] and [gate; up]: group quantization is per row,
    so the concatenation is exact and each pair is one matmul."""

    att_norm: torch.Tensor                  # (D,)
    wqkv: QTensor                           # (att_dim + 2 * kv_dim, D)
    wo: QTensor                             # (D, att_dim)
    post_att_norm: torch.Tensor             # (D,)
    pre_ffn_norm: Optional[torch.Tensor]    # (D,) Gemma only
    w13: QTensor                            # (2 * H, D)
    w2: QTensor                             # (D, H)
    post_ffn_norm: Optional[torch.Tensor]   # (D,) Gemma only


@dataclasses.dataclass
class TransformerParams:
    embed: QTensor                          # (V, D); also the tied classifier
    layers: List[LayerWeights]
    final_norm: torch.Tensor                # (D,)
    lm_head: Optional[QTensor]              # (V, D) Phi only
    rope_cos: torch.Tensor                  # (S, head_dim // 2) f32
    rope_sin: torch.Tensor                  # (S, head_dim // 2) f32


@dataclasses.dataclass
class KVCache:
    """K and V caches, (L, S, KH * cache_head_dim) bf16, f32 or int8: the
    (KH, hd) axes merged, so a sequence row of one layer is one contiguous
    stripe.  An int8 cache stores symmetric per-(token, head) quantized
    rows with f32 scales (L, KH, S), sequence last, so that a kernel block,
    which owns one kv head, reads a contiguous run of scales; a float
    cache has no scales.  An int4 cache is an int8 tensor of half the row
    width, two values per byte (`quant.quantize_kv_rows_q4`), with the
    same scales.  The forward pass writes rows in place."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


CacheDtype = Union[torch.dtype, str]
CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "int8": torch.int8, "int4": "int4"}


def init_kv_cache(cfg: ModelConfig, device,
                  dtype: CacheDtype = torch.bfloat16,
                  seq_len: Optional[int] = None) -> KVCache:
    """Preallocate the cache.  `dtype` is torch.bfloat16, torch.float32,
    torch.int8, or the string "int4" (torch has no such dtype: int8 storage
    of half the row width); the names of CACHE_DTYPES are taken too."""
    if isinstance(dtype, str):
        dtype = CACHE_DTYPES.get(dtype, dtype)
    if dtype not in CACHE_DTYPES.values():
        raise ValueError(f"no KV cache of type {dtype!r}: one of "
                         f"{sorted(CACHE_DTYPES)}")
    s_len = seq_len or cfg.seq_len
    row = cfg.n_kv_heads * cfg.cache_head_dim
    packed4 = dtype == "int4"
    if packed4:
        row, dtype = row // 2, torch.int8
    shape = (cfg.n_layers, s_len, row)
    cache = KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                    v=torch.zeros(shape, dtype=dtype, device=device))
    if dtype == torch.int8:
        sshape = (cfg.n_layers, cfg.n_kv_heads, s_len)
        cache.k_scale = torch.zeros(sshape, dtype=torch.float32,
                                    device=device)
        cache.v_scale = torch.zeros(sshape, dtype=torch.float32,
                                    device=device)
    return cache


def embed_tokens(params: TransformerParams, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Gather and dequantize embedding rows; (T,) int -> (T, D) float32.
    The table stays quantized on the device.  Gemma scales embeddings by
    sqrt(dim)."""
    emb = params.embed
    if emb.qtype == QuantType.NONE:
        x = emb.q[tokens].float()
    else:
        rows = emb.q[tokens]
        vals = (unpack_q4(rows, emb.group_size) if emb.qtype == QuantType.Q4_0
                else rows).float()
        gs = emb.group_size
        g = vals.reshape(*vals.shape[:-1], vals.shape[-1] // gs, gs)
        x = (g * emb.s[tokens][..., None]).reshape(*tokens.shape, cfg.dim)
    if cfg.embed_scale_by_sqrt_dim:
        x = x * math.sqrt(cfg.dim)
    return x


def _layer(cfg: ModelConfig, x: torch.Tensor, lw: LayerWeights,
           cache: KVCache, layer: int, cos: torch.Tensor, sin: torch.Tensor,
           pos: int, w8a8: bool) -> torch.Tensor:
    """One decoder layer over T tokens at positions pos..pos+T-1; writes
    the layer's K/V rows (and, for an int8 or int4 cache, their scales)
    into the cache."""
    t_q = x.shape[0]
    gemma = cfg.model_type == ModelType.GEMMA

    xb = rmsnorm(x, lw.att_norm, cfg.rms_norm_eps, cfg.norm_unit_offset)
    qkv = qmatmul(xb, lw.wqkv, w8a8=w8a8)
    a, kv = cfg.att_dim, cfg.kv_dim
    q = qkv[:, :a].reshape(t_q, cfg.n_heads, cfg.head_dim)
    k = qkv[:, a:a + kv].reshape(t_q, cfg.n_kv_heads, cfg.head_dim)
    v = qkv[:, a + kv:].reshape(t_q, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    # zero-pad head_dim to cache_head_dim (Phi): zero q/k lanes add nothing
    # to scores, zero v lanes are sliced off the output
    hd_pad = cfg.cache_head_dim - cfg.head_dim
    if hd_pad:
        pad = lambda a: torch.nn.functional.pad(a, (0, hd_pad))  # noqa: E731
        q, k, v = pad(q), pad(k), pad(v)

    # the cache stores rotated keys
    attn_kw = dict(n_kv=cfg.n_kv_heads, scale=cfg.attn_scale,
                   softcap=cfg.attn_logit_softcap, window=cfg.sliding_window)
    if cache.k.dtype == torch.int8:
        # an int4 cache is int8 storage of half the row width
        packed4 = 2 * cache.k.shape[-1] == cfg.n_kv_heads * cfg.cache_head_dim
        quantize, flash = ((quantize_kv_rows_q4, flash_attention_i4)
                           if packed4 else
                           (quantize_kv_rows, flash_attention_i8))
        # K and V quantize in one pass: rows (2, T, row), scales (2, T, KH)
        rows, scales = quantize(torch.stack([k, v]))
        cache.k[layer, pos:pos + t_q] = rows[0]
        cache.v[layer, pos:pos + t_q] = rows[1]
        cache.k_scale[layer, :, pos:pos + t_q] = scales[0].t()
        cache.v_scale[layer, :, pos:pos + t_q] = scales[1].t()
        att = flash(q, cache.k, cache.v, cache.k_scale, cache.v_scale,
                    layer, pos, **attn_kw)
    else:
        cache.k[layer, pos:pos + t_q] = k.reshape(t_q, -1).to(cache.k.dtype)
        cache.v[layer, pos:pos + t_q] = v.reshape(t_q, -1).to(cache.v.dtype)
        att = flash_attention(q, cache.k, cache.v, layer, pos, **attn_kw)
    if hd_pad:
        att = att[..., :cfg.head_dim]
    o = qmatmul(att.reshape(t_q, cfg.att_dim), lw.wo, w8a8=w8a8)

    if gemma:
        # post-attention norm before the residual add, then pre-FFN norm
        x = x + rmsnorm(o, lw.post_att_norm, cfg.rms_norm_eps, True)
        xb2 = rmsnorm(x, lw.pre_ffn_norm, cfg.rms_norm_eps, True)
    else:
        x = x + o
        xb2 = rmsnorm(x, lw.post_att_norm, cfg.rms_norm_eps, False)

    gu = qmatmul(xb2, lw.w13, w8a8=w8a8)
    gate, up = gu[:, :cfg.hidden_dim], gu[:, cfg.hidden_dim:]
    ff = qmatmul((gelu_tanh(gate) if gemma else silu(gate)) * up, lw.w2,
                 w8a8=w8a8)
    if gemma:
        return x + rmsnorm(ff, lw.post_ffn_norm, cfg.rms_norm_eps, True)
    return x + ff


def forward(params: TransformerParams, cfg: ModelConfig, cache: KVCache,
            x: torch.Tensor, pos: int,
            logit_idx: Union[int, str, None] = None,
            w8a8: bool = True) -> Optional[torch.Tensor]:
    """Run all layers over x (T, D) float32 at positions pos..pos+T-1,
    writing their K/V rows into `cache` in place.  Returns the (V,) float32
    logits of row `logit_idx`, the (T, V) logits of every row for
    `logit_idx="all"` (a speculative verify window), or None.  `w8a8` picks
    the numerics of Q8_0 layer weights at T <= 8 (`ops.matmul.qmatmul`);
    the classifier never quantizes its activations."""
    if x.ndim != 2:
        raise unsupported("a batched forward", "A11 batched serving")
    t_q = x.shape[0]
    if pos + t_q > cache.k.shape[1]:
        raise ValueError(f"context overflow: rows [{pos}, {pos + t_q}) past "
                         f"the cache's {cache.k.shape[1]}")
    cos = params.rope_cos[pos:pos + t_q]
    sin = params.rope_sin[pos:pos + t_q]
    for layer, lw in enumerate(params.layers):
        x = _layer(cfg, x, lw, cache, layer, cos, sin, pos, w8a8)
    if logit_idx is None:
        return None

    every = isinstance(logit_idx, str)
    if every and logit_idx != "all":
        raise ValueError(f"logit_idx is a row or 'all', got {logit_idx!r}")
    xl = rmsnorm(x if every else x[logit_idx:logit_idx + 1],
                 params.final_norm, cfg.rms_norm_eps, cfg.norm_unit_offset)
    cls = params.embed if cfg.tied_lm_head else params.lm_head
    logits = qmatmul(xl, cls, classifier=True)
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        if cfg.parity_gemma_softcap_bug:
            # lm.rs softcaps only logits[0:dim]
            head = torch.tanh(logits[:, :cfg.dim] / cap) * cap
            logits = torch.cat([head, logits[:, cfg.dim:]], dim=-1)
        else:
            logits = torch.tanh(logits / cap) * cap
    return logits if every else logits[0]
