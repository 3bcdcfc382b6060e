"""Decoder-only transformer forward pass (Gemma-2 / Llama-3.2 / Phi-3.5).

`forward` serves one sequence: decode steps (T = 1) and prefill chunks (T
rows).  `forward_batched` serves B sequences at their own positions, t_q
rows each, the continuous-batching step, over a per-slot cache or a shared
page pool (under a recording torch profiler it marks its stages,
`tracing.stage`).  The layers run in a Python loop over per-layer
weights; every matmul goes through `ops.matmul.qmatmul` (kernels A and B
for Q4_0 weights, D, E and F for Q8_0) on all rows at once, and every
attention through kernel C (bf16 or f32 KV cache), G (int8) or H (int4)
for one sequence, I (per-slot cache) or J (page pool) for a batch, which
read the cache in place.  With `cfg.fuse_ffn` a layer's FFN of up to 16
rows is one launch of kernel K (T <= 8) or L (9..16) instead.

Family deltas come from ModelConfig: Gemma-2's unit-offset rmsnorms, extra
pre/post-FFN norms, softcaps, sliding window, sqrt(dim) embedding scale and
GeGLU; Llama-3's RoPE rescale and SwiGLU; Phi-3's longrope and separate
lm_head.

One forward serves one rank and many.  Under a rank's LOCAL config
(`config.local_config`) and its communicator (`parallel.comm.Comm`) the
same functions place the collectives where the JAX package's shard_map
forward places them:
- tp (weights Megatron-sharded, `parallel.tp`): the vocab-sharded
  embedding (masked local gather, then a sum), a sum after wo and after the
  FFN's down product (the fused FFN's too), and the vocab-sharded logits
  gathered before the final softcap;
- cp (the cache's sequence axis sharded): each shard takes the rows it
  owns of a write (row-exact, so a window may straddle a shard edge), and
  attention merges the shards' online-softmax partials: a max, then one
  sum of acc*w and l*w.  A decode call's partials are kernel B1
  (`flash_attention_batched(..., seq_base=, return_lse=True)`, kernel I's
  split pass and kernel M's raw merge); a prefill chunk's (G*T > 64) and an
  int4 cache's are plain torch ops, as the JAX package computes
  `attention_cp` in XLA;
- the sequence-parallel prefill (cp, T > 1, cp | T): each rank projects
  its own T/cp rows; the q/k/v row tiles are gathered for the cache write
  and the merge, the rank keeps its own rows for wo and the FFN, and the
  rows are gathered before the classifier.
Only the ranks of cp index 0 run the classifier: the others hold the same
rows and nobody reads their logits, except in the mesh's decode chunks,
where every rank samples (`forward(..., every_rank=True)`).  `forward` and
`forward_batched` take token ids (an integer tensor, embedded here) or
float rows.  `forward` takes its position from the host (an int) or from
the device (a (1,) int32 tensor with host bounds, the decode chunks'
form), `forward_batched` always from the device.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import List, Optional, Tuple, Union

import torch

from lmrs_tpu_torch.config import ModelConfig, ModelType, QuantType
from lmrs_tpu_torch.kernels import add_launches, graph_launches
from lmrs_tpu_torch.kernels.cuda import graph_kernels
from lmrs_tpu_torch.kernels.ffn_fused import MAX_T as FUSED_MAX_T
from lmrs_tpu_torch.kernels.ffn_fused import MAX_T_XE as FUSED_XE_MAX_T
from lmrs_tpu_torch.kernels.ffn_fused import ffn_fused, ffn_fused_xe
from lmrs_tpu_torch.kernels.flash_attention import (flash_attention,
                                                    position_bounds)
from lmrs_tpu_torch.kernels.flash_attention_batched import \
    flash_attention_batched
from lmrs_tpu_torch.kernels.flash_attention_i4 import flash_attention_i4
from lmrs_tpu_torch.kernels.flash_attention_i8 import flash_attention_i8
from lmrs_tpu_torch.kernels.flash_attention_paged import flash_attention_paged
from lmrs_tpu_torch.kernels.flash_merge import decode_split
from lmrs_tpu_torch.ops.attention import attention_batched_partials
from lmrs_tpu_torch.ops.activations import gelu_tanh, silu
from lmrs_tpu_torch.ops.matmul import qmatmul
from lmrs_tpu_torch.ops.norms import rmsnorm
from lmrs_tpu_torch.ops.rope import apply_rope
from lmrs_tpu_torch.quant import (QTensor, quantize_kv_rows,
                                  quantize_kv_rows_q4, unpack_kv_q4,
                                  unpack_q4)
from lmrs_tpu_torch.tracing import profiling, stage


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


def cache_dtype_of(dtype: CacheDtype) -> CacheDtype:
    """torch.bfloat16, torch.float32, torch.int8 or "int4" for any of
    those or the names of CACHE_DTYPES; raises for anything else."""
    if isinstance(dtype, str):
        dtype = CACHE_DTYPES.get(dtype, dtype)
    if dtype not in CACHE_DTYPES.values():
        raise ValueError(f"no KV cache of type {dtype!r}: one of "
                         f"{sorted(CACHE_DTYPES)}")
    return dtype


def _alloc(cfg: ModelConfig, device, dtype: CacheDtype, lead, rows: int,
           scale_shape) -> KVCache:
    """K and V of shape (*lead, rows, row width) and, for an int8 or int4
    cache, f32 scales of `scale_shape`, all zero.  An int4 cache is int8
    storage of half the row width (torch has no int4 dtype)."""
    dtype = cache_dtype_of(dtype)
    row = cfg.n_kv_heads * cfg.cache_head_dim
    if dtype == "int4":
        row, dtype = row // 2, torch.int8
    shape = (*lead, rows, row)
    cache = KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                    v=torch.zeros(shape, dtype=dtype, device=device))
    if dtype == torch.int8:
        cache.k_scale = torch.zeros(scale_shape, dtype=torch.float32,
                                    device=device)
        cache.v_scale = torch.zeros(scale_shape, dtype=torch.float32,
                                    device=device)
    return cache


def init_kv_cache(cfg: ModelConfig, device,
                  dtype: CacheDtype = torch.bfloat16,
                  seq_len: Optional[int] = None) -> KVCache:
    """Preallocate the cache.  `dtype` is torch.bfloat16, torch.float32,
    torch.int8, or the string "int4" (torch has no such dtype: int8 storage
    of half the row width); the names of CACHE_DTYPES are taken too."""
    s_len = seq_len or cfg.seq_len
    return _alloc(cfg, device, dtype, (cfg.n_layers,), s_len,
                  (cfg.n_layers, cfg.n_kv_heads, s_len))


def init_batched_kv_cache(cfg: ModelConfig, device, n_slots: int,
                          rows: int,
                          dtype: CacheDtype = torch.bfloat16) -> KVCache:
    """The per-slot cache of continuous batching: K and V (B, L, rows,
    KH*hd) and, for int8, scales (B, L, KH, rows).  Slot b's (L, rows, ...)
    block is a single-stream cache (`forward` prefills through it).  int4
    is paged only, as in the JAX scheduler."""
    if cache_dtype_of(dtype) == "int4":
        raise ValueError("the batched int4 KV cache is paged-only (pass "
                         "pool_tokens=...); use int8 for the contiguous "
                         "batched cache")
    return _alloc(cfg, device, dtype, (n_slots, cfg.n_layers), rows,
                  (n_slots, cfg.n_layers, cfg.n_kv_heads, rows))


def init_kv_pool(cfg: ModelConfig, device, n_pages: int, page_size: int,
                 dtype: CacheDtype = torch.bfloat16) -> KVCache:
    """The shared page pool of the paged cache: K and V (L, P, psz, KH*hd)
    (KH*hd/2 bytes for int4) and, for int8 and int4, scales (L, P, KH,
    psz).  Page 0 is the trash page: table entries that no slot owns point
    at it, and rows written through them are never read."""
    return _alloc(cfg, device, dtype, (cfg.n_layers, n_pages), page_size,
                  (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size))


def slot_view(cache: KVCache, i: int) -> KVCache:
    """Slot i's (L, rows, row) block of a per-slot cache: a single-stream
    cache whose writes land in the batched one."""
    return KVCache(cache.k[i], cache.v[i],
                   None if cache.k_scale is None else cache.k_scale[i],
                   None if cache.v_scale is None else cache.v_scale[i])


def new_cache(cfg_l: ModelConfig, device, kind: int, dtype, a: int,
              b: int) -> KVCache:
    """A rank's shard of a cache: kind 0 single-stream of `a` local rows,
    1 per-slot (`a` slots of `b` local rows), 2 a page pool (`a` pages of
    `b` rows)."""
    if kind == 0:
        return init_kv_cache(cfg_l, device, dtype, seq_len=a)
    if kind == 1:
        return init_batched_kv_cache(cfg_l, device, a, b, dtype)
    return init_kv_pool(cfg_l, device, a, b, dtype)


def copy_rows(cache: KVCache, kind: int, src: int, dst: int, n: int,
              cp_rank: int = 0) -> None:
    """The scheduler's prefix forks.  kind 0: per-slot cache, slot dst
    takes slot src's global rows [0, n) (each cp shard its own part of
    them); kind 1: a page pool, page dst takes page src's first n rows."""
    c = cache
    if kind == 0:
        s_loc = c.k.shape[2]
        r = min(max(n - cp_rank * s_loc, 0), s_loc)
        c.k[dst, :, :r] = c.k[src, :, :r]
        c.v[dst, :, :r] = c.v[src, :, :r]
        if c.k_scale is not None:
            c.k_scale[dst, :, :, :r] = c.k_scale[src, :, :, :r]
            c.v_scale[dst, :, :, :r] = c.v_scale[src, :, :, :r]
        return
    c.k[:, dst, :n] = c.k[:, src, :n]
    c.v[:, dst, :n] = c.v[:, src, :n]
    if c.k_scale is not None:
        c.k_scale[:, dst, :, :n] = c.k_scale[:, src, :, :n]
        c.v_scale[:, dst, :, :n] = c.v_scale[:, src, :, :n]


def embed_tokens(params: TransformerParams, cfg: ModelConfig,
                 tokens: torch.Tensor, comm=None) -> torch.Tensor:
    """Gather and dequantize embedding rows; (T,) int -> (T, D) float32.
    The table stays quantized on the device.  Gemma scales embeddings by
    sqrt(dim), after the tp sum.  Under tp the table is this rank's block
    of rows: a masked local gather, then a sum over tp."""
    emb = params.embed
    ok = None
    if cfg.tp_axis is not None:
        vloc = emb.q.shape[0]
        local = tokens - comm.tp_rank * vloc
        ok = (local >= 0) & (local < vloc)
        tokens = local.clamp(0, vloc - 1)
    if emb.qtype == QuantType.NONE:
        x = emb.q[tokens].float()
    else:
        rows = emb.q[tokens]
        vals = (unpack_q4(rows, emb.group_size) if emb.qtype == QuantType.Q4_0
                else rows).float()
        gs = emb.group_size
        g = vals.reshape(*vals.shape[:-1], vals.shape[-1] // gs, gs)
        x = (g * emb.s[tokens][..., None]).reshape(*tokens.shape, cfg.dim)
    if ok is not None:
        x = comm.sum(torch.where(ok[..., None], x, 0.0), "tp")
    if cfg.embed_scale_by_sqrt_dim:
        x = x * math.sqrt(cfg.dim)
    return x


def _attn_kw(cfg: ModelConfig) -> dict:
    return dict(n_kv=cfg.n_kv_heads, scale=cfg.attn_scale,
                softcap=cfg.attn_logit_softcap, window=cfg.sliding_window)


def _rows(params: TransformerParams, cfg: ModelConfig, x: torch.Tensor,
          comm) -> torch.Tensor:
    """(T, D) float32 rows of x: token ids are embedded, rows taken."""
    if x.dtype.is_floating_point:
        return x
    return embed_tokens(params, cfg, x, comm)


def is_packed4(cfg: ModelConfig, cache: KVCache) -> bool:
    """An int4 cache is int8 storage of half the row width."""
    return 2 * cache.k.shape[-1] == cfg.n_kv_heads * cfg.cache_head_dim


def _gather_qkv(q, k, v, comm):
    """The sequence-parallel prefill's row tiles of q, k and v gathered
    over cp in one collective (shard order is row order)."""
    t = q.shape[0]
    packed = torch.cat([q.reshape(t, -1), k.reshape(t, -1),
                        v.reshape(t, -1)], dim=1)
    full = comm.gather_rows(packed, "cp")
    nq, nk = q[0].numel(), k[0].numel()
    n = full.shape[0]
    return (full[:, :nq].reshape(n, *q.shape[1:]),
            full[:, nq:nq + nk].reshape(n, *k.shape[1:]),
            full[:, nq + nk:].reshape(n, *v.shape[1:]))


def cp_partials(cfg: ModelConfig, q: torch.Tensor, cache: KVCache,
                layer: int, pos: torch.Tensor, seq_base: int):
    """One sequence shard's online-softmax pieces (acc, m, l) of q (B, T,
    H, hd) over the shard's rows of `layer` in a per-slot cache (B, L,
    S_loc, row), pos (B,) int32 global positions: kernel B1 for a decode
    call (G*T <= 64, a float or int8 cache), plain torch ops for a
    prefill chunk and for an int4 cache."""
    b, t_q, n_heads, hd = q.shape
    packed4 = is_packed4(cfg, cache)
    if not packed4 and decode_split(n_heads, cfg.n_kv_heads, t_q):
        return flash_attention_batched(
            q, cache.k, cache.v, layer, pos, k_scale=cache.k_scale,
            v_scale=cache.v_scale, seq_base=seq_base, return_lse=True,
            **_attn_kw(cfg))
    s_loc, kh = cache.k.shape[2], cfg.n_kv_heads
    k, v = cache.k[:, layer], cache.v[:, layer]
    if packed4:
        k, v = unpack_kv_q4(k, kh, hd), unpack_kv_q4(v, kh, hd)
    ks = None if cache.k_scale is None else cache.k_scale[:, layer]
    vs = None if cache.v_scale is None else cache.v_scale[:, layer]
    return attention_batched_partials(
        q, k.reshape(b, s_loc, kh, hd), v.reshape(b, s_loc, kh, hd), pos,
        seq_base=seq_base, scale=cfg.attn_scale,
        softcap=cfg.attn_logit_softcap, window=cfg.sliding_window,
        k_scale=ks, v_scale=vs)


def cp_merge(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
             comm) -> torch.Tensor:
    """Merge the cp shards' partials: m_g = max m over cp, w = exp(m -
    m_g), out = sum acc w / sum l w, the two sums packed into one
    all-reduce.  A shard with no live key for a row (m = float32 min)
    weighs 0."""
    m_g = comm.max(m, "cp")
    w = torch.exp(m - m_g)
    n = acc.numel()
    tot = comm.sum(torch.cat([(acc * w[..., None]).reshape(-1),
                              (l * w).reshape(-1)]), "cp")
    return tot[:n].view_as(acc) / tot[n:].view_as(l)[..., None]


def cp_write(cache: KVCache, layer: int, pos: int, rows: torch.Tensor,
             scales, seq_base: int) -> None:
    """Write the rows of global positions pos..pos+T-1 that this sequence
    shard owns (its rows seq_base..seq_base+S_loc-1): row-exact, so a
    window may straddle the shard edge; rows past every shard are
    dropped."""
    t_q = rows.shape[1]
    s_loc = cache.k.shape[1]
    lo, hi = max(pos, seq_base), min(pos + t_q, seq_base + s_loc)
    if lo >= hi:
        return
    src, dst = slice(lo - pos, hi - pos), slice(lo - seq_base, hi - seq_base)
    cache.k[layer, dst] = rows[0, src]
    cache.v[layer, dst] = rows[1, src]
    if scales is not None:
        cache.k_scale[layer, :, dst] = scales[0, src].t()
        cache.v_scale[layer, :, dst] = scales[1, src].t()


def _single_view(cache: KVCache) -> KVCache:
    """A single-stream cache (L, S, row) as one slot of a per-slot cache
    (1, L, S, row), kernel I's layout."""
    un = lambda a: None if a is None else a.unsqueeze(0)  # noqa: E731
    return KVCache(un(cache.k), un(cache.v), un(cache.k_scale),
                   un(cache.v_scale))


def _layer(cfg: ModelConfig, x: torch.Tensor, lw: LayerWeights,
           cache: KVCache, layer: int, cos: torch.Tensor, sin: torch.Tensor,
           pos, at, w8a8: bool, comm=None, sp: bool = False,
           pos_dev: Optional[torch.Tensor] = None,
           pos_range: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One decoder layer over T tokens at positions pos..pos+T-1; writes
    the layer's K/V rows (and, for an int8 or int4 cache, their scales)
    into the cache at `at`: a slice of rows for a host position, the row
    indices for a device one (under cp its `_cp_write_index`).  `pos` is
    a host int, or a (1,) int32 device tensor with host bounds
    `pos_range`.  Under cp the cache
    is this rank's sequence shard, and with `sp` x holds this rank's row
    tile of the chunk (cos and sin the whole chunk's); pos_dev is pos as a
    (1,) int32 device tensor."""
    t_l = x.shape[0]
    if sp:
        r0 = comm.cp_rank * t_l
        q, k, v = _qkv(cfg, x, lw, cos[r0:r0 + t_l], sin[r0:r0 + t_l], w8a8)
        q, k, v = _gather_qkv(q, k, v, comm)
    else:
        q, k, v = _qkv(cfg, x, lw, cos, sin, w8a8)
    t_q = q.shape[0]
    # the cache stores rotated keys
    rows, scales = _quantize_kv(cfg, cache, k, v)
    if cfg.cp_degree > 1:
        base = comm.cp_rank * cache.k.shape[1]
        if isinstance(at, slice):
            cp_write(cache, layer, pos, rows, scales, base)
        else:
            _cp_write_batched(_single_view(cache), layer, at, rows, scales)
        att = cp_merge(*cp_partials(cfg, q[None], _single_view(cache), layer,
                                    pos_dev, base), comm)[0]
        if sp:
            att = att[r0:r0 + t_l]
        return _layer_post(cfg, x, lw, att, w8a8, comm)
    cache.k[layer, at] = rows[0]
    cache.v[layer, at] = rows[1]
    if scales is None:
        att = flash_attention(q, cache.k, cache.v, layer, pos,
                              pos_range=pos_range, **_attn_kw(cfg))
    else:
        cache.k_scale[layer, :, at] = scales[0].t()
        cache.v_scale[layer, :, at] = scales[1].t()
        flash = flash_attention_i4 if is_packed4(cfg, cache) \
            else flash_attention_i8
        att = flash(q, cache.k, cache.v, cache.k_scale, cache.v_scale,
                    layer, pos, pos_range=pos_range, **_attn_kw(cfg))
    return _layer_post(cfg, x, lw, att, w8a8, comm)


def _qkv(cfg: ModelConfig, x: torch.Tensor, lw: LayerWeights,
         cos: torch.Tensor, sin: torch.Tensor, w8a8: bool):
    """q (T, H, hd), k and v (T, KH, hd) of T rows with RoPE applied to q
    and k, all zero-padded to cache_head_dim (Phi): zero q/k lanes add
    nothing to scores, zero v lanes are sliced off the output."""
    t_q = x.shape[0]
    xb = rmsnorm(x, lw.att_norm, cfg.rms_norm_eps, cfg.norm_unit_offset)
    qkv = qmatmul(xb, lw.wqkv, w8a8=w8a8)
    a, kv = cfg.att_dim, cfg.kv_dim
    q = qkv[:, :a].reshape(t_q, cfg.n_heads, cfg.head_dim)
    k = qkv[:, a:a + kv].reshape(t_q, cfg.n_kv_heads, cfg.head_dim)
    v = qkv[:, a + kv:].reshape(t_q, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    hd_pad = cfg.cache_head_dim - cfg.head_dim
    if hd_pad:
        pad = lambda a: torch.nn.functional.pad(a, (0, hd_pad))  # noqa: E731
        q, k, v = pad(q), pad(k), pad(v)
    return q, k, v


def _quantize_kv(cfg: ModelConfig, cache: KVCache, k: torch.Tensor,
                 v: torch.Tensor):
    """K and V rows as the cache stores them: ((2, T, row) rows of the
    cache's type, (2, T, KH) f32 scales or None).  An int4 cache is int8
    storage of half the row width."""
    t_q = k.shape[0]
    if cache.k.dtype != torch.int8:
        rows = torch.stack([k, v]).reshape(2, t_q, -1).to(cache.k.dtype)
        return rows, None
    quantize = quantize_kv_rows_q4 if is_packed4(cfg, cache) \
        else quantize_kv_rows
    # K and V quantize in one pass
    return quantize(torch.stack([k, v]))


def _layer_post(cfg: ModelConfig, x: torch.Tensor, lw: LayerWeights,
                att: torch.Tensor, w8a8: bool, comm=None) -> torch.Tensor:
    """The layer after attention, shared by one sequence and a batch:
    output projection, residual, norms and the GLU FFN over all rows (one
    fused kernel when `cfg.fuse_ffn` is on, the weights are quantized and
    there are at most 16 rows).  Under tp wo and the down product are
    row-parallel: their outputs are summed over tp."""
    t_q = x.shape[0]
    gemma = cfg.model_type == ModelType.GEMMA
    tp = cfg.tp_axis is not None
    if cfg.cache_head_dim != cfg.head_dim:
        att = att[..., :cfg.head_dim]
    o = qmatmul(att.reshape(t_q, cfg.att_dim), lw.wo, w8a8=w8a8)
    if tp:
        o = comm.sum(o, "tp")

    if gemma:
        # post-attention norm before the residual add, then pre-FFN norm
        x = x + rmsnorm(o, lw.post_att_norm, cfg.rms_norm_eps, True)
        xb2 = rmsnorm(x, lw.pre_ffn_norm, cfg.rms_norm_eps, True)
    else:
        x = x + o
        xb2 = rmsnorm(x, lw.post_att_norm, cfg.rms_norm_eps, False)

    if (cfg.fuse_ffn and lw.w13.qtype != QuantType.NONE
            and t_q <= FUSED_MAX_T):
        # the whole FFN in one launch: K at T <= 8, L at 9..16 rows (the
        # JAX package's stacked and unstacked fused kernels); float weights
        # and longer chunks take the matmuls below
        fused = ffn_fused_xe if t_q <= FUSED_XE_MAX_T else ffn_fused
        ff = fused(xb2, lw.w13.q, lw.w13.s, lw.w2.q, lw.w2.s,
                   lw.w13.group_size, "gelu" if gemma else "silu")
    else:
        gu = qmatmul(xb2, lw.w13, w8a8=w8a8)
        gate, up = gu[:, :cfg.hidden_dim], gu[:, cfg.hidden_dim:]
        ff = qmatmul((gelu_tanh(gate) if gemma else silu(gate)) * up, lw.w2,
                     w8a8=w8a8)
    if tp:
        ff = comm.sum(ff, "tp")
    if gemma:
        return x + rmsnorm(ff, lw.post_ffn_norm, cfg.rms_norm_eps, True)
    return x + ff


def forward(params: TransformerParams, cfg: ModelConfig, cache: KVCache,
            x: torch.Tensor, pos: Union[int, torch.Tensor],
            logit_idx: Union[int, str, None] = None,
            w8a8: bool = True, comm=None,
            pos_range: Optional[Tuple[int, int]] = None,
            every_rank: bool = False) -> Optional[torch.Tensor]:
    """Run all layers over x, (T, D) float32 rows or (T,) token ids, at
    positions pos..pos+T-1, writing their K/V rows into `cache` in place.
    Returns the (V,) float32 logits of row `logit_idx`, the (T, V) logits
    of every row for `logit_idx="all"` (a speculative verify window), or
    None (None on a rank of cp index > 0 unless `every_rank`: the mesh's
    decode chunks sample on every rank).  `w8a8` picks the numerics of
    Q8_0 layer weights at T <= 8 (`ops.matmul.qmatmul`); the classifier
    never quantizes its activations.  Under a local config `comm` is the
    rank's communicator (module note).

    `pos` is a host int, or a (1,) int32 tensor on the device with host
    bounds `pos_range` = (lo, hi) on its value, the counterpart of the
    JAX forward's static attn_len: the RoPE rows are gathered by index,
    the K/V rows and scales written by index, and the decode calls of C,
    G and H take the position from the device with their split axis
    sized from the bounds, so nothing reads the position on the host; the
    result is the host-position call's bit for bit.  A device position
    serves decode steps and verify windows (one query block per kv head);
    prefill chunks keep the host int."""
    if x.ndim != (2 if x.dtype.is_floating_point else 1):
        raise ValueError(f"forward takes the (T, D) rows or (T,) token ids "
                         f"of one sequence, got {tuple(x.shape)}; "
                         f"forward_batched serves a batch")
    t_q = x.shape[0]
    cp = cfg.cp_degree
    lo, hi = position_bounds(pos, pos_range)
    if lo < 0 or hi + t_q > cp * cache.k.shape[1]:
        raise ValueError(f"context overflow: rows [{lo}, {hi + t_q}) past "
                         f"the cache's {cp * cache.k.shape[1]}")
    x = _rows(params, cfg, x, comm)
    if isinstance(pos, torch.Tensor):
        pos_dev = pos
        rows = pos.long() + torch.arange(t_q, device=pos.device)
        cos, sin = params.rope_cos[rows], params.rope_sin[rows]
        at = rows if cp == 1 else _cp_write_index(
            _single_view(cache), pos, t_q, comm.cp_rank * cache.k.shape[1])
    else:
        pos_dev = None if cp == 1 else torch.tensor([pos], dtype=torch.int32,
                                                    device=x.device)
        cos = params.rope_cos[pos:pos + t_q]
        sin = params.rope_sin[pos:pos + t_q]
        at = slice(pos, pos + t_q)
    sp = cp > 1 and t_q > 1 and t_q % cp == 0
    if sp:
        t_l = t_q // cp
        x = x[comm.cp_rank * t_l:(comm.cp_rank + 1) * t_l]
    for layer, lw in enumerate(params.layers):
        x = _layer(cfg, x, lw, cache, layer, cos, sin, pos, at, w8a8, comm,
                   sp, pos_dev, pos_range)
    if logit_idx is None:
        return None
    if sp:
        x = comm.gather_rows(x, "cp")
    if comm is not None and comm.cp_rank and not every_rank:
        return None

    every = isinstance(logit_idx, str)
    if every and logit_idx != "all":
        raise ValueError(f"logit_idx is a row or 'all', got {logit_idx!r}")
    logits = _classify(params, cfg,
                       x if every else x[logit_idx:logit_idx + 1], comm)
    return logits if every else logits[0]


def _classify(params: TransformerParams, cfg: ModelConfig,
              x: torch.Tensor, comm=None) -> torch.Tensor:
    """Final norm, classifier and final softcap of (N, D) rows -> (N, V)
    float32 logits.  The classifier never quantizes its activations.
    Under tp it is this rank's block of vocabulary rows, and the blocks are
    gathered before the softcap, which sees global indices."""
    xl = rmsnorm(x, params.final_norm, cfg.rms_norm_eps, cfg.norm_unit_offset)
    cls = params.embed if cfg.tied_lm_head else params.lm_head
    logits = qmatmul(xl, cls, classifier=True)
    if cfg.tp_axis is not None:
        logits = comm.gather_last(logits, "tp")
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        if cfg.parity_gemma_softcap_bug:
            # lm.rs softcaps only logits[0:dim]
            head = torch.tanh(logits[:, :cfg.dim] / cap) * cap
            logits = torch.cat([head, logits[:, cfg.dim:]], dim=-1)
        else:
            logits = torch.tanh(logits / cap) * cap
    return logits


def _cp_write_batched(cache: KVCache, layer: int, dest, rows: torch.Tensor,
                      scales) -> None:
    """The per-slot form of `cp_write` with the positions on the device: a
    read-modify-write of each slot's t_q-row window anchored inside the
    shard, at `dest` = (slots, local rows, source row, owned) from
    `_cp_write_index`; a window row the shard does not own keeps the row
    it had."""
    slots, dst, src, own = dest
    for plane, new in ((cache.k, rows[0]), (cache.v, rows[1])):
        plane[slots, layer, dst] = torch.where(
            own[:, None], new[src], plane[slots, layer, dst])
    if scales is not None:
        for plane, new in ((cache.k_scale, scales[0]),
                           (cache.v_scale, scales[1])):
            plane[slots, layer, :, dst] = torch.where(
                own[:, None], new[src], plane[slots, layer, :, dst])


def _cp_write_index(cache: KVCache, pos: torch.Tensor, t_q: int,
                    seq_base: int):
    """Where a cp shard's per-slot writes land (the JAX `_upd_cp` algebra):
    slot b's window is anchored at local row idx = clamp(pos - base, 0,
    S_loc - t_q); local row idx + m takes the chunk's row idx + m - (pos -
    base), where that lies in 0..t_q-1.  Needs t_q <= S_loc."""
    b = pos.shape[0]
    dev = pos.device
    s_loc = cache.k.shape[2]
    if t_q > s_loc:
        raise ValueError(f"cp write window T={t_q} exceeds the shard's "
                         f"{s_loc} rows")
    lp = pos.long() - seq_base
    idx = lp.clamp(0, s_loc - t_q)
    dst = idx[:, None] + torch.arange(t_q, device=dev)[None]      # (B, t)
    j = dst - lp[:, None]
    own = (j >= 0) & (j < t_q)
    slots = torch.arange(b, device=dev)[:, None].expand(b, t_q)
    src = slots * t_q + j.clamp(0, t_q - 1)
    return (slots.reshape(-1), dst.reshape(-1), src.reshape(-1),
            own.reshape(-1))


def _layer_batched(cfg: ModelConfig, x: torch.Tensor, lw: LayerWeights,
                   cache: KVCache, layer: int, cos: torch.Tensor,
                   sin: torch.Tensor, pos: torch.Tensor, t_q: int,
                   dest, table: Optional[torch.Tensor],
                   w8a8: bool, comm=None, staged: bool = False
                   ) -> torch.Tensor:
    """One decoder layer over B slots of t_q rows each, x (B*t_q, D) slot
    by slot.  Writes each slot's K/V rows (and scales) with one indexed
    write per plane, at `dest`: (slot, row) index tensors of the per-slot
    cache, or (page, row in page) ones of the pool when `table` is given;
    then attention runs kernel I or J.  The matmuls and the rest of the
    layer run on all rows at once.  Under cp (a per-slot cache only) the
    writes are `_cp_write_batched`'s and attention is `cp_partials`
    merged over cp.  `staged`: mark the stages for a recording profiler
    (`tracing.stage`)."""
    n = x.shape[0]
    with stage("fwd.qkv", staged):
        q, k, v = _qkv(cfg, x, lw, cos, sin, w8a8)
    with stage("fwd.kv_write", staged):
        rows, scales = _quantize_kv(cfg, cache, k, v)
        if cfg.cp_degree > 1:
            _cp_write_batched(cache, layer, dest, rows, scales)
        elif table is None:
            i0, i1 = dest
            cache.k[i0, layer, i1] = rows[0]
            cache.v[i0, layer, i1] = rows[1]
            if scales is not None:
                cache.k_scale[i0, layer, :, i1] = scales[0]
                cache.v_scale[i0, layer, :, i1] = scales[1]
        else:
            i0, i1 = dest
            cache.k[layer, i0, i1] = rows[0]
            cache.v[layer, i0, i1] = rows[1]
            if scales is not None:
                cache.k_scale[layer, i0, :, i1] = scales[0]
                cache.v_scale[layer, i0, :, i1] = scales[1]
    with stage("fwd.attn", staged):
        qb = q.reshape(n // t_q, t_q, cfg.n_heads, cfg.cache_head_dim)
        if cfg.cp_degree > 1:
            att = cp_merge(*cp_partials(cfg, qb, cache, layer, pos,
                                        comm.cp_rank * cache.k.shape[2]),
                           comm)
        else:
            kw = dict(_attn_kw(cfg), k_scale=cache.k_scale,
                      v_scale=cache.v_scale)
            if table is None:
                att = flash_attention_batched(qb, cache.k, cache.v, layer,
                                              pos, **kw)
            else:
                att = flash_attention_paged(qb, cache.k, cache.v, table,
                                            layer, pos, **kw)
    with stage("fwd.post", staged):
        return _layer_post(cfg, x, lw, att.reshape(n, cfg.n_heads, -1),
                           w8a8, comm)


def _write_index(cache: KVCache, pos: torch.Tensor, t_q: int,
                 table: Optional[torch.Tensor] = None):
    """Where the t_q rows of each slot land: (slot, row) index tensors of
    the per-slot cache, or (page, row in page) ones of the pool through
    `table`, each (B*t_q,), built on the device from `pos` (B,).  Indices
    are clamped into the cache so that a lane can never write outside it;
    the scheduler's slack rows keep every live write inside."""
    b = pos.shape[0]
    dev = pos.device
    rows = (pos.long()[:, None]
            + torch.arange(t_q, device=dev)[None]).reshape(-1)
    if table is None:
        slots = torch.arange(b, device=dev).repeat_interleave(t_q)
        return slots, rows.clamp(max=cache.k.shape[2] - 1)
    psz = cache.k.shape[2]
    vp = (rows // psz).clamp(max=table.shape[1] - 1).reshape(b, t_q)
    pages = table.long().gather(1, vp).reshape(-1)
    return pages, rows % psz


def forward_batched(params: TransformerParams, cfg: ModelConfig,
                    cache: KVCache, x: torch.Tensor, pos: torch.Tensor,
                    t_q: int = 1, table: Optional[torch.Tensor] = None,
                    logit_idx: Optional[int] = None,
                    w8a8: bool = True,
                    want_logits: bool = True,
                    comm=None) -> Optional[torch.Tensor]:
    """One step of B independent sequences: x (B*t_q, D) float32 (or
    (B*t_q,) token ids) holds t_q
    rows per slot, slot by slot, at positions pos[b]..pos[b]+t_q-1 (pos a
    (B,) int32 tensor on the device, never read on the host).  The cache is
    per-slot ((B, L, S, row), `init_batched_kv_cache`) or, with `table` (a
    (B, maxp) int32 page table), a page pool (`init_kv_pool`).  Rows are
    written in place.  Returns the (B*t_q, V) float32 logits, or those of
    row `logit_idx` alone ((1, V): a prefill chunk needs one), or None
    without `want_logits` (an image's rows: no classifier runs).

    All matmuls run on the B*t_q rows at once, so the weights stream once
    per step whatever B is; only the cache writes and attention are per
    slot.  Under a local config `comm` is the rank's communicator; a cp
    shard's cache is its block of every slot's rows (no page pool)."""
    b = pos.shape[0]
    if x.ndim != (2 if x.dtype.is_floating_point else 1) \
            or x.shape[0] != b * t_q:
        raise ValueError(f"forward_batched takes ({b} * {t_q}, D) rows, "
                         f"got {tuple(x.shape)}")
    if table is None and cache.k.dim() == 4 and cache.k.shape[0] != b:
        raise ValueError(f"a per-slot cache of {cache.k.shape[0]} slots for "
                         f"{b} positions")
    if cfg.cp_degree > 1 and table is not None:
        raise ValueError("a page pool does not shard over cp")
    staged = profiling()
    with stage("fwd.embed", staged):
        rows = (pos.long()[:, None] + torch.arange(t_q, device=pos.device))
        # rope rows of dead lanes past the table's end are never read
        rows = rows.reshape(-1).clamp(max=params.rope_cos.shape[0] - 1)
        cos, sin = params.rope_cos[rows], params.rope_sin[rows]
        if cfg.cp_degree > 1:
            dest = _cp_write_index(cache, pos, t_q,
                                   comm.cp_rank * cache.k.shape[2])
        else:
            dest = _write_index(cache, pos, t_q, table)
        x = _rows(params, cfg, x, comm)
    for layer, lw in enumerate(params.layers):
        x = _layer_batched(cfg, x, lw, cache, layer, cos, sin, pos, t_q,
                           dest, table, w8a8, comm, staged)
    if not want_logits or (comm is not None and comm.cp_rank):
        return None
    with stage("fwd.head", staged):
        if logit_idx is not None:
            x = x[logit_idx:logit_idx + 1]
        return _classify(params, cfg, x, comm)


class DecodeGraph:
    """`forward_batched`'s decode step on one CUDA device (t_q = 1, the
    (B,) token ids, every lane's logits), captured once as a CUDA graph
    and replayed: one graph launch a step in place of the layers' eager
    dispatch, whose host time the device otherwise waits on.

    The first call runs the step eagerly (the kernels' one-time host
    set-up happens there) and returns its logits, then captures the same
    step on a side stream.  Every later call copies the tokens and
    positions into static (B,) buffers and replays, so the graph runs the
    very kernels of the eager step on the same inputs, with the same split
    counts (J's grid is sized from the table's static range): its logits
    equal the eager step's bit for bit.  The weights, the cache, the page
    table and the RoPE tables are read in place, so the host-encoded TMA
    descriptors stay valid: a call on another cache, table or batch
    raises.

    A replay returns the graph's static (B, V) logits buffer, which the
    next replay overwrites: read it, in stream order, before the next
    call.  Captures are taken one at a time in the process (schedulers on
    other threads, dp replicas, may capture too), each on a side stream
    of the step's device.  `kernels` is the graph's kernel nodes by
    function (`kernels.cuda.graph_kernels`), and `launches` the wrappers'
    launches among them (`kernels.graph_launches`), which each replay
    adds to the kernels' counts (`kernels.launches()`); the capture's
    wrapper calls, which launch nothing, are taken back.  `captures` and
    `replays` count what the graph did."""

    _capturing = threading.Lock()

    def __init__(self, params: TransformerParams, cfg: ModelConfig,
                 w8a8: bool = True):
        self.params, self.cfg, self.w8a8 = params, cfg, w8a8
        self.captures = 0
        self.replays = 0
        self._key = None
        self._graph = None

    def __call__(self, cache: KVCache, x: torch.Tensor, pos: torch.Tensor,
                 table: Optional[torch.Tensor] = None) -> torch.Tensor:
        key = (cache.k.data_ptr(), cache.v.data_ptr(),
               None if table is None else table.data_ptr(), x.shape[0])
        if self._graph is None:
            logits = forward_batched(self.params, self.cfg, cache, x, pos,
                                     table=table, w8a8=self.w8a8)
            self._capture(cache, x, pos, table)
            self._key = key
            return logits
        if key != self._key:
            raise RuntimeError("DecodeGraph: a step on another cache, page "
                               "table or batch than the captured one")
        self._x.copy_(x)
        self._pos.copy_(pos)
        self._graph.replay()
        add_launches(self.launches)
        self.replays += 1
        return self._logits

    def _capture(self, cache: KVCache, x: torch.Tensor, pos: torch.Tensor,
                 table: Optional[torch.Tensor]) -> None:
        self._x, self._pos = x.clone(), pos.clone()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with DecodeGraph._capturing:
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(x.device),
                                  capture_error_mode="thread_local"):
                self._logits = forward_batched(self.params, self.cfg, cache,
                                               self._x, self._pos,
                                               table=table, w8a8=self.w8a8)
        graph.instantiate()
        self.kernels = graph_kernels(graph)
        self.launches = graph_launches(
            self.kernels, "flash_attention_batched" if table is None
            else "flash_attention_paged")
        add_launches(self.launches, -1)
        self._graph = graph
        self.captures += 1
