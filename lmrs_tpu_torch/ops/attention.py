"""GQA attention over a KV-cache prefix — the plain version of the flash
attention kernel (`lmrs_tpu_torch.kernels.flash_attention`) — and its
per-slot form for a batch of sequences at their own positions, the plain
version of kernels I and J (`kernels.flash_attention_batched`,
`kernels.flash_attention_paged`).

One batched product over all heads against the cache rows, with the causal
structure and Gemma's sliding window expressed as masks, and lm.rs's exact
-2.3819763e38 window constant.
"""

from __future__ import annotations

from typing import Optional

import torch

_WINDOW_NEG = -2.3819763e38
_MASK_NEG = torch.finfo(torch.float32).min


def attention(
    q: torch.Tensor,         # (T, H, head_dim) float32, RoPE already applied
    k_cache: torch.Tensor,   # (S, KH, head_dim) rotated keys
    v_cache: torch.Tensor,   # (S, KH, head_dim)
    pos: int,                # absolute position of query token 0
    *,
    scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    precision: str = "highest",
    k_scale: Optional[torch.Tensor] = None,   # (KH, S) f32: int8 caches
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Causal grouped-query attention; returns (T, H, head_dim) float32.

    Queries at positions pos..pos+T-1 attend to cache rows t <= their
    position; Gemma's sliding window adds _WINDOW_NEG where q_pos - t >
    window.

    precision="highest": float32 operands.  precision="fast": q, K, V and
    the softmax weights are rounded to bf16 before each product, and the
    products accumulate in float32 — the serving numerics, which the kernel
    computes.  Both run as float32 matmuls, so TF32 must be off on the card
    (it is, by PyTorch's default; `lmrs_tpu_torch.kernels.cuda.
    plain_numerics` pins it).

    With k_scale / v_scale the caches hold the int8 values of a quantized
    KV cache (k = k_int * k_scale per (kv head, row)), and the scales are
    folded in as the int8 kernel folds them: the key scale multiplies the
    score column after `scale`, the value scale multiplies the softmax
    weight before its rounding, and the products run on the integer values
    (exact in bf16).  No dequantized K or V is formed.
    """
    t_q, n_heads, head_dim = q.shape
    s_len, n_kv, _ = k_cache.shape
    kv_group = n_heads // n_kv
    if precision == "fast":
        rnd = lambda a: a.to(torch.bfloat16).float()  # noqa: E731
    else:
        rnd = lambda a: a.float()  # noqa: E731

    qg = rnd(q).reshape(t_q, n_kv, kv_group, head_dim)
    k_in = rnd(k_cache)
    v_in = rnd(v_cache)

    scores = torch.einsum("tkgd,skd->tkgs", qg, k_in) * scale    # (T,KH,G,S)
    if k_scale is not None:
        scores = scores * k_scale[None, :, None, :]
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap

    dev = q.device
    t_idx = torch.arange(s_len, device=dev)[None, :]              # (1, S)
    q_pos = pos + torch.arange(t_q, device=dev)[:, None]          # (T, 1)
    if window is not None:
        win = torch.where(q_pos - t_idx <= window, 0.0, _WINDOW_NEG)
        scores = scores + win[:, None, None, :]
    causal = t_idx <= q_pos
    scores = torch.where(causal[:, None, None, :], scores, _MASK_NEG)

    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    att = e / e.sum(dim=-1, keepdim=True)

    if v_scale is not None:
        att = att * v_scale[None, :, None, :]
    out = torch.einsum("tkgs,skd->tkgd", rnd(att), v_in)
    return out.reshape(t_q, n_heads, head_dim).float()


def attention_batched_multi(
    q: torch.Tensor,         # (B, T, H, head_dim) float32, RoPE applied
    k_cache: torch.Tensor,   # (B, S, KH, head_dim) per-slot cache rows
    v_cache: torch.Tensor,   # (B, S, KH, head_dim)
    pos: torch.Tensor,       # (B,) integer positions of each slot's q[:, 0]
    *,
    scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    precision: str = "fast",
    k_scale: Optional[torch.Tensor] = None,   # (B, KH, S) f32: int caches
    v_scale: Optional[torch.Tensor] = None,
    seq_base: int = 0,
) -> torch.Tensor:
    """`attention` for B slots at once, each slot masked at its own
    positions q_pos = pos[b] + t; returns (B, T, H, head_dim) float32.
    `pos` is a tensor and is never read on the host.  The caches' row 0 is
    the global row `seq_base` (one sequence shard; the masks compare
    global positions).

    Rows outside a slot's live range [max(pos - window, 0), pos + T - 1]
    are zeroed (values and scales) before the products, as the kernels
    zero-fill them: their weights are 0 either way, and a stale row (a
    reused slot, the trash page of a pool) may hold anything, NaN
    included."""
    b, t_q, n_heads, head_dim = q.shape
    _, s_len, n_kv, _ = k_cache.shape
    kv_group = n_heads // n_kv
    if precision == "fast":
        rnd = lambda a: a.to(torch.bfloat16).float()  # noqa: E731
    else:
        rnd = lambda a: a.float()  # noqa: E731

    dev = q.device
    pos = pos.to(device=dev, dtype=torch.long)
    t_idx = seq_base + torch.arange(s_len, device=dev)             # (S,)
    first = (pos - window).clamp(min=0) if window is not None \
        else torch.zeros_like(pos)
    live = (t_idx[None] >= first[:, None]) & \
        (t_idx[None] <= (pos + t_q - 1)[:, None])                  # (B, S)
    k_cache = torch.where(live[..., None, None], k_cache.float(), 0.0)
    v_cache = torch.where(live[..., None, None], v_cache.float(), 0.0)

    qg = rnd(q).reshape(b, t_q, n_kv, kv_group, head_dim)
    scores = torch.einsum("btkgd,bskd->btkgs", qg, rnd(k_cache)) * scale
    if k_scale is not None:
        ks = torch.where(live[:, None], k_scale, 0.0)
        scores = scores * ks[:, None, :, None, :]
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap

    q_pos = (pos[:, None] + torch.arange(t_q, device=dev)[None])[..., None]
    t_b = t_idx[None, None]                                        # (1,1,S)
    if window is not None:
        win = torch.where(q_pos - t_b <= window, 0.0, _WINDOW_NEG)
        scores = scores + win[:, :, None, None, :]
    causal = t_b <= q_pos                                          # (B,T,S)
    scores = torch.where(causal[:, :, None, None, :], scores, _MASK_NEG)

    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    att = e / e.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        vs = torch.where(live[:, None], v_scale, 0.0)
        att = att * vs[:, None, :, None, :]
    out = torch.einsum("btkgs,bskd->btkgd", rnd(att), rnd(v_cache))
    return out.reshape(b, t_q, n_heads, head_dim).float()


def attention_batched_partials(
    q: torch.Tensor,         # (B, T, H, head_dim) float32, RoPE applied
    k_cache: torch.Tensor,   # (B, S, KH, head_dim): one sequence shard
    v_cache: torch.Tensor,
    pos: torch.Tensor,       # (B,) global positions of each slot's q[:, 0]
    *,
    seq_base: int = 0,       # the global row of the shard's row 0
    scale: float,
    softcap: Optional[float] = None,
    window: Optional[int] = None,
    precision: str = "fast",
    k_scale: Optional[torch.Tensor] = None,   # (B, KH, S) f32: int caches
    v_scale: Optional[torch.Tensor] = None,
):
    """The raw online-softmax pieces of `attention_batched_multi` over one
    sequence shard, whose partials merge across shards as
    m_g = max m; w = exp(m - m_g); out = sum acc w / sum l w.

    Returns acc (B, T, H, head_dim) = sum_j e_j v_j with e_j = exp(s_j - m)
    (times the value scale, rounded to bf16 under "fast"), m (B, T, H) the
    row's largest live score and l (B, T, H) = sum_j e_j, all float32.  A
    key outside the causal mask or the window carries no weight and takes
    no part in m, as in the kernels; a row with no live key in the shard
    gets m = _MASK_NEG and acc = l = 0, so that its merge weight is 0."""
    b, t_q, n_heads, head_dim = q.shape
    _, s_len, n_kv, _ = k_cache.shape
    kv_group = n_heads // n_kv
    if precision == "fast":
        rnd = lambda a: a.to(torch.bfloat16).float()  # noqa: E731
    else:
        rnd = lambda a: a.float()  # noqa: E731

    dev = q.device
    pos = pos.to(device=dev, dtype=torch.long)
    t_idx = seq_base + torch.arange(s_len, device=dev)             # (S,)
    q_pos = pos[:, None] + torch.arange(t_q, device=dev)[None]     # (B, T)
    key_live = t_idx[None, None] <= q_pos[..., None]               # (B,T,S)
    if window is not None:
        key_live = key_live & (q_pos[..., None] - t_idx <= window)
    # rows no query of the slot reads may hold anything (NaN included)
    row_live = key_live.any(dim=1)                                 # (B, S)
    k_cache = torch.where(row_live[..., None, None], k_cache.float(), 0.0)
    v_cache = torch.where(row_live[..., None, None], v_cache.float(), 0.0)

    qg = rnd(q).reshape(b, t_q, n_kv, kv_group, head_dim)
    scores = torch.einsum("btkgd,bskd->btkgs", qg, rnd(k_cache)) * scale
    if k_scale is not None:
        ks = torch.where(row_live[:, None], k_scale, 0.0)
        scores = scores * ks[:, None, :, None, :]
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    scores = scores.masked_fill(~key_live[:, :, None, None, :],
                                float("-inf"))
    m = scores.amax(dim=-1)
    has = m != float("-inf")
    e = torch.exp(scores - torch.where(has, m, 0.0)[..., None])
    den = e.sum(dim=-1)
    if v_scale is not None:
        vs = torch.where(row_live[:, None], v_scale, 0.0)
        e = e * vs[:, None, :, None, :]
    acc = torch.einsum("btkgs,bskd->btkgd", rnd(e), rnd(v_cache))
    m = torch.where(has, m, _MASK_NEG)
    return (acc.reshape(b, t_q, n_heads, head_dim),
            m.reshape(b, t_q, n_heads), den.reshape(b, t_q, n_heads))


def attention_batched(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: torch.Tensor,
                      **kw) -> torch.Tensor:
    """One decode token per slot: q (B, H, head_dim) -> (B, H, head_dim)
    (`attention_batched_multi` at T = 1)."""
    return attention_batched_multi(q[:, None], k_cache, v_cache, pos,
                                   **kw)[:, 0]
