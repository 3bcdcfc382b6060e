"""Kernel J: flash attention for a batch of sequences over a shared page
pool (the paged KV cache of continuous batching).  CUDA source:
`lmrs_tpu_torch/csrc/flash_attention.cu` (kernel C's template with a slot
axis in the grid and a page table), whose header note names the TPU kernel
it replaces and its design.

The pool is (L, P, psz, KH*hd) bf16, f32 or int8, or nibble-packed int4
bytes (L, P, psz, KH*hd/2); an int8 or int4 pool has (L, P, KH, psz) f32
scales.  A (B, maxp) int32 page table maps slot b's virtual row r to row
r % psz of page table[b, r // psz]; page 0 is the trash page, which entries
past a slot's pages and window-freed pages point at.  Slot b attends to its
virtual rows [window start, pos[b] + T - 1], as kernel C (G, H) does for
one sequence: a pool whose pages hold a per-slot cache's rows gives kernel
I's result bit for bit.  Positions and the table are device tensors that
the wrapper never reads on the host.  A decode call is flash-decoding, as
for kernel I (the split pass over each slot's virtual rows, then kernel
M: `kernels.flash_merge`).  The wrapper launches the kernel for CUDA
tensors (or raises) and runs the plain version for CPU tensors;
`flash_attention_paged.launches` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from lmrs_tpu_torch.kernels import cuda
from lmrs_tpu_torch.kernels.flash_attention_batched import (cache_type,
                                                            check_batched,
                                                            entry)
from lmrs_tpu_torch.kernels.flash_merge import (decode_split,
                                                n_splits_device, split_pass)
from lmrs_tpu_torch.ops.attention import attention_batched_multi
from lmrs_tpu_torch.quant import q4_cache_pair_mode, unpack_kv_q4


def gather_pages(k_pool: torch.Tensor, v_pool: torch.Tensor,
                 table: torch.Tensor, layer: int, n_kv: int, hd: int,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None):
    """Each slot's virtual rows of `layer` as a per-slot cache: ((B, maxp *
    psz, KH, hd) K and V, integer values of an int8 or int4 pool, and (B,
    KH, maxp * psz) scales or None)."""
    b, maxp = table.shape
    psz, row = k_pool.shape[2], k_pool.shape[3]
    idx = table.long()

    def rows(pool):
        r = pool[layer][idx].reshape(b, maxp * psz, row)
        if row * 2 == n_kv * hd:                 # int4: nibble bytes
            return unpack_kv_q4(r, n_kv, hd)
        return r.reshape(b, maxp * psz, n_kv, hd)

    def planes(s):
        if s is None:
            return None
        return s[layer][idx].permute(0, 2, 1, 3).reshape(b, n_kv, maxp * psz)

    return rows(k_pool), rows(v_pool), planes(k_scale), planes(v_scale)


def flash_attention_paged_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor, table: torch.Tensor,
                                layer: int, pos: torch.Tensor, *, n_kv: int,
                                scale: float,
                                softcap: Optional[float] = None,
                                window: Optional[int] = None,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Plain PyTorch version: gather each slot's pages through the table,
    then the per-slot masked einsum attention, scales folded as the kernel
    folds them."""
    if q.is_cuda:
        cuda.plain_numerics()
    k, v, ks, vs = gather_pages(k_pool, v_pool, table, layer, n_kv,
                                q.shape[-1], k_scale, v_scale)
    return attention_batched_multi(q, k, v, pos, scale=scale, softcap=softcap,
                                   window=window, precision="fast",
                                   k_scale=ks, v_scale=vs)


def flash_attention_paged_tol(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, table: torch.Tensor,
                              layer: int, pos: torch.Tensor, *, n_kv: int,
                              scale: float, softcap: Optional[float] = None,
                              window: Optional[int] = None,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Per-element bound on |kernel - plain version|, (B, T, H, hd) f32:
    (2^-7 + 2^-9) times the plain version run on |v| (on the unpacked
    integer values of an int8 or int4 pool), as
    `flash_attention_batched.flash_attention_batched_tol`."""
    if q.is_cuda:
        cuda.plain_numerics()
    k, v, ks, vs = gather_pages(k_pool, v_pool, table, layer, n_kv,
                                q.shape[-1], k_scale, v_scale)
    v = v.float().clamp(min=-127).abs()
    a = attention_batched_multi(q, k, v, pos, scale=scale, softcap=softcap,
                                window=window, precision="fast",
                                k_scale=ks, v_scale=vs)
    return (2.0 ** -7 + 2.0 ** -9) * a


def flash_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, table: torch.Tensor,
                          layer: int, pos: torch.Tensor, *, n_kv: int,
                          scale: float, softcap: Optional[float] = None,
                          window: Optional[int] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """q (B, T, H, hd) float32 with RoPE applied; k_pool/v_pool (L, P, psz,
    KH*hd) bf16, f32 or int8, or (L, P, psz, KH*hd/2) int4 bytes, with
    k_scale/v_scale (L, P, KH, psz) f32 for the integer pools; table (B,
    maxp) int32; pos (B,) int32 -> (B, T, H, hd) f32.  T <= psz."""
    if not q.is_cuda:
        return flash_attention_paged_plain(
            q, k_pool, v_pool, table, layer, pos, n_kv=n_kv, scale=scale,
            softcap=softcap, window=window, k_scale=k_scale, v_scale=v_scale)
    b, t_q, n_heads, hd = q.shape
    if k_pool.dim() != 4:
        raise ValueError(f"flash_attention_paged needs an (L, P, psz, row) "
                         f"pool, got {tuple(k_pool.shape)}")
    n_layers, n_pages, psz, row = k_pool.shape
    packed4 = k_pool.dtype == torch.int8 and row * 2 == n_kv * hd
    check_batched("flash_attention_paged", q, pos, n_kv, row,
                  2 if packed4 else 1, (k_pool, v_pool), (k_scale, v_scale))
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside the pool's {n_layers}")
    if psz % 8 or t_q > psz:
        raise ValueError(f"pages of {psz} rows: need a multiple of 8 that "
                         f"holds the {t_q}-query window")
    if table.dim() != 2 or table.shape[0] != b or table.dtype != torch.int32 \
            or not table.is_contiguous() or table.device != q.device:
        raise ValueError(f"flash_attention_paged needs a contiguous ({b}, "
                         f"maxp) int32 page table on {q.device}")
    if k_scale is not None and \
            k_scale.shape != (n_layers, n_pages, n_kv, psz):
        raise ValueError(f"scales of shape {tuple(k_scale.shape)}, need "
                         f"{(n_layers, n_pages, n_kv, psz)}")
    maxp = table.shape[1]
    qf = q.float().contiguous()
    if qf.data_ptr() % 16:
        raise ValueError("flash_attention_paged needs a 16-byte aligned q")
    quant = k_scale is not None
    ctype = cache_type(k_pool.dtype, packed4, q4_cache_pair_mode(n_kv, hd))
    split = decode_split(n_heads, n_kv, t_q)
    if split:
        # the split pass over each slot's virtual rows, then kernel M
        out = split_pass(
            qf, k_pool[layer], v_pool[layer],
            k_scale[layer] if quant else None,
            v_scale[layer] if quant else None, n_kv=n_kv,
            s_len=maxp * psz, row=row, pos=pos, seq_base=0, slot_stride=0,
            scale_slot_stride=0, table=table, maxp=maxp, psz=psz,
            split=split,
            n_split=n_splits_device(maxp * psz, t_q, window, split),
            scale=scale, softcap=softcap, window=window, ctype=ctype,
            what="flash_attention_paged", out=torch.empty_like(qf))
        flash_attention_paged.launches += 1
        return out
    out = torch.empty_like(qf)
    err = entry()(
        qf.data_ptr(), k_pool[layer].data_ptr(), v_pool[layer].data_ptr(),
        k_scale[layer].data_ptr() if quant else None,
        v_scale[layer].data_ptr() if quant else None,
        out.data_ptr(), b, t_q, n_heads, n_kv, hd, maxp * psz, row,
        pos.data_ptr(), 0, 0, table.data_ptr(), maxp, psz, scale,
        0.0 if softcap is None else float(softcap),
        -1 if window is None else int(window), ctype,
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda.check(err, "flash_attention_paged")
    flash_attention_paged.launches += 1
    return out


flash_attention_paged.launches = 0
