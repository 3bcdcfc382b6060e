"""Kernel I: flash attention for a batch of sequences, each at its own
position, over one layer of a per-slot KV cache (the contiguous cache of
continuous batching).  CUDA source: `lmrs_tpu_torch/csrc/flash_attention.cu`
(kernel C's template with a slot axis in the grid), whose header note names
the TPU kernel it replaces and its design.

The cache is (B, L, S, KH*hd) bf16, f32 or int8 with, for int8, (B, L, KH,
S) f32 scales; slot b's rows are what kernel C (G) reads for one sequence,
so slot b of a call equals C (G) on the slot's (L, S, row) view.  The
positions are a (B,) int32 tensor on the device: the wrapper never reads
them on the host, and the kernel clamps each slot's walk to [window start,
min(pos + T, S) - 1].  A decode call is flash-decoding, as for kernel C
(the split pass, its split axis sized from S, then kernel M:
`kernels.flash_merge`).  With `seq_base` and `return_lse` it is the cp
partials form (the JAX `flash_decode_batched(..., seq_base=,
return_lse=True)`): the split pass on one sequence shard, merged without
the division.  The wrapper launches the kernel for CUDA tensors (or
raises) and runs the plain version for CPU tensors;
`flash_attention_batched.launches` counts kernel launches, and
`.lse_launches` those of them in the cp partials form (B1).  Shared with
kernel J (`kernels.flash_attention_paged`): the geometry checks, the cache
type numbers and the C entry point.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from lmrs_tpu_torch.kernels import cuda
from lmrs_tpu_torch.kernels.flash_attention import HEAD_DIMS, MAX_T
from lmrs_tpu_torch.kernels.flash_merge import (BF16, BKV, F32, I4_HALF,
                                                I4_PAIR, I8, decode_split,
                                                flash_merge, n_splits_device,
                                                split_pass)
from lmrs_tpu_torch.ops.attention import (attention_batched_multi,
                                          attention_batched_partials)


def _scales_view(k_scale, v_scale, layer):
    if k_scale is None:
        return None, None
    return k_scale[:, layer], v_scale[:, layer]


def flash_attention_batched_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                  v_cache: torch.Tensor, layer: int,
                                  pos: torch.Tensor, *, n_kv: int,
                                  scale: float,
                                  softcap: Optional[float] = None,
                                  window: Optional[int] = None,
                                  k_scale: Optional[torch.Tensor] = None,
                                  v_scale: Optional[torch.Tensor] = None,
                                  seq_base: int = 0,
                                  return_lse: bool = False):
    """Plain PyTorch version: the per-slot masked einsum attention over the
    slots' rows of the layer, scales folded as the kernel folds them; with
    `return_lse` its raw pieces
    (`ops.attention.attention_batched_partials`)."""
    if q.is_cuda:
        cuda.plain_numerics()
    b, _, _, hd = q.shape
    s_len = k_cache.shape[2]
    k = k_cache[:, layer].reshape(b, s_len, n_kv, hd)
    v = v_cache[:, layer].reshape(b, s_len, n_kv, hd)
    ks, vs = _scales_view(k_scale, v_scale, layer)
    fn = attention_batched_partials if return_lse else attention_batched_multi
    return fn(q, k, v, pos, scale=scale, softcap=softcap, window=window,
              precision="fast", k_scale=ks, v_scale=vs, seq_base=seq_base)


def flash_attention_batched_tol(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, layer: int,
                                pos: torch.Tensor, **kw) -> torch.Tensor:
    """Per-element bound on |kernel - plain version|, (B, T, H, hd) f32: as
    `flash_attention.flash_attention_tol` (and its int8 form), slot by
    slot — (2^-7 + 2^-9) times the plain version run on |v| (|v_int|, the
    quantizer never writing -128, for an int8 cache).  With `return_lse`
    the bound on the raw acc: each side rounds its unnormalized weights
    exp(s - m) to bf16 (the kernel per split, against the split's running
    max, then scaled by exp(m_s - m_g) in f32), so the same argument holds
    term by term with the plain raw acc on |v| in the place of the
    output."""
    v_abs = v_cache.clamp(min=-127).abs() if v_cache.dtype == torch.int8 \
        else v_cache.abs()
    a = flash_attention_batched_plain(q, k_cache, v_abs, layer, pos, **kw)
    if kw.get("return_lse"):
        a = a[0]
    return (2.0 ** -7 + 2.0 ** -9) * a


def check_batched(name: str, q: torch.Tensor, pos: torch.Tensor, n_kv: int,
                  row: int, per_byte: int, caches, scales) -> None:
    """Raise unless q (B, T, H, hd), pos (B,) int32 and the caches and
    scales are what kernels I and J take (caches and scales: (tensor,
    tensor) pairs of one shape, the scales None for a float cache)."""
    b, t_q, n_heads, hd = q.shape
    if not 1 <= t_q <= MAX_T:
        raise ValueError(f"{name} takes 1..{MAX_T} queries, got {t_q}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} is built for head dims {HEAD_DIMS}, "
                         f"got {hd}")
    if n_heads % n_kv or row * per_byte != n_kv * hd:
        raise ValueError(f"{n_heads} heads, {n_kv} kv heads, cache rows of "
                         f"{row} do not fit head_dim {hd}")
    if pos.shape != (b,) or pos.dtype != torch.int32 \
            or pos.device != q.device:
        raise ValueError(f"{name} needs (B,) = ({b},) int32 positions on "
                         f"{q.device}")
    k, v = caches
    if v.shape != k.shape or v.dtype != k.dtype:
        raise TypeError(f"{name}: K and V caches differ")
    for a in (*caches, *(s for s in scales if s is not None)):
        if not a.is_contiguous() or a.data_ptr() % 16 \
                or a.device != q.device:
            raise ValueError(f"{name} needs contiguous 16-byte aligned "
                             f"tensors on {q.device}")
    if (scales[0] is None) != (k.dtype not in (torch.int8,)):
        raise TypeError(f"{name}: an int8 cache takes scales, a float "
                        f"cache none")
    if scales[0] is not None and (scales[0].dtype != torch.float32
                                  or scales[1].shape != scales[0].shape):
        raise TypeError(f"{name} needs f32 scales of one shape")


def cache_type(dtype: torch.dtype, packed4: bool, pair: bool) -> int:
    if dtype == torch.bfloat16:
        return BF16
    if dtype == torch.float32:
        return F32
    if dtype == torch.int8:
        return (I4_PAIR if pair else I4_HALF) if packed4 else I8
    raise TypeError(f"no flash kernel for a {dtype} cache")


def entry():
    fn = cuda.library("flash_attention").lmrs_flash_attention_batched
    if fn.argtypes is None:
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p, ll, ll, p,
                       i, i, f, f, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_batched(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, layer: int,
                            pos: torch.Tensor, *, n_kv: int, scale: float,
                            softcap: Optional[float] = None,
                            window: Optional[int] = None,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            seq_base: int = 0, return_lse: bool = False):
    """q (B, T, H, hd) float32 with RoPE applied; k_cache/v_cache (B, L, S,
    KH*hd) bf16, f32 or int8 (with k_scale/v_scale (B, L, KH, S) f32)
    holding rows [0, pos[b] + T) of `layer` for each slot b; pos (B,)
    int32 -> (B, T, H, hd) f32.

    The cp partials form (the JAX `flash_decode_batched(..., seq_base=,
    return_lse=True)`): with `seq_base` the cache is one sequence shard
    whose row 0 is the global row seq_base, and the masks compare global
    positions; with `return_lse` the result is the raw online-softmax
    pieces (acc (B, T, H, hd), m (B, T, H), l (B, T, H)) f32 of the shard's
    rows, which shards merge as m_g = max m; w = exp(m - m_g); out =
    sum acc w / sum l w.  A row with no live key in the shard gets
    m = _MASK_NEG (float32 min) and acc = l = 0."""
    if not q.is_cuda:
        return flash_attention_batched_plain(
            q, k_cache, v_cache, layer, pos, n_kv=n_kv, scale=scale,
            softcap=softcap, window=window, k_scale=k_scale, v_scale=v_scale,
            seq_base=seq_base, return_lse=return_lse)
    b, t_q, n_heads, hd = q.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != b:
        raise ValueError(f"flash_attention_batched needs a (B, L, S, row) "
                         f"cache of {b} slots, got {tuple(k_cache.shape)}")
    _, n_layers, s_len, row = k_cache.shape
    check_batched("flash_attention_batched", q, pos, n_kv, row, 1,
                  (k_cache, v_cache), (k_scale, v_scale))
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} outside the cache's {n_layers}")
    if k_scale is not None and k_scale.shape != (b, n_layers, n_kv, s_len):
        raise ValueError(f"scales of shape {tuple(k_scale.shape)}, need "
                         f"{(b, n_layers, n_kv, s_len)}")
    qf = q.float().contiguous()
    if qf.data_ptr() % 16:
        raise ValueError("flash_attention_batched needs a 16-byte aligned q")
    quant = k_scale is not None
    ctype = cache_type(k_cache.dtype, False, False)
    split = decode_split(n_heads, n_kv, t_q)
    if (return_lse or seq_base) and not split:
        # the cp partials always take the split pass: one split of the
        # shard's rows where the call would not split
        split = -(-s_len // BKV) * BKV
    if split:
        # the split pass (seq_base: the shard's row base), then kernel M
        res = split_pass(
            qf, k_cache[0, layer], v_cache[0, layer],
            k_scale[0, layer] if quant else None,
            v_scale[0, layer] if quant else None, n_kv=n_kv, s_len=s_len,
            row=row, pos=pos, seq_base=seq_base,
            slot_stride=n_layers * s_len * row,
            scale_slot_stride=n_layers * n_kv * s_len if quant else 0,
            table=None, maxp=0, psz=0, split=split,
            n_split=n_splits_device(s_len, t_q, window, split), scale=scale,
            softcap=softcap, window=window, ctype=ctype,
            what="flash_attention_batched",
            out=None if return_lse else torch.empty_like(qf))
        flash_attention_batched.launches += 1
        if return_lse:
            # B1, the cp partials form: its own count beside I's
            flash_attention_batched.lse_launches += 1
            return flash_merge(*res, raw=True)
        return res
    out = torch.empty_like(qf)
    err = entry()(
        qf.data_ptr(), k_cache[0, layer].data_ptr(),
        v_cache[0, layer].data_ptr(),
        k_scale[0, layer].data_ptr() if quant else None,
        v_scale[0, layer].data_ptr() if quant else None,
        out.data_ptr(), b, t_q, n_heads, n_kv, hd, s_len, row,
        pos.data_ptr(), n_layers * s_len * row,
        n_layers * n_kv * s_len if quant else 0, None, 0, 0, scale,
        0.0 if softcap is None else float(softcap),
        -1 if window is None else int(window), ctype,
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda.check(err, "flash_attention_batched")
    flash_attention_batched.launches += 1
    return out


flash_attention_batched.launches = 0
flash_attention_batched.lse_launches = 0
