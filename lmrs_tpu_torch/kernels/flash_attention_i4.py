"""Kernel H: flash attention over one layer of the int4 KV cache (t_q <=
256).  CUDA source: `lmrs_tpu_torch/csrc/flash_attention.cu` (the two
nibble-packed instantiations of kernel C's template, one per packing),
whose header note names the TPU kernel variant it replaces and its design.

The cache holds nibble-packed rows (L, S, KH*hd/2) of int8 bytes and f32
scales (L, KH, S), one per (kv head, row), as `quant.quantize_kv_rows_q4`
writes them; `quant.q4_cache_pair_mode` says which two values share a byte.
The kernel unpacks the bytes on their way into shared memory and then
computes what kernel G computes on the integer values: no float or int8
K/V is formed in device memory.  A decode call is flash-decoding, as for
kernel C (the split pass, then kernel M: `kernels.flash_merge`), and
takes its position from the host or the device, as C does.  The wrapper
launches the kernel for CUDA tensors (or raises) and runs the plain
version for CPU tensors; `flash_attention_i4.launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lmrs_tpu_torch.kernels import cuda
from lmrs_tpu_torch.kernels.flash_attention import (check_geometry,
                                                    live_prefix,
                                                    position_bounds)
from lmrs_tpu_torch.kernels.flash_merge import (I4_HALF, I4_PAIR,
                                                decode_single)
from lmrs_tpu_torch.ops.attention import attention
from lmrs_tpu_torch.quant import q4_cache_pair_mode, unpack_kv_q4


def _plain(q, k_vals, v_vals, k_scale, v_scale, layer, pos, *, scale,
           softcap, window):
    """The einsum attention on unpacked integer rows (n, KH, hd), scales
    folded as the kernel folds them."""
    n = k_vals.shape[0]
    return attention(q, k_vals, v_vals, pos, scale=scale, softcap=softcap,
                     window=window, precision="fast",
                     k_scale=k_scale[layer, :, :n],
                     v_scale=v_scale[layer, :, :n])


def flash_attention_i4_plain(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, layer: int, pos, *,
                             n_kv: int, scale: float,
                             softcap: Optional[float] = None,
                             window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: `unpack_kv_q4` on the live rows [0, pos + T)
    of the layer, then the einsum attention with the scales folded (`pos`
    a host int or a (1,) tensor)."""
    if q.is_cuda:
        cuda.plain_numerics()
    t_q, _, hd = q.shape
    k = unpack_kv_q4(live_prefix(k_cache[layer], pos, t_q), n_kv, hd)
    v = unpack_kv_q4(live_prefix(v_cache[layer], pos, t_q), n_kv, hd)
    return _plain(q, k, v, k_scale, v_scale, layer, pos, scale=scale,
                  softcap=softcap, window=window)


def flash_attention_i4_tol(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, layer: int, pos: int, *,
                           n_kv: int, scale: float,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """Per-element bound on |kernel - plain|, (T, H, hd) f32: as
    `flash_attention_i8.flash_attention_i8_tol`, (2^-7 + 2^-9) times the
    plain version run on |v_int| (the unpacked values lie in [-8, 7], so
    their magnitude is taken after unpacking: the packed byte spans the
    whole int8 range and has no magnitude of its own)."""
    t_q, _, hd = q.shape
    n = pos + t_q
    k = unpack_kv_q4(k_cache[layer, :n], n_kv, hd)
    v = unpack_kv_q4(v_cache[layer, :n], n_kv, hd).abs()
    if q.is_cuda:
        cuda.plain_numerics()
    a = _plain(q, k, v, k_scale, v_scale, layer, pos, scale=scale,
               softcap=softcap, window=window)
    return (2.0 ** -7 + 2.0 ** -9) * a


def _entry():
    fn = cuda.library("flash_attention").lmrs_flash_attention_i4
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_i4(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, k_scale: torch.Tensor,
                       v_scale: torch.Tensor, layer: int, pos, *,
                       n_kv: int, scale: float,
                       softcap: Optional[float] = None,
                       window: Optional[int] = None,
                       pos_range: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
    """q (T, H, hd) float32 with RoPE applied; k_cache/v_cache (L, S,
    KH*hd/2) int8 nibble bytes and k_scale/v_scale (L, KH, S) f32 holding
    rows [0, pos + T) of `layer` -> (T, H, hd) f32.  `pos` as for
    `flash_attention.flash_attention` (a host int, or a device position
    with its host bounds `pos_range`)."""
    if not q.is_cuda:
        position_bounds(pos, pos_range)
        return flash_attention_i4_plain(q, k_cache, v_cache, k_scale,
                                        v_scale, layer, pos, n_kv=n_kv,
                                        scale=scale, softcap=softcap,
                                        window=window)
    split = check_geometry("flash_attention_i4", q, k_cache, v_cache,
                           layer, pos, n_kv, torch.int8, per_byte=2,
                           pos_range=pos_range)
    t_q, n_heads, hd = q.shape
    n_layers, s_len, row = k_cache.shape
    for name, a in (("k_scale", k_scale), ("v_scale", v_scale)):
        if a.shape != (n_layers, n_kv, s_len) or a.dtype != torch.float32 \
                or not a.is_contiguous() or a.device != q.device:
            raise ValueError(f"flash_attention_i4 needs a contiguous f32 "
                             f"{name} of shape ({n_layers}, {n_kv}, {s_len}) "
                             f"on {q.device}")
    qf = q.float().contiguous()
    if qf.data_ptr() % 16:
        raise ValueError("flash_attention_i4 needs a 16-byte aligned q")
    pair = q4_cache_pair_mode(n_kv, hd)
    ctype = I4_PAIR if pair else I4_HALF
    if split:
        out = decode_single(qf, k_cache[layer], v_cache[layer],
                            k_scale[layer], v_scale[layer], n_kv=n_kv,
                            s_len=s_len, row=row, pos=pos, split=split,
                            scale=scale, softcap=softcap, window=window,
                            ctype=ctype, what="flash_attention_i4",
                            pos_range=pos_range)
        flash_attention_i4.launches += 1
        return out
    out = torch.empty_like(qf)
    err = _entry()(qf.data_ptr(), k_cache[layer].data_ptr(),
                   v_cache[layer].data_ptr(), k_scale[layer].data_ptr(),
                   v_scale[layer].data_ptr(), out.data_ptr(), t_q, n_heads,
                   n_kv, hd, s_len, row, pos, scale,
                   0.0 if softcap is None else float(softcap),
                   -1 if window is None else int(window),
                   int(pair),
                   torch.cuda.current_stream(q.device).cuda_stream)
    cuda.check(err, "flash_attention_i4")
    flash_attention_i4.launches += 1
    return out


flash_attention_i4.launches = 0
