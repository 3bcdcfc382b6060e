"""Kernel G: flash attention over one layer of the int8 KV cache (t_q <=
256).  CUDA source: `lmrs_tpu_torch/csrc/flash_attention.cu` (the int8
instantiation of kernel C's template), whose header note names the TPU
kernel variant it replaces and its design.

The cache holds int8 rows (L, S, KH*hd) and f32 scales (L, KH, S), one per
(kv head, row), as `models.transformer.quantize_kv_rows` writes them.  The
key scale multiplies the score column, the value scale folds into the
softmax weight before its bf16 rounding, and both products run on the
integer values: no float K/V is formed.  A decode call is flash-decoding,
as for kernel C (the split pass, then kernel M: `kernels.flash_merge`),
and takes its position from the host or the device, as C does.  The
wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors; `flash_attention_i8.launches` counts kernel
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
from lmrs_tpu_torch.kernels.flash_merge import I8, decode_single
from lmrs_tpu_torch.ops.attention import attention


def flash_attention_i8_plain(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, layer: int, pos, *,
                             n_kv: int, scale: float,
                             softcap: Optional[float] = None,
                             window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: the einsum attention over the live rows
    [0, pos + T) of the layer, scales folded as the kernel folds them
    (`pos` a host int or a (1,) tensor)."""
    if q.is_cuda:
        cuda.plain_numerics()
    t_q, _, hd = q.shape
    k = live_prefix(k_cache[layer], pos, t_q)
    v = live_prefix(v_cache[layer], pos, t_q)
    n = k.shape[0]
    return attention(q, k.reshape(n, n_kv, hd), v.reshape(n, n_kv, hd), pos,
                     scale=scale, softcap=softcap, window=window,
                     precision="fast", k_scale=k_scale[layer, :, :n],
                     v_scale=v_scale[layer, :, :n])


def flash_attention_i8_tol(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, layer: int, pos: int,
                           **kw) -> torch.Tensor:
    """Per-element bound on |kernel - plain version|, (T, H, hd) f32: as
    `flash_attention.flash_attention_tol`, with the softmax weight times the
    value scale in the place of the weight.  The kernel rounds
    exp(s - m) * vs to bf16, the plain version the normalized weight times
    vs: each is within 2^-8 of the exact one, so the outputs differ by at
    most 2^-7 * sum_j w_j vs_j |v_int_j|, the plain version run on |v_int|
    (the quantizer never writes -128, whose int8 magnitude would wrap);
    2^-9 of that sum covers the float32 differences."""
    a = flash_attention_i8_plain(q, k_cache, v_cache.clamp(min=-127).abs(),
                                 k_scale, v_scale, layer, pos, **kw)
    return (2.0 ** -7 + 2.0 ** -9) * a


def _entry():
    fn = cuda.library("flash_attention").lmrs_flash_attention_i8
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_i8(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, k_scale: torch.Tensor,
                       v_scale: torch.Tensor, layer: int, pos, *,
                       n_kv: int, scale: float,
                       softcap: Optional[float] = None,
                       window: Optional[int] = None,
                       pos_range: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
    """q (T, H, hd) float32 with RoPE applied; k_cache/v_cache (L, S,
    KH*hd) int8 and k_scale/v_scale (L, KH, S) f32 holding rows
    [0, pos + T) of `layer` -> (T, H, hd) f32.  `pos` as for
    `flash_attention.flash_attention` (a host int, or a device position
    with its host bounds `pos_range`)."""
    if not q.is_cuda:
        position_bounds(pos, pos_range)
        return flash_attention_i8_plain(q, k_cache, v_cache, k_scale,
                                        v_scale, layer, pos, n_kv=n_kv,
                                        scale=scale, softcap=softcap,
                                        window=window)
    split = check_geometry("flash_attention_i8", q, k_cache, v_cache,
                           layer, pos, n_kv, torch.int8,
                           pos_range=pos_range)
    t_q, n_heads, hd = q.shape
    n_layers, s_len, row = k_cache.shape
    for name, a in (("k_scale", k_scale), ("v_scale", v_scale)):
        if a.shape != (n_layers, n_kv, s_len) or a.dtype != torch.float32 \
                or not a.is_contiguous() or a.device != q.device:
            raise ValueError(f"flash_attention_i8 needs a contiguous f32 "
                             f"{name} of shape ({n_layers}, {n_kv}, {s_len}) "
                             f"on {q.device}")
    qf = q.float().contiguous()
    if qf.data_ptr() % 16:
        raise ValueError("flash_attention_i8 needs a 16-byte aligned q")
    if split:
        out = decode_single(qf, k_cache[layer], v_cache[layer],
                            k_scale[layer], v_scale[layer], n_kv=n_kv,
                            s_len=s_len, row=row, pos=pos, split=split,
                            scale=scale,
                            softcap=softcap, window=window, ctype=I8,
                            what="flash_attention_i8", pos_range=pos_range)
        flash_attention_i8.launches += 1
        return out
    out = torch.empty_like(qf)
    err = _entry()(qf.data_ptr(), k_cache[layer].data_ptr(),
                   v_cache[layer].data_ptr(), k_scale[layer].data_ptr(),
                   v_scale[layer].data_ptr(), out.data_ptr(), t_q, n_heads,
                   n_kv, hd, s_len, row, pos, scale,
                   0.0 if softcap is None else float(softcap),
                   -1 if window is None else int(window),
                   torch.cuda.current_stream(q.device).cuda_stream)
    cuda.check(err, "flash_attention_i8")
    flash_attention_i8.launches += 1
    return out


flash_attention_i8.launches = 0
