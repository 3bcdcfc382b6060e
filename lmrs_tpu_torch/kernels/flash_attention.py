"""Kernel C: flash attention over one layer of the bf16 or f32 KV cache
(t_q <= 256).  CUDA source: `lmrs_tpu_torch/csrc/flash_attention.cu`, whose
header note names the TPU kernel it replaces and its design.

Computes `ops.attention.attention(q, k[l, :pos+T], v[l, :pos+T], pos,
precision="fast")` with the cache in its merged (L, S, KH*hd) layout.  An
f32 cache's values are rounded to bf16 as they are read (the kernel's f32
instantiation does so on the tile's way into shared memory), so it gives
the bf16 cache's result bit for bit.  A decode call (one query block per
kv head, G*T <= 64) is flash-decoding: the template's split pass over the
sequence, its grid sized from the host position, then kernel M's merge
(`kernels.flash_merge`, which counts its own launches); longer calls walk
whole in one launch.  A decode call takes its position from the host (an
int) or from the device (a (1,) int32 tensor, with host bounds `pos_range`
that size the split axis: `flash_merge.n_splits_range`), with the same
result bit for bit.  The wrapper launches the kernel for CUDA tensors (or
raises) and runs the plain version for CPU tensors;
`flash_attention.launches` counts kernel launches of both cache types (a
split pass is one).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lmrs_tpu_torch.kernels import cuda
from lmrs_tpu_torch.kernels.flash_merge import (BF16, F32, decode_single,
                                                decode_split)
from lmrs_tpu_torch.ops.attention import attention

MAX_T = 256
HEAD_DIMS = (64, 128, 256)


def position_bounds(pos, pos_range: Optional[Tuple[int, int]]
                    ) -> Tuple[int, int]:
    """(lo, hi): host bounds of a call's position.  A host int is its own
    bounds; a device position is a (1,) int32 tensor that comes with its
    host bounds `pos_range`."""
    if not isinstance(pos, torch.Tensor):
        return int(pos), int(pos)
    if pos_range is None:
        raise ValueError("a device position needs its host bounds "
                         "pos_range")
    if pos.shape != (1,) or pos.dtype != torch.int32:
        raise ValueError(f"a device position is a (1,) int32 tensor, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    lo, hi = int(pos_range[0]), int(pos_range[1])
    if lo > hi:
        raise ValueError(f"pos_range {pos_range} is empty")
    return lo, hi


def live_prefix(a: torch.Tensor, pos, t_q: int, axis: int = 0
                ) -> torch.Tensor:
    """The rows [0, pos + T) of `a` along `axis`: a slice for a host
    position, the rows that a mask built from a tensor position selects
    (the same rows, so that a plain version computes the same bits from
    either; the mask's dynamic shape is for the plain versions only)."""
    if not isinstance(pos, torch.Tensor):
        return a.narrow(axis, 0, pos + t_q)
    keep = torch.arange(a.shape[axis], device=a.device) \
        < pos.to(a.device) + t_q
    return a[(slice(None),) * axis + (keep,)]


def flash_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, layer: int, pos, *,
                          n_kv: int, scale: float,
                          softcap: Optional[float] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: the einsum attention over the live rows
    [0, pos + T) of the layer (`pos` a host int or a (1,) tensor)."""
    if q.is_cuda:
        cuda.plain_numerics()
    t_q, _, hd = q.shape
    k = live_prefix(k_cache[layer], pos, t_q)
    v = live_prefix(v_cache[layer], pos, t_q)
    n = k.shape[0]
    return attention(q, k.reshape(n, n_kv, hd), v.reshape(n, n_kv, hd), pos,
                     scale=scale, softcap=softcap, window=window,
                     precision="fast")


def flash_attention_tol(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, layer: int, pos: int,
                        **kw) -> torch.Tensor:
    """Per-element bound on |kernel - plain version|, (T, H, hd) f32.

    The kernel rounds each unnormalized softmax weight exp(s - m) to bf16,
    the plain version each normalized weight: each side's weight is within
    2^-8 of the exact one, so the two outputs differ by at most
    2^-7 * sum_j w_j |v_j|, which is the plain version run on |v|.  The
    added 2^-9 of that sum covers the float32 differences, worst case at
    hd 256 and 4,097 keys: scores summed in another order (3e-4) and the
    p.V sums in another order (5e-4 for both sides).  The bound follows
    the softmax weights, so it shrinks where a wrong key set would show.
    """
    a = flash_attention_plain(q, k_cache, v_cache.abs(), layer, pos, **kw)
    return (2.0 ** -7 + 2.0 ** -9) * a


def check_geometry(name: str, q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, layer: int, pos, n_kv: int,
                   dtype: torch.dtype, per_byte: int = 1,
                   pos_range: Optional[Tuple[int, int]] = None) -> int:
    """Raise unless q (T, H, hd) and the (L, S, KH*hd / per_byte) caches of
    `dtype` are what the flash kernels take, and every position the call
    may have keeps its rows in the cache (shared by every wrapper;
    `per_byte` is 2 for the nibble-packed int4 cache).  Returns the split
    of a decode call, or 0; a device position needs one (prefill chunks
    keep the host position)."""
    t_q, n_heads, hd = q.shape
    n_layers, s_len, row = k_cache.shape
    lo, hi = position_bounds(pos, pos_range)
    if not 1 <= t_q <= MAX_T:
        raise ValueError(f"{name} takes 1..{MAX_T} queries, got {t_q}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name} is built for head dims {HEAD_DIMS}, "
                         f"got {hd}")
    if n_heads % n_kv or row * per_byte != n_kv * hd:
        raise ValueError(f"{n_heads} heads, {n_kv} kv heads, cache rows of "
                         f"{row} do not fit head_dim {hd}")
    if not 0 <= layer < n_layers or lo < 0 or hi + t_q > s_len:
        raise ValueError(f"layer {layer}, rows [{lo}, {hi + t_q}) outside "
                         f"the cache ({n_layers}, {s_len})")
    if k_cache.dtype != dtype or v_cache.shape != k_cache.shape \
            or v_cache.dtype != dtype:
        raise TypeError(f"{name} reads a {dtype} cache, got {k_cache.dtype} "
                        f"and {v_cache.dtype}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"{name} needs contiguous caches")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte aligned caches")
    split = decode_split(n_heads, n_kv, t_q)
    if isinstance(pos, torch.Tensor):
        if not split:
            raise ValueError(f"{name}: a device position takes the decode "
                             f"path (one query block per kv head), not "
                             f"{n_heads // n_kv} x {t_q} rows")
        if pos.device != q.device:
            raise ValueError(f"{name} needs the position on {q.device}")
    return split


def _entry(dtype: torch.dtype):
    lib = cuda.library("flash_attention")
    fn = (lib.lmrs_flash_attention_f32 if dtype == torch.float32
          else lib.lmrs_flash_attention)
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, f, f, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, layer: int, pos, *,
                    n_kv: int, scale: float, softcap: Optional[float] = None,
                    window: Optional[int] = None,
                    pos_range: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """q (T, H, hd) float32 with RoPE applied; k_cache/v_cache (L, S,
    KH*hd) bf16 or f32 holding rows [0, pos + T) of `layer` -> (T, H, hd)
    f32.  `pos` is a host int, or for a decode call a (1,) int32 tensor on
    q's device with host bounds `pos_range` = (lo, hi) (module note)."""
    if not q.is_cuda:
        position_bounds(pos, pos_range)
        return flash_attention_plain(q, k_cache, v_cache, layer, pos,
                                     n_kv=n_kv, scale=scale, softcap=softcap,
                                     window=window)
    dtype = (torch.float32 if k_cache.dtype == torch.float32
             else torch.bfloat16)
    split = check_geometry("flash_attention", q, k_cache, v_cache, layer,
                           pos, n_kv, dtype, pos_range=pos_range)
    t_q, n_heads, hd = q.shape
    _, s_len, row = k_cache.shape
    qf = q.float().contiguous()
    if qf.data_ptr() % 16:
        raise ValueError("flash_attention needs a 16-byte aligned q")
    ctype = F32 if dtype == torch.float32 else BF16
    if split:
        out = decode_single(qf, k_cache[layer], v_cache[layer], None, None,
                            n_kv=n_kv, s_len=s_len, row=row, pos=pos,
                            split=split, scale=scale, softcap=softcap,
                            window=window, ctype=ctype,
                            what="flash_attention", pos_range=pos_range)
        flash_attention.launches += 1
        return out
    out = torch.empty_like(qf)
    err = _entry(dtype)(
        qf.data_ptr(), k_cache[layer].data_ptr(), v_cache[layer].data_ptr(),
        out.data_ptr(), t_q, n_heads, n_kv, hd, s_len, row, pos, scale,
        0.0 if softcap is None else float(softcap),
        -1 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
