"""Kernel D: Q8_0 W8A8 GEMV for T <= 8 rows (decode steps and prompt tails
of the layer weights).  CUDA source: `lmrs_tpu_torch/csrc/q8_gemv_i8.cu`,
whose header note names the TPU kernels it replaces and its design.

    xq, xs = quantize_q8_act(x)            (int8 values, f32 group scales)
    y[t, o] = sum_g (float(sum_{k in g} wq[o, k] * xq[t, k]) * ws[o, g])
                    * xs[t, g]

The integer dot of a group is exact; the scales multiply it in f32, weight
scale first, and the groups add in increasing order (then the K split's
partial sums in rank order).  One launch a call: each block quantizes the
slice of x its K range needs into shared memory with the standalone
quantizer's arithmetic (`q8_act_quant`, kept for the bit-exact card
check), so xq and xs never reach device memory and the wrapper allocates
only y.  The wrapper launches the kernel for CUDA tensors (or raises) and
runs the plain version for CPU tensors; `q8_gemv_i8.launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from lmrs_tpu_torch.kernels import cuda
from lmrs_tpu_torch.quant import quantize_q8_act

MAX_T = 8
MAX_K = 8 * 4096        # eight ranks of the K split, 4,096 bytes each
GROUP_SIZES = (32, 64, 128, 256)


def q8_gemv_i8_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     group_size: int) -> torch.Tensor:
    """Plain PyTorch version: quantize x per group, integer dot per group
    (computed in f32, where a group's products, each below 2^14, sum
    exactly in any order), times the two scales in f32, weight scale first,
    summed over groups."""
    if x.is_cuda:
        cuda.plain_numerics()
    t, k = x.shape
    o, g = s.shape
    xq, xs = quantize_q8_act(x.float(), group_size)
    part = torch.einsum("tgk,ogk->tog",
                        xq.float().reshape(t, g, group_size),
                        q.float().reshape(o, g, group_size))
    return ((part * s.float()[None]) * xs[:, None, :]).sum(dim=-1)


def _entries():
    lib = cuda.library("q8_gemv_i8")
    quant, gemv = lib.lmrs_q8_act_quant, lib.lmrs_q8_gemv_i8
    if gemv.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        quant.argtypes = [p, p, p, i, i, i, p]
        quant.restype = ctypes.c_int
        gemv.argtypes = [p, p, p, p, i, i, i, i, p]
        gemv.restype = ctypes.c_int
    return quant, gemv


def _check_x(x, group_size):
    t, k = x.shape
    if not 1 <= t <= MAX_T:
        raise ValueError(f"q8_gemv_i8 takes 1..{MAX_T} rows, got {t}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError(f"q8_gemv_i8 wants contiguous f32 x, got {x.dtype}")
    if group_size not in GROUP_SIZES or k % group_size or k > MAX_K:
        raise ValueError(f"q8_gemv_i8 needs gs in {GROUP_SIZES}, K % gs == 0 "
                         f"and K <= {MAX_K} (K={k}, gs={group_size})")
    if x.data_ptr() % 16:
        raise ValueError("q8_gemv_i8 needs a 16-byte aligned x")


def q8_act_quant(x: torch.Tensor, group_size: int):
    """Kernel D's quantizer alone: x (T, K) f32 -> (xq int8 (T, K), xs f32
    (T, K/gs)), bit for bit `quant.quantize_q8_act` (which CPU tensors
    take).  Its arithmetic is the device function kernel D quantizes with,
    so this launch checks D's quantizer bit for bit on the card."""
    if not x.is_cuda:
        return quantize_q8_act(x, group_size)
    _check_x(x, group_size)
    t, k = x.shape
    xq = torch.empty((t, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((t, k // group_size), dtype=torch.float32,
                     device=x.device)
    err = _entries()[0](x.data_ptr(), xq.data_ptr(), xs.data_ptr(), t, k,
                        group_size,
                        torch.cuda.current_stream(x.device).cuda_stream)
    cuda.check(err, "q8_act_quant")
    return xq, xs


def q8_gemv_i8(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
               group_size: int) -> torch.Tensor:
    """x (T, K) f32, q (O, K) int8, s (O, K/gs) f32 -> y (T, O) f32."""
    if not x.is_cuda:
        return q8_gemv_i8_plain(x, q, s, group_size)
    _check_x(x, group_size)
    t, k = x.shape
    o = q.shape[0]
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"q8_gemv_i8 wants int8 q, f32 s; got {q.dtype}, "
                        f"{s.dtype}")
    if q.shape != (o, k) or s.shape != (o, k // group_size):
        raise ValueError(f"shapes x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"s {tuple(s.shape)} do not match gs={group_size}")
    for name, a in (("q", q), ("s", s)):
        if not a.is_contiguous() or a.device != x.device:
            raise ValueError(f"q8_gemv_i8 needs a contiguous {name} on "
                             f"{x.device}")
    if q.data_ptr() % 16:
        raise ValueError("q8_gemv_i8 needs a 16-byte aligned q")
    y = torch.empty((t, o), dtype=torch.float32, device=x.device)
    err = _entries()[1](x.data_ptr(), q.data_ptr(), s.data_ptr(),
                        y.data_ptr(), t, o, k, group_size,
                        torch.cuda.current_stream(x.device).cuda_stream)
    cuda.check(err, "q8_gemv_i8")
    q8_gemv_i8.launches += 1
    return y


q8_gemv_i8.launches = 0
