"""Kernel E: Q8_0 W8A16 GEMV for T <= 8 rows (the classifier at every
decode step, and the layer weights when W8A8 is switched off).  CUDA
source: `lmrs_tpu_torch/csrc/q8_gemv.cu`, whose header note names the TPU
kernels it replaces and its design.

    y[t, o] = sum_g s[o, g] * sum_{k in g} float(wq[o, k]) * x[t, k]

f32 activations, f32 accumulation, no activation quantization.  The
wrapper launches the kernel for CUDA tensors (or raises) and runs the plain
version for CPU tensors; `q8_gemv.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from lmrs_tpu_torch.kernels import cuda

MAX_T = 8


def q8_gemv_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                  group_size: int) -> torch.Tensor:
    """Plain PyTorch version: per-group f32 dot products, times the group
    scale, summed over groups."""
    if x.is_cuda:
        cuda.plain_numerics()
    t, k = x.shape
    o, g = s.shape
    part = torch.einsum("tgk,ogk->tog", x.float().reshape(t, g, group_size),
                        q.float().reshape(o, g, group_size))
    return (part * s.float()[None]).sum(dim=-1)


def _entry():
    fn = cuda.library("q8_gemv").lmrs_q8_gemv
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(x, q, s, group_size):
    t, k = x.shape
    o = q.shape[0]
    if not 1 <= t <= MAX_T:
        raise ValueError(f"q8_gemv takes 1..{MAX_T} rows, got {t}")
    if x.dtype != torch.float32 or q.dtype != torch.int8 \
            or s.dtype != torch.float32:
        raise TypeError("q8_gemv wants f32 x, int8 q, f32 s; got "
                        f"{x.dtype}, {q.dtype}, {s.dtype}")
    if q.shape != (o, k) or s.shape != (o, k // group_size):
        raise ValueError(f"shapes x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"s {tuple(s.shape)} do not match gs={group_size}")
    if group_size % 16 or k % group_size:
        raise ValueError(f"q8_gemv needs gs % 16 == 0 and K % gs == 0 "
                         f"(K={k}, gs={group_size})")
    for name, a in (("x", x), ("q", q), ("s", s)):
        if not a.is_contiguous():
            raise ValueError(f"q8_gemv needs a contiguous {name}")
        if a.device != x.device:
            raise ValueError("q8_gemv inputs lie on different devices")
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("q8_gemv needs 16-byte aligned x and q")


def q8_gemv(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
            group_size: int) -> torch.Tensor:
    """x (T, K) f32, q (O, K) int8, s (O, K/gs) f32 -> y (T, O) f32."""
    if not x.is_cuda:
        return q8_gemv_plain(x, q, s, group_size)
    _check_inputs(x, q, s, group_size)
    t, k = x.shape
    o = q.shape[0]
    y = torch.empty((t, o), dtype=torch.float32, device=x.device)
    err = _entry()(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                   t, o, k, group_size,
                   torch.cuda.current_stream(x.device).cuda_stream)
    cuda.check(err, "q8_gemv")
    q8_gemv.launches += 1
    return y


q8_gemv.launches = 0
