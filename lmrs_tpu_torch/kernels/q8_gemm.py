"""Kernel F: Q8_0 GEMM for prefill chunks (9 <= T <= 512 rows).  CUDA
source: `lmrs_tpu_torch/csrc/q8_gemm.cu`, whose header note names the TPU
kernels it replaces and its design.

    y = x_bf16 . W_deq^T,  W_deq = bf16(bf16(wq) * bf16(s)),  f32 accumulate

The wrapper launches the kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors; `q8_gemm.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from lmrs_tpu_torch.kernels import cuda

MIN_T, MAX_T = 9, 512


def dequant_bf16(q: torch.Tensor, s: torch.Tensor,
                 group_size: int) -> torch.Tensor:
    """W_deq = bf16(bf16(wq) * bf16(s)) as a dense (O, K) bf16 matrix — the
    rounding the kernel applies in registers (an int8 value is exact
    in bf16)."""
    o, g = s.shape
    sb = s.to(torch.bfloat16).float()
    wd = q.float().reshape(o, g, group_size) * sb[..., None]
    return wd.reshape(o, g * group_size).to(torch.bfloat16)


def q8_gemm_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                  group_size: int) -> torch.Tensor:
    """Plain PyTorch version: dequantize to bf16, then an f32 product of the
    bf16 operands (exact products, f32 sums)."""
    if x.is_cuda:
        cuda.plain_numerics()
    wd = dequant_bf16(q, s, group_size).float()
    return x.to(torch.bfloat16).float() @ wd.t()


def _entry():
    fn = cuda.library("q8_gemm").lmrs_q8_gemm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def q8_gemm(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
            group_size: int) -> torch.Tensor:
    """x (T, K) float, q (O, K) int8, s (O, K/gs) f32 -> y (T, O) f32.  x is
    rounded to bf16 first."""
    if not x.is_cuda:
        return q8_gemm_plain(x, q, s, group_size)
    t, k = x.shape
    o = q.shape[0]
    if not MIN_T <= t <= MAX_T:
        raise ValueError(f"q8_gemm takes {MIN_T}..{MAX_T} rows, got {t}")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"q8_gemm wants int8 q, f32 s; got {q.dtype}, "
                        f"{s.dtype}")
    if q.shape != (o, k) or s.shape != (o, k // group_size):
        raise ValueError(f"shapes x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"s {tuple(s.shape)} do not match gs={group_size}")
    if k % 128 or group_size % 16 or k % group_size:
        raise ValueError(f"q8_gemm needs K % 128 == 0, gs % 16 == 0 and "
                         f"K % gs == 0 (K={k}, gs={group_size})")
    xb = x.to(torch.bfloat16).contiguous()
    for name, a in (("q", q), ("s", s)):
        if not a.is_contiguous() or a.device != x.device:
            raise ValueError(f"q8_gemm needs a contiguous {name} on "
                             f"{x.device}")
    if q.data_ptr() % 16 or xb.data_ptr() % 16:
        raise ValueError("q8_gemm needs 16-byte aligned x and q")
    y = torch.empty((t, o), dtype=torch.float32, device=x.device)
    err = _entry()(xb.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                   t, o, k, group_size,
                   torch.cuda.current_stream(x.device).cuda_stream)
    cuda.check(err, "q8_gemm")
    q8_gemm.launches += 1
    return y


q8_gemm.launches = 0
