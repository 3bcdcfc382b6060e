"""Kernel A: Q4_0 GEMV for T <= 8 rows (decode steps, prompt tails, the
classifier).  CUDA source: `lmrs_tpu_torch/csrc/q4_gemv.cu`, whose header
note names the TPU kernels it replaces and its design.

    y[t, o] = sum_g s[o, g] * sum_{k in g} w[o, k] * x[t, k]

f32 activations, exact integer weights, f32 sums, runtime-layout Q4
bytes.  On the card the products run on the tensor cores: x enters as three
bf16 slices that sum to it exactly, so it keeps its f32 value, and every
(t, o) takes the same operations whatever T is (a row of a T-row call is
the row computed alone, bit for bit).  The wrapper launches the kernel for
CUDA tensors (or raises) and runs the plain version for CPU tensors;
`q4_gemv.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from lmrs_tpu_torch.kernels import cuda
from lmrs_tpu_torch.quant import unpack_q4

MAX_T = 8
MAX_K = 16384       # the x slices of a block's K range fit shared memory


def q4_gemv_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                  group_size: int) -> torch.Tensor:
    """Plain PyTorch version: per-group f32 dot products, times the group
    scale, summed over groups."""
    if x.is_cuda:
        cuda.plain_numerics()
    t, k = x.shape
    o, g = s.shape
    w = unpack_q4(q, group_size).float().reshape(o, g, group_size)
    part = torch.einsum("tgk,ogk->tog", x.float().reshape(t, g, group_size),
                        w)
    return (part * s.float()[None]).sum(dim=-1)


def _entry():
    fn = cuda.library("q4_gemv").lmrs_q4_gemv
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(x, q, s, group_size):
    t, k = x.shape
    o = q.shape[0]
    if not 1 <= t <= MAX_T:
        raise ValueError(f"q4_gemv takes 1..{MAX_T} rows, got {t}")
    if x.dtype != torch.float32 or q.dtype != torch.uint8 \
            or s.dtype != torch.float32:
        raise TypeError("q4_gemv wants f32 x, uint8 q, f32 s; got "
                        f"{x.dtype}, {q.dtype}, {s.dtype}")
    if q.shape != (o, k // 2) or s.shape != (o, k // group_size):
        raise ValueError(f"shapes x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"s {tuple(s.shape)} do not match gs={group_size}")
    if group_size % 32 or k % group_size or k > MAX_K:
        raise ValueError(f"q4_gemv needs gs % 32 == 0, K % gs == 0 and "
                         f"K <= {MAX_K} (K={k}, gs={group_size})")
    for name, a in (("x", x), ("q", q), ("s", s)):
        if not a.is_contiguous():
            raise ValueError(f"q4_gemv needs a contiguous {name}")
        if a.device != x.device:
            raise ValueError("q4_gemv inputs lie on different devices")
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("q4_gemv needs 16-byte aligned x and q")


def q4_gemv(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
            group_size: int) -> torch.Tensor:
    """x (T, K) f32, q (O, K/2) uint8 runtime layout, s (O, K/gs) f32 ->
    y (T, O) f32."""
    if not x.is_cuda:
        return q4_gemv_plain(x, q, s, group_size)
    _check_inputs(x, q, s, group_size)
    t, k = x.shape
    o = q.shape[0]
    y = torch.empty((t, o), dtype=torch.float32, device=x.device)
    err = _entry()(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                   t, o, k, group_size,
                   torch.cuda.current_stream(x.device).cuda_stream)
    cuda.check(err, "q4_gemv")
    q4_gemv.launches += 1
    return y


q4_gemv.launches = 0
