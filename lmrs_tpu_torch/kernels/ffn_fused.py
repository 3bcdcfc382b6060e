"""Kernels K and L: one layer's whole GLU FFN from one C call.  CUDA source:
`lmrs_tpu_torch/csrc/ffn_fused.cu` (K on kernel A's tensor-core pieces,
`csrc/gemv_sm90.cuh`; L on the template of kernels B and F,
`csrc/qgemm_sm90.cuh`), whose header note names the TPU kernels they
replace and their design.  Each is two launches from one C call: the
[gate; up] product with the GLU in its epilogue, then the W2 product (K's
a programmatic dependent launch that streams W2 under the first's tail).

    [gate; up] = W13 . bf16(x),   g = bf16(act(gate) * up),   y = W2 . g

K `ffn_fused_xe` (1 <= T <= 8): the exact integer weights times the bf16
activations, f32 sums per group times the f32 group scale (the numerics of
kernels A and E on bf16 activations).  L `ffn_fused` (9 <= T <= 16): the
weights dequantized as bf16(bf16(q) * bf16(s)), f32 sums (those of kernels
B and F, on their tensor-core template).  Both: the GLU in f32, g rounded
to bf16 once, y f32 (T, D).
W13 holds the [gate; up] rows in their logical order; Q4_0 weights are
runtime-layout bytes (uint8), Q8_0 weights int8, the type telling which.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain version for CPU tensors; `ffn_fused_xe.launches` and
`ffn_fused.launches` count calls of the C entry (one a layer's FFN).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from lmrs_tpu_torch.kernels import cuda
from lmrs_tpu_torch.kernels.q4_gemm import q4_gemm_plain
from lmrs_tpu_torch.kernels.q4_gemv import q4_gemv_plain
from lmrs_tpu_torch.kernels.q8_gemm import q8_gemm_plain
from lmrs_tpu_torch.kernels.q8_gemv import q8_gemv_plain
from lmrs_tpu_torch.ops.activations import gelu_tanh, silu

MAX_T_XE = 8            # K
MIN_T, MAX_T = 9, 16    # L
L_GROUP_SIZES = (32, 64, 128)   # those of kernels B and F
ACTS = {"silu": 0, "gelu": 1}


def ffn_split_perm(h: int, group_size: int) -> np.ndarray:
    """The JAX package's Q4 fused-FFN row order (its
    `kernels.fused_ffn.ffn_split_perm`): P[i] = the logical hidden position
    at row i, rows [0, h/2) the first halves of each group, [h/2, h) the
    second halves.  Its loader stores W13's gate and up rows in this order;
    `io.params.params_from_jax` restores the logical order, the only one
    this package keeps."""
    hs = group_size // 2
    q = np.arange(h // 2)
    lo = (q // hs) * group_size + (q % hs)
    return np.concatenate([lo, lo + hs])


def glu_bf16(gate: torch.Tensor, up: torch.Tensor, act: str) -> torch.Tensor:
    """g = bf16(act(gate) * up), the GLU in f32 (`ops.activations` computes
    the formulas of the JAX fused kernels, fused_ffn.py:105-110, in their
    order of operations)."""
    if act not in ACTS:
        raise ValueError(f"act is one of {sorted(ACTS)}, got {act!r}")
    gate, up = gate.float(), up.float()
    a = silu(gate) if act == "silu" else gelu_tanh(gate)
    return (a * up).to(torch.bfloat16)


def _plain(matmul, x, w13_q, w13_s, w2_q, w2_s, group_size, act):
    gu = matmul(x.to(torch.bfloat16).float(), w13_q, w13_s, group_size)
    h = gu.shape[1] // 2
    g = glu_bf16(gu[:, :h], gu[:, h:], act)
    return matmul(g.float(), w2_q, w2_s, group_size)


def ffn_fused_xe_plain(x, w13_q, w13_s, w2_q, w2_s, group_size: int,
                       act: str) -> torch.Tensor:
    """Plain PyTorch version of K: kernel A's (Q4_0) or E's (Q8_0) plain
    per-group sums on the bf16-rounded x, the GLU, then the same on g."""
    gemv = q4_gemv_plain if w13_q.dtype == torch.uint8 else q8_gemv_plain
    return _plain(gemv, x, w13_q, w13_s, w2_q, w2_s, group_size, act)


def ffn_fused_plain(x, w13_q, w13_s, w2_q, w2_s, group_size: int,
                    act: str) -> torch.Tensor:
    """Plain PyTorch version of L: kernel B's (Q4_0) or F's (Q8_0) plain
    bf16-dequant product, the GLU, then the same on g."""
    gemm = q4_gemm_plain if w13_q.dtype == torch.uint8 else q8_gemm_plain
    return _plain(gemm, x, w13_q, w13_s, w2_q, w2_s, group_size, act)


def _entry():
    fn = cuda.library("ffn_fused").lmrs_ffn_fused
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name, numerics, t_range, x, w13_q, w13_s, w2_q, w2_s,
            group_size, act):
    """Check what the CUDA kernel takes, raise on anything else, launch."""
    t, d = x.shape
    lo, hi = t_range
    if not lo <= t <= hi:
        raise ValueError(f"{name} takes {lo}..{hi} rows, got {t}")
    if act not in ACTS:
        raise ValueError(f"{name}: act is one of {sorted(ACTS)}, got {act!r}")
    if w13_q.dtype not in (torch.uint8, torch.int8) \
            or w2_q.dtype != w13_q.dtype or w13_s.dtype != torch.float32 \
            or w2_s.dtype != torch.float32 \
            or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} wants float x, uint8 (Q4_0) or int8 (Q8_0) "
                        f"weights of one type and f32 scales; got "
                        f"{x.dtype}, {w13_q.dtype}, {w13_s.dtype}, "
                        f"{w2_q.dtype}, {w2_s.dtype}")
    q4 = w13_q.dtype == torch.uint8
    per_byte = 2 if q4 else 1
    h = w13_q.shape[0] // 2
    gs = group_size
    if gs % 32 or d % gs or h % gs:
        raise ValueError(f"{name} needs gs % 32 == 0, D % gs == 0 and "
                         f"H % gs == 0 (D={d}, H={h}, gs={gs})")
    if numerics == 1 and gs not in L_GROUP_SIZES:
        raise ValueError(f"{name} takes gs in {L_GROUP_SIZES}, got {gs}")
    if (w13_q.shape != (2 * h, d // per_byte)
            or w13_s.shape != (2 * h, d // gs)
            or w2_q.shape != (d, h // per_byte) or w2_s.shape != (d, h // gs)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w13 "
                         f"{tuple(w13_q.shape)} / {tuple(w13_s.shape)}, w2 "
                         f"{tuple(w2_q.shape)} / {tuple(w2_s.shape)} do not "
                         f"match one FFN of gs={gs}")
    xb = x.to(torch.bfloat16).contiguous()
    for what, a in (("w13 q", w13_q), ("w13 s", w13_s), ("w2 q", w2_q),
                    ("w2 s", w2_s)):
        if not a.is_contiguous() or a.device != x.device:
            raise ValueError(f"{name} needs a contiguous {what} on "
                             f"{x.device}")
    if xb.data_ptr() % 16 or w13_q.data_ptr() % 16 or w2_q.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte aligned x, w13 and w2")
    g = torch.empty((t, h), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((t, d), dtype=torch.float32, device=x.device)
    err = _entry()(numerics, 0 if q4 else 1, xb.data_ptr(), w13_q.data_ptr(),
                   w13_s.data_ptr(), w2_q.data_ptr(), w2_s.data_ptr(),
                   g.data_ptr(), y.data_ptr(), t, d, h, gs, ACTS[act],
                   torch.cuda.current_stream(x.device).cuda_stream)
    cuda.check(err, name)
    return y


def ffn_fused_xe(x: torch.Tensor, w13_q: torch.Tensor, w13_s: torch.Tensor,
                 w2_q: torch.Tensor, w2_s: torch.Tensor, group_size: int,
                 act: str) -> torch.Tensor:
    """Kernel K: x (T, D) float, 1 <= T <= 8; w13 (2H, D/2) uint8 or
    (2H, D) int8 with f32 scales (2H, D/gs); w2 (D, H/2) or (D, H) with
    (D, H/gs); act "silu" or "gelu" (tanh) -> y (T, D) f32."""
    if not x.is_cuda:
        return ffn_fused_xe_plain(x, w13_q, w13_s, w2_q, w2_s, group_size,
                                  act)
    y = _launch("ffn_fused_xe", 0, (1, MAX_T_XE), x, w13_q, w13_s, w2_q,
                w2_s, group_size, act)
    ffn_fused_xe.launches += 1
    return y


def ffn_fused(x: torch.Tensor, w13_q: torch.Tensor, w13_s: torch.Tensor,
              w2_q: torch.Tensor, w2_s: torch.Tensor, group_size: int,
              act: str) -> torch.Tensor:
    """Kernel L: as `ffn_fused_xe` for 9 <= T <= 16 rows, in the bf16
    dequantized-weight numerics."""
    if not x.is_cuda:
        return ffn_fused_plain(x, w13_q, w13_s, w2_q, w2_s, group_size, act)
    y = _launch("ffn_fused", 1, (MIN_T, MAX_T), x, w13_q, w13_s, w2_q, w2_s,
                group_size, act)
    ffn_fused.launches += 1
    return y


ffn_fused_xe.launches = 0
ffn_fused.launches = 0
