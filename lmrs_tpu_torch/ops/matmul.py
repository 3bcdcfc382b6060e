"""Quantized matmul y = x . W^T, dispatched by the weight type and the
number of rows T.

    Q4_0  T <= 8        -> kernel A, q4_gemv (f32 activations)
          9 <= T <= 512 -> kernel B, q4_gemm (bf16 activations, bf16
                           dequantized weights in registers)
    Q8_0  T <= 8        -> kernel D, q8_gemv_i8 (W8A8: activations quantized
                           to int8 per group, integer dots) for layer
                           weights while `w8a8` is on; kernel E, q8_gemv
                           (W8A16, f32 activations) for the classifier
                           always and for layer weights when `w8a8` is off
          9 <= T <= 512 -> kernel F, q8_gemm (as B)
    both  T > 512       -> dequantize to bf16 in device memory, then one f32
                           product of the bf16 operands (no quantized
                           kernel: the weights amortize over the rows; the
                           JAX package leaves this case to XLA in the same
                           way)
    NONE  any T         -> one f32 product (the JAX package computes it
                           outside any kernel too)

The classifier (the tied embedding, or Phi's lm_head) takes E whatever
`w8a8` says because the JAX fast path sends its unstacked weights through
the W8A16 x-expansion kernel, and only the stacked layer weights through
the W8A8 one: a decode step mixes the two numerics.

`qmatmul_exact` is the JAX package's `qmatmul(..., impl="exact")`, the
path of the vision encoder and the image projector: activations quantized
group-wise as lm.rs quantizes them (Q8, or Q4 for Q4 weights), an integer
dot per group, each group's dot scaled in f32, the groups summed in
increasing order.  No TPU kernel computes it (the JAX package leaves it to
XLA), so it runs as float32 `torch.bmm` over the groups: an integer dot
of one group is at most 128 * 127 * 128 < 2^24 in magnitude, so every
partial sum is an exact float32 integer in any order, on the card as on
the CPU.
"""

from __future__ import annotations

import torch

from lmrs_tpu_torch.config import QuantType
from lmrs_tpu_torch.kernels import cuda
from lmrs_tpu_torch.kernels.q4_gemm import MAX_T as GEMM_MAX_T
from lmrs_tpu_torch.kernels.q4_gemm import q4_gemm
from lmrs_tpu_torch.kernels.q4_gemv import MAX_T as GEMV_MAX_T
from lmrs_tpu_torch.kernels.q4_gemv import q4_gemv
from lmrs_tpu_torch.kernels.q8_gemm import q8_gemm
from lmrs_tpu_torch.kernels.q8_gemv import q8_gemv
from lmrs_tpu_torch.kernels.q8_gemv_i8 import q8_gemv_i8
from lmrs_tpu_torch.quant import (QTensor, dequantize, quantize_q4_act,
                                  quantize_q8_act, unpack_q4)


def qmatmul(x: torch.Tensor, w: QTensor, *, w8a8: bool = True,
            classifier: bool = False) -> torch.Tensor:
    """y = x @ W^T for a weight of logical shape (out, in); x float
    (..., in) -> float32 (..., out).  `w8a8` picks the Q8_0 numerics at
    T <= 8 (see the module note); `classifier` marks the logits matmul."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    t = x2.shape[0]
    if w.qtype == QuantType.NONE:
        if x2.is_cuda:
            cuda.plain_numerics()
        y = x2.float() @ w.q.float().t()
    elif t <= GEMV_MAX_T:
        xf = x2.float().contiguous()
        if w.qtype == QuantType.Q4_0:
            y = q4_gemv(xf, w.q, w.s, w.group_size)
        elif w8a8 and not classifier:
            y = q8_gemv_i8(xf, w.q, w.s, w.group_size)
        else:
            y = q8_gemv(xf, w.q, w.s, w.group_size)
    elif t <= GEMM_MAX_T:
        gemm = q4_gemm if w.qtype == QuantType.Q4_0 else q8_gemm
        y = gemm(x2, w.q, w.s, w.group_size)
    else:
        if x2.is_cuda:
            cuda.plain_numerics()
        wd = dequantize(w).to(torch.bfloat16).float()
        y = x2.to(torch.bfloat16).float() @ wd.t()
    return y.reshape(*lead, w.out_features)


def group_ints(xq: torch.Tensor, wq: torch.Tensor,
               group_size: int) -> torch.Tensor:
    """The integer dot of every group: xq (B, n) and wq (O, n) integer
    values -> (G, B, O) float32 holding exact integers (see the module
    note)."""
    b, n = xq.shape
    o = wq.shape[0]
    g = n // group_size
    if xq.is_cuda:
        cuda.plain_numerics()
    xg = xq.float().reshape(b, g, group_size).transpose(0, 1)
    wg = wq.float().reshape(o, g, group_size).transpose(0, 1)
    return torch.bmm(xg, wg.transpose(1, 2))


def group_dot(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
              ws: torch.Tensor, group_size: int) -> torch.Tensor:
    """y[b, o] = sum over g of (int_dot[g, b, o] * xs[b, g]) * ws[o, g],
    the groups added in increasing order; xs (B, G), ws (O, G) f32 ->
    (B, O) f32."""
    scaled = (group_ints(xq, wq, group_size) * xs.t()[:, :, None]
              * ws.t()[:, None, :])
    y = scaled[0]
    for part in scaled[1:]:
        y = y + part
    return y


def qmatmul_exact(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """y = x @ W^T with lm.rs's integer arithmetic (the JAX package's
    impl="exact"): x float (..., in) -> float32 (..., out).  Float (NONE)
    weights take one full-f32 product."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    if w.qtype == QuantType.NONE:
        if x2.is_cuda:
            cuda.plain_numerics()
        y = x2 @ w.q.float().t()
    elif w.qtype == QuantType.Q8_0:
        xq, xs = quantize_q8_act(x2, w.group_size)
        y = group_dot(xq, xs, w.q, w.s, w.group_size)
    elif w.qtype == QuantType.Q4_0:
        xq, xs = quantize_q4_act(x2, w.group_size)
        y = group_dot(xq, xs, unpack_q4(w.q, w.group_size), w.s,
                      w.group_size)
    else:
        raise ValueError(w.qtype)
    return y.reshape(*lead, w.out_features)
