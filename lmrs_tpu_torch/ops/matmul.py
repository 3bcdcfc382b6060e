"""Quantized matmul y = x . W^T, dispatched by the number of rows T.

    T <= 8        -> kernel A, q4_gemv (f32 activations)
    9 <= T <= 512 -> kernel B, q4_gemm (bf16 activations, bf16 dequantized
                     weights in shared memory)
    T > 512       -> dequantize to bf16 in device memory, then one f32
                     product of the bf16 operands (no quantized kernel:
                     the weights amortize over the rows; the JAX package
                     leaves this case to XLA in the same way)

Only Q4_0 weights run here; Q8_0 and float weights come with ROADMAP.md A7.
"""

from __future__ import annotations

import torch

from lmrs_tpu_torch.config import QuantType, unsupported
from lmrs_tpu_torch.kernels import cuda
from lmrs_tpu_torch.kernels.q4_gemm import MAX_T as GEMM_MAX_T
from lmrs_tpu_torch.kernels.q4_gemm import q4_gemm
from lmrs_tpu_torch.kernels.q4_gemv import MAX_T as GEMV_MAX_T
from lmrs_tpu_torch.kernels.q4_gemv import q4_gemv
from lmrs_tpu_torch.quant import QTensor, dequantize


def qmatmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """y = x @ W^T for a Q4_0 weight of logical shape (out, in); x float
    (..., in) -> float32 (..., out)."""
    if w.qtype != QuantType.Q4_0:
        raise unsupported(f"{w.qtype.name} weights", "A7 Q8_0 and float "
                          "weights")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    t = x2.shape[0]
    if t <= GEMV_MAX_T:
        y = q4_gemv(x2.float().contiguous(), w.q, w.s, w.group_size)
    elif t <= GEMM_MAX_T:
        y = q4_gemm(x2, w.q, w.s, w.group_size)
    else:
        if x2.is_cuda:
            cuda.plain_numerics()
        wd = dequantize(w).to(torch.bfloat16).float()
        y = x2.to(torch.bfloat16).float() @ wd.t()
    return y.reshape(*lead, w.out_features)
