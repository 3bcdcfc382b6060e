"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Each wrapper launches its kernel for CUDA tensors, or raises; for CPU
tensors it runs the kernel's plain PyTorch version, which sits in the same
module.  Each wrapper counts its kernel launches in `<wrapper>.launches`.
"""

from __future__ import annotations

from typing import Dict

from lmrs_tpu_torch.kernels.ffn_fused import ffn_fused, ffn_fused_xe
from lmrs_tpu_torch.kernels.flash_attention import flash_attention
from lmrs_tpu_torch.kernels.flash_attention_batched import \
    flash_attention_batched
from lmrs_tpu_torch.kernels.flash_attention_i4 import flash_attention_i4
from lmrs_tpu_torch.kernels.flash_attention_i8 import flash_attention_i8
from lmrs_tpu_torch.kernels.flash_attention_paged import flash_attention_paged
from lmrs_tpu_torch.kernels.flash_merge import flash_merge
from lmrs_tpu_torch.kernels.q4_gemm import q4_gemm
from lmrs_tpu_torch.kernels.q4_gemv import q4_gemv
from lmrs_tpu_torch.kernels.q8_gemm import q8_gemm
from lmrs_tpu_torch.kernels.q8_gemv import q8_gemv
from lmrs_tpu_torch.kernels.q8_gemv_i8 import q8_gemv_i8

WRAPPERS = {"q4_gemv": q4_gemv, "q4_gemm": q4_gemm,
            "flash_attention": flash_attention, "q8_gemv_i8": q8_gemv_i8,
            "q8_gemv": q8_gemv, "q8_gemm": q8_gemm,
            "flash_attention_i8": flash_attention_i8,
            "flash_attention_i4": flash_attention_i4,
            "flash_attention_batched": flash_attention_batched,
            "flash_attention_paged": flash_attention_paged,
            "ffn_fused_xe": ffn_fused_xe, "ffn_fused": ffn_fused,
            "flash_merge": flash_merge}


def reset_launches() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    flash_attention_batched.lse_launches = 0


def launches() -> Dict[str, int]:
    """Each wrapper's launches, and B1's (kernel I's launches in the cp
    partials form, also counted in I's) as "flash_attention_batched_lse"."""
    counts = {name: fn.launches for name, fn in WRAPPERS.items()}
    counts["flash_attention_batched_lse"] = \
        flash_attention_batched.lse_launches
    return counts
