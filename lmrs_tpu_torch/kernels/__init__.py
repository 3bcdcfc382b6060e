"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Each wrapper launches its kernel for CUDA tensors, or raises; for CPU
tensors it runs the kernel's plain PyTorch version, which sits in the same
module.  Each wrapper counts its kernel launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

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


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add `times` x `counts` (wrapper -> launches) to the wrappers'
    counts: a CUDA graph's replay launches what the graph holds."""
    for name, n in counts.items():
        if name == "flash_attention_batched_lse":
            flash_attention_batched.lse_launches += times * n
        else:
            WRAPPERS[name].launches += times * n


def _qgemm(quant: int, n: int, epi: int) -> Optional[str]:
    # B and F store (epilogue 0); L is its GLU stage (1) and then its
    # down stage (2), one call
    return (("q4_gemm", "q8_gemm")[quant] if epi == 0 else
            "ffn_fused" if epi == 1 else None)


# device function -> the wrapper that counts its launches (or, given the
# function's template arguments, the wrapper or None)
_WRAPPER_OF = {
    "q4_gemv_mma_kernel": "q4_gemv", "q8_gemv_kernel": "q8_gemv",
    "q8_gemv_i8_kernel": "q8_gemv_i8", "flash_merge_kernel": "flash_merge",
    "qgemm_kernel": _qgemm,
    # K: its GLU stage (S 0) and then its down stage, one call
    "ffn_xe_kernel": lambda q, w, s: "ffn_fused_xe" if s == 0 else None}


def graph_launches(kernels: Dict[str, int],
                   attention: str) -> Dict[str, int]:
    """The wrappers' launches in a CUDA graph whose kernel nodes are
    `kernels` (demangled function name -> nodes, `cuda.graph_kernels`),
    counted as the wrappers count them: a call of K or L once, torch's own
    kernels not at all.  `attention` is the wrapper whose launches the
    flash template's split pass counts: that one kernel serves C, G, H, I
    and J, its walk chosen at run time."""
    out: Dict[str, int] = {}
    for kernel, n in kernels.items():
        m = re.search(r"(\w+)(?:<(.*)>)?\(", kernel)
        if m is None:
            continue
        base, targs = m.groups()
        wrapper = attention if base == "flash_kernel" else \
            _WRAPPER_OF.get(base)
        if callable(wrapper):
            wrapper = wrapper(*(int(a) for a in
                                re.findall(r"(-?\d+)(?=,|$)", targs)))
        if wrapper is not None:
            out[wrapper] = out.get(wrapper, 0) + n
    return out
