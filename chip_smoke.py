#!/usr/bin/env python3
"""On-card smoke run of lmrs_tpu_torch: the quickest proof that the port
builds and serves on an NVIDIA Hopper GPU.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases (any failure ends the run with a non-zero exit):
1. The card (`nvidia-smi` name and power limit), torch and CUDA versions;
   build the CUDA kernels from lmrs_tpu_torch/csrc.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   its main path gives it, with CUDA-event timings (median of 50 launches
   after warm-up, L2 flushed before each, as a decode step finds the
   weights): kernel, plain version, one PyTorch library call computing the
   same function (timed only, never used by the port), and the bound (the
   larger of bytes / memory rate and operations / peak rate).  A (q4_gemv),
   B (q4_gemm), C (flash_attention, bf16 cache) and H (flash_attention_i4,
   half packing) at the Gemma-2-9B shapes; D (q8_gemv_i8, its quantizer
   pre-pass bit for bit first), E (q8_gemv), F (q8_gemm), C on a bf16 and
   on an f32 cache, G (flash_attention_i8) and H (pair packing) at the
   Llama-3.2-3B shapes.  The T <= 8 matmul kernels run at T 1, 4 and 5 and
   the flash kernels at T 1, 5 and 256: T = 5 is a speculative verify
   window of k = 4.  Then, per kernel, whether a row of a T = 5 call
   equals the same row computed alone (what makes speculative greedy
   decoding exact).
3. The Q4_0 main path at full width and depth: a synthetic Gemma-2-9B Q4_0
   .lmrs (seed 0) written with the port's own writer, loaded with
   params_from_lmrs onto the card, Engine.generate greedy on a 1,024-token
   prompt (256-token chunks) for 64 new tokens twice across reset()
   (identical tokens), then one top-p generation; A, B and C, and no other
   kernel, must have launched.  The same with the int4 KV cache (A, B and
   H), then speculative greedy decoding (k = 4) on that engine against its
   plain greedy tokens.  Then the chat CLI in a subprocess on the same
   file with a synthetic tokenizer; the launch counts it prints
   (--show-metrics) must show the same kernels.
4. The Q8_0 main path at full width and depth: a synthetic Llama-3.2-3B
   Q8_0 .lmrs (seed 0), the same three generations with the bf16 KV cache
   (D, E, F and C must have launched), with the int8 KV cache (D, E, F and
   G) and with the int4 KV cache (D, E, F and H), the launch counts set to
   0 just before each and read just after.  On the int4 engine then:
   speculative greedy (k = 4, equal to the plain greedy tokens up to a
   near-tie, drafts both accepted and rejected), speculative top-p, and a
   session saved after the prompt and 16 tokens, loaded into a fresh
   Engine and continued for 16 tokens as the uninterrupted engine
   continues.  One greedy run on an f32 cache, whose tokens are the bf16
   path's.  Then the chat CLI with --cache-dtype int8, and with
   --cache-dtype int4 --spec-k 4.
5. One JSON line of per-kernel results, the card's name and power limit,
   and the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

GS = 128
# the two models' geometry: dim, hidden, layers, heads, kv heads, head_dim,
# vocabulary, sliding window, attention softcap
GEMMA = dict(name="gemma2-9b", D=3584, HID=14336, L=42, H=16, KH=8, HD=256,
             V=256000, WINDOW=4096, SOFTCAP=50.0)
LLAMA = dict(name="llama3.2-3b", D=3072, HID=8192, L=28, H=24, KH=8, HD=128,
             V=128256, WINDOW=None, SOFTCAP=None)
LAYER_SHAPES = ("wqkv", "wo", "w13", "w2")


def matmul_shapes(m):
    """name -> (out_features, in_features) of a model's five matmuls."""
    return {"wqkv": ((m["H"] + 2 * m["KH"]) * m["HD"], m["D"]),
            "wo": (m["D"], m["H"] * m["HD"]),
            "w13": (2 * m["HID"], m["D"]),
            "w2": (m["D"], m["HID"]),
            "classifier": (m["V"], m["D"])}


# Data-sheet peaks (dense) by torch.cuda.get_device_name: memory bytes/s and
# operations/s by operand type.  Add a card when a run uses it.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(mem=3.35e12, bf16=989e12, f32=67e12,
                                  int8=1979e12),            # H100 SXM
}

REPLACES = {
    "q4_gemv": "lmrs_tpu/kernels/vpu_matvec.py:238 _vm_q4_kernel; "
               "lmrs_tpu/kernels/vpu_matvec.py:284 _xe_q4_km_kernel; "
               "lmrs_tpu/kernels/dequant_matmul.py:478 _q4_xe_stacked_kernel; "
               "lmrs_tpu/kernels/dequant_matmul.py:279 _q4_xe_kernel",
    "q4_gemm": "lmrs_tpu/kernels/dequant_matmul.py:542 _q4_se_stacked_kernel; "
               "lmrs_tpu/kernels/vpu_matvec.py:318 _se_q4_km_kernel",
    "flash_attention": "lmrs_tpu/kernels/flash_attention.py:140 "
                       "_flash_kernel (bf16 cache)",
    "q8_gemv_i8": "lmrs_tpu/kernels/dequant_matmul.py:507 "
                  "_q8_xei8_stacked_kernel; "
                  "lmrs_tpu/kernels/vpu_matvec.py:266 _xe_i8_km_kernel",
    "q8_gemv": "lmrs_tpu/kernels/vpu_matvec.py:218 _vm_q8_kernel; "
               "lmrs_tpu/kernels/dequant_matmul.py:459 _q8_xe_stacked_kernel; "
               "lmrs_tpu/kernels/dequant_matmul.py:243 _q8_xe_kernel",
    "q8_gemm": "lmrs_tpu/kernels/dequant_matmul.py:531 _q8_se_stacked_kernel; "
               "lmrs_tpu/kernels/vpu_matvec.py:306 _se_q8_km_kernel",
    "flash_attention_i8": "lmrs_tpu/kernels/flash_attention.py:140 "
                          "_flash_kernel (int8 cache, quantized=True; "
                          "_head_block_update :76)",
    "flash_attention_i4": "lmrs_tpu/kernels/flash_attention.py:140 "
                          "_flash_kernel (int4 cache, packed4=True, half "
                          "and pair; _head_block_update :76)",
    "flash_attention_f32": "lmrs_tpu/kernels/flash_attention.py:140 "
                           "_flash_kernel (f32 cache, rounded to bf16 on "
                           "load; _head_block_update :110)",
}
SOURCES = {name: f"lmrs_tpu_torch/csrc/{name}.cu" for name in REPLACES}
for _name in ("flash_attention_i8", "flash_attention_i4",
              "flash_attention_f32"):
    SOURCES[_name] = SOURCES["flash_attention"]             # one template
# kernel C's f32 instantiation shares C's wrapper and launch count: its
# launches are those of the path that runs an f32 cache
COUNTER = {"flash_attention_f32": "flash_attention"}
Q4_PATH = {"q4_gemv", "q4_gemm", "flash_attention"}
Q4_I4_PATH = {"q4_gemv", "q4_gemm", "flash_attention_i4"}
Q8_PATH = {"q8_gemv_i8", "q8_gemv", "q8_gemm", "flash_attention"}
Q8_I8_PATH = {"q8_gemv_i8", "q8_gemv", "q8_gemm", "flash_attention_i8"}
Q8_I4_PATH = {"q8_gemv_i8", "q8_gemv", "q8_gemm", "flash_attention_i4"}
GEMV_T = (1, 4, 5)      # 5: a speculative verify window of k = 4


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """CUDA-event timing: median over `iters` launches after `warmup`, the
    L2 cache flushed before each launch (a 128 MB write)."""

    def __init__(self, torch, iters=50, warmup=5):
        self.torch = torch
        self.iters, self.warmup = iters, warmup
        self.flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        pairs = []
        for _ in range(self.iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound_ms(nbytes: float, flops: float, flop_rate: float, mem: float):
    t_bytes, t_ops = nbytes / mem, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def random_q4(torch, gen, o, k):
    """Random runtime-layout Q4 bytes and negative f32 scales of the
    synthetic writer's magnitude."""
    q = torch.randint(0, 256, (o, k // 2), dtype=torch.uint8, device="cuda",
                      generator=gen)
    s = -(0.02 / 7.5) * (0.5 + torch.rand((o, k // GS), device="cuda",
                                          generator=gen))
    return q, s


def random_q8(torch, gen, o, k):
    """Random int8 values in [-127, 127] and f32 scales of the synthetic
    writer's magnitude."""
    q = torch.randint(-127, 128, (o, k), dtype=torch.int8, device="cuda",
                      generator=gen)
    s = (0.02 / 127.0) * (0.5 + torch.rand((o, k // GS), device="cuda",
                                           generator=gen))
    return q, s


def check_act_quant(torch, gen):
    """Kernel D's quantizer pre-pass, bit for bit against
    quant.quantize_q8_act on the card and on the CPU, on inputs that hold
    the rounding traps: a group of scale exactly 1 with quotients on and
    next to .5 (0.49999997 + 0.5 rounds up to 1.0 in f32: trunc gives 1,
    roundf would give 0), an all-zero group, and a group whose
    largest-magnitude value is negative."""
    from lmrs_tpu_torch.kernels.q8_gemv_i8 import q8_act_quant
    from lmrs_tpu_torch.quant import quantize_q8_act

    for t in (1, 4):
        for k in (LLAMA["D"], LLAMA["HID"]):
            x = torch.randn(t, k, device="cuda", generator=gen)
            x[0, :GS] = 0.0
            x[0, :8] = torch.tensor([127.0, 2.5, -2.5, 0.5, -0.5, 63.5,
                                     0.49999997, -0.49999997], device="cuda")
            x[0, GS:2 * GS] = 0.0
            x[-1, 2 * GS:3 * GS].clamp_(-1, 1)
            x[-1, 2 * GS + 3] = -5.0
            xq, xs = q8_act_quant(x, GS)
            wq, ws = quantize_q8_act(x, GS)
            cq, cs = quantize_q8_act(x.cpu(), GS)
            torch.cuda.synchronize()
            same = (torch.equal(xq, wq) and torch.equal(xs, ws)
                    and torch.equal(xq.cpu(), cq)
                    and torch.equal(xs.cpu(), cs))
            traps = (xq[0, :8].tolist() == [127, 3, -3, 1, -1, 64, 1, -1]
                     and not xq[0, GS:2 * GS].any().item()
                     and xs[0, 1].item() == 0.0
                     and xq[-1, 2 * GS + 3].item() == -127)
            log(f"  q8_act_quant T={t} K={k}: bit-exact {same}, traps "
                f"{traps}")
            if not (same and traps):
                raise RuntimeError(f"q8_act_quant T={t} K={k} differs from "
                                   f"quant.quantize_q8_act")


def check_matmul_kernels(torch, timer, peak, model, quant):
    """The matmul kernels of one weight type against their plain versions
    at every shape of `model`'s main path; returns per-case results.
    "q4": A (all five shapes, T 1, 4 and 5) and B (layer shapes, T 9 and
    256).  "q8": D (layer shapes, T 1, 4 and 5), E (all five, the same T)
    and F (layer shapes, T 9 and 256)."""
    from lmrs_tpu_torch.kernels import q4_gemm, q4_gemv, q8_gemm, q8_gemv
    from lmrs_tpu_torch.kernels import q8_gemv_i8
    from lmrs_tpu_torch.kernels.q4_gemm import dequant_bf16 as dequant_q4
    from lmrs_tpu_torch.kernels.q4_gemm import q4_gemm_plain
    from lmrs_tpu_torch.kernels.q4_gemv import q4_gemv_plain
    from lmrs_tpu_torch.kernels.q8_gemm import dequant_bf16 as dequant_q8
    from lmrs_tpu_torch.kernels.q8_gemm import q8_gemm_plain
    from lmrs_tpu_torch.kernels.q8_gemv import q8_gemv_plain
    from lmrs_tpu_torch.kernels.q8_gemv_i8 import q8_gemv_i8_plain

    # kernel -> (wrapper, plain version, tolerance relative to the output
    # scale, bytes per activation value, peak rate of its operations).
    # GEMVs: f32 both sides (D's integer dots are exact), sums in another
    # order: 1e-4.  GEMMs: the same bf16 operands, tensor-core f32
    # accumulation in another order over K up to 14336: 1e-3.
    kernels = {
        "q4_gemv": (q4_gemv, q4_gemv_plain, 1e-4, 4, "f32"),
        "q4_gemm": (q4_gemm, q4_gemm_plain, 1e-3, 2, "bf16"),
        "q8_gemv_i8": (q8_gemv_i8, q8_gemv_i8_plain, 1e-4, 4, "int8"),
        "q8_gemv": (q8_gemv, q8_gemv_plain, 1e-4, 4, "f32"),
        "q8_gemm": (q8_gemm, q8_gemm_plain, 1e-3, 2, "bf16"),
    }
    wbytes = 0.5 if quant == "q4" else 1.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for name, (o, k) in matmul_shapes(model).items():
        layer = name in LAYER_SHAPES
        if quant == "q4":
            q, s = random_q4(torch, gen, o, k)
            w_lib = dequant_q4(q, s, GS)        # library yardstick only
            plan = [("q4_gemv", t) for t in GEMV_T]
            plan += [("q4_gemm", t) for t in (9, 256)] if layer else []
        else:
            q, s = random_q8(torch, gen, o, k)
            w_lib = dequant_q8(q, s, GS)
            plan = [("q8_gemv_i8", t) for t in GEMV_T] if layer else []
            plan += [("q8_gemv", t) for t in GEMV_T]
            plan += [("q8_gemm", t) for t in (9, 256)] if layer else []
        for kern, t in plan:
            fn, plain_fn, tol_rel, xbytes, rate = kernels[kern]
            x = torch.randn(t, k, device="cuda", generator=gen)
            if xbytes == 2:
                x = x.to(torch.bfloat16)
            run = lambda: fn(x, q, s, GS)                 # noqa: E731
            plain = lambda: plain_fn(x, q, s, GS)         # noqa: E731
            got, want = run(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{kern} {name} T={t}: non-finite output")
            err = (got - want).abs().max().item()
            tol = tol_rel * want.abs().max().item()
            xl = x.to(torch.bfloat16)
            lib = lambda: torch.matmul(xl, w_lib.t())   # noqa: E731
            nbytes = (wbytes * o * k + 4 * o * k / GS + xbytes * t * k
                      + 4 * t * o)
            b_ms, b_by = bound_ms(nbytes, 2.0 * t * o * k, peak[rate],
                                  peak["mem"])
            case = dict(kernel=kern, model=model["name"], shape=name, T=t,
                        O=o, K=k, max_abs_err=err, tol=tol,
                        err_over_tol=err / tol, ms=timer(run),
                        plain_ms=timer(plain), library_ms=timer(lib),
                        bound_ms=b_ms, bound_by=b_by)
            extra = ""
            if kern == "q8_gemv_i8":
                # second yardstick: the library's int8 product, where the
                # installed PyTorch takes the shape (timed only)
                xi = torch.randint(-127, 128, (t, k), dtype=torch.int8,
                                   device="cuda", generator=gen)
                qt = q.t()
                try:
                    torch._int_mm(xi, qt)
                    case["int_mm_ms"] = timer(lambda: torch._int_mm(xi, qt))
                    extra = f"  _int_mm {case['int_mm_ms']:.4f}"
                except RuntimeError:
                    case["int_mm_ms"] = None
                    extra = "  _int_mm n/a"
            log(f"  {kern:10s} {name:10s} T={t:3d}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e})  kernel {case['ms']:.4f} ms  plain "
                f"{case['plain_ms']:.4f}  library {case['library_ms']:.4f}"
                f"{extra}  bound {b_ms:.4f} ({b_by})")
            if not err <= tol:
                raise RuntimeError(f"{kern} {name} T={t}: error {err} > {tol}")
            cases.append(case)
            del got, want
        del q, s, w_lib
        torch.cuda.empty_cache()
    return cases


def attention_work(t_q, pos, window):
    """(live key rows read, live (query, key) pairs per head) of one call:
    what this call's data needs under the causal mask and the window."""
    if window is None:
        window = pos + t_q
    first = max(pos - window, 0)
    rows = pos + t_q - first
    pairs = sum(min(pos + t, window) + 1 for t in range(t_q))
    return rows, pairs


def flash_cache(torch, model, cache, S=8192):
    """Random K/V rows of `model`'s attention geometry as one layer of a
    `cache`-type KV cache ("bf16", "f32", "int8" or "int4"; seed 1).
    Returns (kernel name, (wrapper, plain version, bound function), cache
    tensors as the wrapper takes them, bf16 (S, KH, HD) K and V for the
    library yardstick, bytes per cached row of K and V together)."""
    from lmrs_tpu_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_plain,
                                                        flash_attention_tol)
    from lmrs_tpu_torch.kernels.flash_attention_i4 import (
        flash_attention_i4, flash_attention_i4_plain, flash_attention_i4_tol)
    from lmrs_tpu_torch.kernels.flash_attention_i8 import (
        flash_attention_i8, flash_attention_i8_plain, flash_attention_i8_tol)
    from lmrs_tpu_torch.quant import (quantize_kv_rows, quantize_kv_rows_q4,
                                      unpack_kv_q4)

    KH, HD = model["KH"], model["HD"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    kf = torch.randn(S, KH, HD, device="cuda", generator=gen)
    vf = torch.randn(S, KH, HD, device="cuda", generator=gen)
    if cache in ("int8", "int4"):
        quantize = quantize_kv_rows if cache == "int8" else quantize_kv_rows_q4
        rows, scales = quantize(torch.stack([kf, vf]))
        k, v = rows[0][None].contiguous(), rows[1][None].contiguous()
        ks, vs = (scales[i].t().contiguous()[None] for i in (0, 1))
        tensors = (k, v, ks, vs)
        # library yardstick reads the dequantized rows as bf16
        ints = ((k[0].reshape(S, KH, HD), v[0].reshape(S, KH, HD))
                if cache == "int8" else
                (unpack_kv_q4(k[0], KH, HD), unpack_kv_q4(v[0], KH, HD)))
        k_lib = (ints[0] * ks[0].t()[..., None]).to(torch.bfloat16)
        v_lib = (ints[1] * vs[0].t()[..., None]).to(torch.bfloat16)
        # K and V values (one or half a byte each) + scales
        row_bytes = 2 * (KH * HD // (1 if cache == "int8" else 2) + 4 * KH)
        if cache == "int8":
            return ("flash_attention_i8",
                    (flash_attention_i8, flash_attention_i8_plain,
                     flash_attention_i8_tol), tensors, k_lib, v_lib,
                    row_bytes)
        return ("flash_attention_i4",
                (flash_attention_i4, flash_attention_i4_plain,
                 flash_attention_i4_tol), tensors, k_lib, v_lib, row_bytes)
    dtype = torch.bfloat16 if cache == "bf16" else torch.float32
    k = kf.reshape(1, S, KH * HD).to(dtype)
    v = vf.reshape(1, S, KH * HD).to(dtype)
    return ("flash_attention" if cache == "bf16" else "flash_attention_f32",
            (flash_attention, flash_attention_plain, flash_attention_tol),
            (k, v), k[0].reshape(S, KH, HD).to(torch.bfloat16),
            v[0].reshape(S, KH, HD).to(torch.bfloat16),
            2 * KH * HD * (2 if cache == "bf16" else 4))


def check_flash_kernel(torch, timer, peak, model, cache):
    """Kernel C (bf16 or f32 cache), G (int8 cache) or H (int4 cache) at
    `model`'s attention geometry, S = 8,192, T 1, 5 and 256 at pos 1,100
    and 6,000, against its plain version with the per-element bound of its
    bound function (flash_attention_tol and its int8 / int4 forms)."""
    import torch.nn.functional as F

    H, KH, HD = model["H"], model["KH"], model["HD"]
    window, softcap = model["WINDOW"], model["SOFTCAP"]
    name, fns, tensors, k_lib, v_lib, row_bytes = flash_cache(torch, model,
                                                              cache)
    kernel_fn, plain_fn, tol_fn = fns
    gen = torch.Generator(device="cuda").manual_seed(2)
    kw = dict(n_kv=KH, scale=HD ** -0.5, softcap=softcap, window=window)
    cases = []
    for t_q in (1, 5, 256):
        for pos in (1100, 6000):
            q = torch.randn(t_q, H, HD, device="cuda", generator=gen)
            run = lambda: kernel_fn(q, *tensors, 0, pos, **kw)    # noqa: E731
            plain = lambda: plain_fn(q, *tensors, 0, pos, **kw)   # noqa: E731
            got, want = run(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{name} T={t_q} pos={pos}: non-finite")
            # per-element bound that follows the softmax weights (2^-7 +
            # 2^-9 of the plain version on |v|; see flash_attention_tol)
            tol = tol_fn(q, *tensors, 0, pos, **kw)
            diff = (got - want).abs()
            err, ratio = diff.max().item(), (diff / tol).max().item()
            # library yardstick: SDPA over the same live rows, no softcap
            n = pos + t_q
            first = 0 if window is None else max(pos - window, 0)
            qs = q.to(torch.bfloat16).transpose(0, 1)[None]
            ksd = k_lib[first:n].transpose(0, 1)[None]
            vsd = v_lib[first:n].transpose(0, 1)[None]
            qp = pos + torch.arange(t_q, device="cuda")[:, None]
            kp = first + torch.arange(n - first, device="cuda")[None, :]
            mask = kp <= qp
            if window is not None:
                mask = mask & (qp - kp <= window)
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                qs, ksd, vsd, attn_mask=mask, enable_gqa=True)
            rows_read, pairs = attention_work(t_q, pos, window)
            nbytes = rows_read * row_bytes + 2 * t_q * H * HD * 4
            flops = 4.0 * pairs * H * HD
            b_ms, b_by = bound_ms(nbytes, flops, peak["bf16"], peak["mem"])
            case = dict(kernel=name, model=model["name"], shape=f"pos{pos}",
                        T=t_q, max_abs_err=err, tol_min=tol.min().item(),
                        err_over_tol=ratio, ms=timer(run),
                        plain_ms=timer(plain), library_ms=timer(lib),
                        bound_ms=b_ms, bound_by=b_by,
                        blocks=((H // KH * t_q + 63) // 64) * KH)
            log(f"  {name:19s} pos={pos:5d} T={t_q:3d}: max_abs_err "
                f"{err:.3e} (worst err/tol {ratio:.3f}, tol >= "
                f"{case['tol_min']:.3e})  kernel {case['ms']:.4f} ms  "
                f"plain {case['plain_ms']:.4f}  library "
                f"{case['library_ms']:.4f}  bound {b_ms:.4f} ({b_by})  "
                f"blocks {case['blocks']}")
            if not ratio <= 1.0:
                raise RuntimeError(f"{name} T={t_q} pos={pos}: error {ratio} "
                                   f"of the tolerance")
            cases.append(case)
    return cases


def check_row_independence(torch):
    """Does a row of a T = 5 call equal, bit for bit, the same row computed
    alone (T = 1)?  Speculative greedy decoding is exact where every
    kernel of the verify forward says yes.  The T <= 8 matmul kernels on
    Llama-3.2-3B's wqkv shape (A on Gemma-2-9B's), the flash kernels at
    their models' geometry, pos 1,100.  Returns kernel -> bool; a "no" is
    a finding to record, not a failure."""
    from lmrs_tpu_torch.kernels import q4_gemv, q8_gemv, q8_gemv_i8

    gen = torch.Generator(device="cuda").manual_seed(3)
    same = {}
    for name, fn, make, model in (("q4_gemv", q4_gemv, random_q4, GEMMA),
                                  ("q8_gemv_i8", q8_gemv_i8, random_q8, LLAMA),
                                  ("q8_gemv", q8_gemv, random_q8, LLAMA)):
        o, k = matmul_shapes(model)["wqkv"]
        q, s = make(torch, gen, o, k)
        x = torch.randn(5, k, device="cuda", generator=gen)
        whole = fn(x, q, s, GS)
        rows = torch.cat([fn(x[i:i + 1].contiguous(), q, s, GS)
                          for i in range(5)])
        same[name] = torch.equal(whole, rows)
    pos = 1100
    for model, cache in ((GEMMA, "bf16"), (LLAMA, "f32"), (LLAMA, "int8"),
                         (GEMMA, "int4"), (LLAMA, "int4")):
        name, (fn, _, _), tensors, _, _, _ = flash_cache(torch, model, cache,
                                                         S=2048)
        kw = dict(n_kv=model["KH"], scale=model["HD"] ** -0.5,
                  softcap=model["SOFTCAP"], window=model["WINDOW"])
        q = torch.randn(5, model["H"], model["HD"], device="cuda",
                        generator=gen)
        whole = fn(q, *tensors, 0, pos, **kw)
        rows = torch.cat([fn(q[i:i + 1].contiguous(), *tensors, 0, pos + i,
                             **kw) for i in range(5)])
        same[f"{name} ({model['name']})"] = torch.equal(whole, rows)
    torch.cuda.synchronize()
    for name, ok in same.items():
        log(f"  {name}: row of T=5 {'equals' if ok else 'DIFFERS from'} "
            f"the row alone")
    return same


def synthetic_tokenizer(path: Path, vocab_size: int):
    from lmrs_tpu_torch.tokenizer import Tokenizer

    vocab = ["<pad>", "<eos>", "<bos>"] + [f"<0x{b:02X}>" for b in range(256)]
    words = ["hello", " from", " the", " smoke", " run", " card"]
    vocab += words
    vocab += [f"<tok{i}>" for i in range(vocab_size - len(vocab))]
    scores = [0.0] * vocab_size
    for i, w in enumerate(words):
        scores[259 + i] = 1.0
    Tokenizer(vocab, scores, bos=2, eos=1).save(str(path))


def drive_main_path(torch, label, cfg, params, cache_dtype, expect):
    """One main path: Engine.generate greedy on a 1,024-token prompt for 64
    new tokens twice across reset() (identical tokens), then one top-p
    generation, with the launch counts set to 0 just before and read just
    after.  Exactly the kernels of `expect` must have launched.  Returns
    (the launch counts and the runs' metrics, the engine, the prompt, the
    greedy tokens)."""
    from lmrs_tpu_torch.kernels import launches, reset_launches
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

    vocab = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(cfg, params, cache_dtype=cache_dtype)
    rng = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, vocab, (1024,), generator=rng).tolist()
    greedy = GenerationConfig(temperature=0.0, max_new_tokens=64)
    reset_launches()
    runs = []
    toks_a = engine.generate(prompt, greedy)
    runs.append(("greedy", engine.metrics))
    engine.reset()
    toks_b = engine.generate(prompt, greedy)
    runs.append(("greedy again", engine.metrics))
    engine.reset()
    toks_p = engine.generate(prompt, GenerationConfig(
        temperature=0.7, top_p=0.9, seed=0, max_new_tokens=64))
    runs.append(("top-p", engine.metrics))
    torch.cuda.synchronize()
    counts = launches()
    if toks_a != toks_b:
        raise RuntimeError(f"{label}: greedy generation differs across "
                           f"reset()")
    if len(toks_a) != 64 or len(toks_p) != 64 or not all(
            0 <= t < vocab for t in toks_a + toks_p):
        raise RuntimeError(f"{label}: invalid generated tokens")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {label}: peak memory {peak_gb:.2f} GB, launches {counts}")
    for name, m in runs:
        log(f"    {name}: TTFT {1e3 * m.ttft_seconds:.1f} ms, prefill "
            f"{m.prefill_tokens_per_second:.1f} tok/s, decode "
            f"{m.tokens_per_second:.2f} tok/s ({m.decode_tokens} tokens)")
    log(f"    greedy tokens {toks_a[:12]}... top-p {toks_p[:12]}...")
    launched = {k for k, n in counts.items() if n > 0}
    if launched != expect:
        raise RuntimeError(f"{label}: kernels launched {sorted(launched)}, "
                           f"expected {sorted(expect)}")
    result = dict(peak_memory_gb=peak_gb, launches=counts,
                  runs={name: dict(ttft_ms=1e3 * m.ttft_seconds,
                                   prefill_tok_s=m.prefill_tokens_per_second,
                                   decode_tok_s=m.tokens_per_second)
                        for name, m in runs})
    return result, engine, prompt, toks_a


def greedy_margins(torch, engine, prompt, n):
    """Plain greedy decoding step by step: (tokens, top-2 logit margin of
    every step over the largest |logit| of that step)."""
    engine.reset()
    logits = engine.prefill(prompt)
    toks, margins = [], []
    for _ in range(n):
        top = torch.topk(logits, 2)
        toks.append(int(top.indices[0]))
        margins.append(float(top.values[0] - top.values[1])
                       / float(logits.abs().max()))
        logits = engine.decode_step(toks[-1])
    return toks, margins


NEAR_TIE = 1e-3     # of the logit scale


def drive_speculative(torch, label, engine, prompt, plain, expect, k=4):
    """Speculative decoding on `engine` (its own path: the launch counts
    are set to 0 just before and read just after).  Greedy, k drafts per
    verify step, as many tokens as `plain`, the engine's plain greedy
    tokens: equal, or equal up to the first step whose top-2 margin in a
    plain run is below NEAR_TIE of the logit scale (a verify window runs
    the kernels at T = k+1, which may sum in another order than T = 1).
    Drafts must have been both accepted and rejected.  Then two sampled
    runs through the rejection sampler.  Top-p (temperature 0.7, top-p
    0.9, seed 0): random weights give it a nearly flat distribution, so
    its drafts are rejected (at least one must be) and every token is a
    resample.  A nucleus of one token (temperature 1.5, top-p 1e-6), whose
    distribution is one-hot on the argmax: the sampler then accepts what
    greedy verification accepts, resamples the argmax where it rejects,
    and must emit the speculative greedy tokens, with drafts both accepted
    and rejected.  Returns launch counts and metrics."""
    from lmrs_tpu_torch.kernels import launches, reset_launches
    from lmrs_tpu_torch.runtime.engine import GenerationConfig

    n = len(plain)
    reset_launches()
    engine.reset()
    toks = engine.generate(prompt, GenerationConfig(
        temperature=0.0, max_new_tokens=n, speculative_k=k))
    mg = engine.metrics
    engine.reset()
    toks_p = engine.generate(prompt, GenerationConfig(
        temperature=0.7, top_p=0.9, seed=0, max_new_tokens=n,
        speculative_k=k))
    mp = engine.metrics
    engine.reset()
    toks_1 = engine.generate(prompt, GenerationConfig(
        temperature=1.5, top_p=1e-6, seed=0, max_new_tokens=n,
        speculative_k=k))
    m1 = engine.metrics
    torch.cuda.synchronize()
    counts = launches()
    n_eq = n
    if toks != plain:
        _, margins = greedy_margins(torch, engine, prompt, n)
        close = [i for i, m in enumerate(margins) if m < NEAR_TIE]
        n_eq = close[0] if close else n
        log(f"  {label}: speculative greedy leaves plain greedy at step "
            f"{[a == b for a, b in zip(toks, plain)].index(False)}; first "
            f"near-tie of the plain run at step {n_eq}")
    if len(toks) != n or toks[:n_eq] != plain[:n_eq]:
        raise RuntimeError(f"{label}: speculative greedy tokens {toks} "
                           f"differ from plain greedy tokens {plain} before "
                           f"a near-tie (step {n_eq})")
    vocab = engine.cfg.vocab_size
    if len(toks_p) != n or not all(0 <= t < vocab for t in toks_p):
        raise RuntimeError(f"{label}: invalid speculative top-p tokens")
    out = {}
    if toks_1[:n_eq] != toks[:n_eq]:
        raise RuntimeError(f"{label}: the one-token nucleus emits {toks_1}, "
                           f"speculative greedy {toks}")
    for name, m in (("speculative greedy", mg), ("speculative top-p", mp),
                    ("speculative one-token nucleus", m1)):
        steps = m.spec_proposed // k
        out[name] = dict(
            decode_tok_s=m.tokens_per_second, verify_steps=steps,
            tokens_per_step=m.decode_tokens / steps,
            proposed=m.spec_proposed, accepted=m.spec_accepted,
            acceptance=m.spec_accepted / m.spec_proposed)
        log(f"    {label}, {name} k={k}: decode {m.tokens_per_second:.2f} "
            f"tok/s, {m.decode_tokens} tokens in {steps} verify steps "
            f"({m.decode_tokens / steps:.2f} per step), "
            f"{m.spec_accepted}/{m.spec_proposed} drafts accepted "
            f"({100 * m.spec_accepted / m.spec_proposed:.1f}%)")
    log(f"    launches {counts}; top-p tokens {toks_p[:12]}...")
    for name, m in (("greedy", mg), ("one-token nucleus", m1)):
        if not 0 < m.spec_accepted < m.spec_proposed:
            raise RuntimeError(f"{label}: speculative {name} accepted "
                               f"{m.spec_accepted} of {m.spec_proposed} "
                               f"drafts: both branches must run")
    # a rejected draft sends the top-p run through the resample from the
    # zeroed row; the random prompt's first drafts are rejected for sure
    if not (mp.spec_proposed > 0 and mp.spec_accepted < mp.spec_proposed):
        raise RuntimeError(f"{label}: speculative top-p accepted "
                           f"{mp.spec_accepted} of {mp.spec_proposed} "
                           f"drafts: the rejection branch must run")
    launched = {name for name, c in counts.items() if c > 0}
    if launched != expect:
        raise RuntimeError(f"{label}: kernels launched {sorted(launched)}, "
                           f"expected {sorted(expect)}")
    return dict(launches=counts, runs=out)


def drive_session(torch, label, work, cfg, params, cache_dtype, prompt):
    """save_session after the prompt and 16 greedy tokens, load_session
    into a fresh Engine, a second turn of 16 tokens: equal to the second
    turn of the engine that was never interrupted."""
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

    gen = GenerationConfig(temperature=0.0, max_new_tokens=16)
    first = Engine(cfg, params, cache_dtype=cache_dtype)
    first.generate(prompt, gen)
    saved_pos = first.pos
    path = work / "session.npz"
    t0 = time.perf_counter()
    first.save_session(str(path))
    save_s = time.perf_counter() - t0
    second = Engine(cfg, params, cache_dtype=cache_dtype)
    t0 = time.perf_counter()
    second.load_session(str(path))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    size_mb = path.stat().st_size / 1e6
    path.unlink()
    turn = prompt[:8]
    want = first.generate(turn, gen)
    got = second.generate(turn, gen)
    log(f"  {label}: session of {size_mb:.0f} MB saved in {save_s:.2f} s, "
        f"loaded in {load_s:.2f} s at pos {saved_pos}; "
        f"second turn {got[:8]}...")
    if got != want or second.pos != first.pos:
        raise RuntimeError(f"{label}: the resumed session continues "
                           f"{got}, the uninterrupted engine {want}")
    return dict(session_mb=size_mb, save_s=save_s, load_s=load_s)


def drive_cli(label, model, tok_path, expect, extra_args=()):
    """The chat CLI in a subprocess: one prompt, 16 greedy tokens; the
    launch counts it prints must show exactly the kernels of `expect`."""
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "lmrs_tpu_torch.cli.chat", "--model",
         str(model), "--tokenizer", str(tok_path), "--temperature", "0",
         "--max-new-tokens", "16", "--show-metrics", *extra_args],
        input="hello from the smoke run\n", capture_output=True,
        text=True, timeout=600, cwd=str(HERE),
        env=dict(os.environ, PYTHONPATH=str(HERE)))
    if cli.returncode != 0:
        raise RuntimeError(f"{label}: chat CLI exit {cli.returncode}:\n"
                           f"{cli.stderr[-4000:]}")
    lines = cli.stdout.splitlines()
    at = [i for i, ln in enumerate(lines) if ln.endswith("Assistant:")]
    reply = lines[at[0] + 1] if at and at[0] + 1 < len(lines) else ""
    if not reply.strip():
        raise RuntimeError(f"{label}: chat CLI printed no reply:\n"
                           f"{cli.stdout}")
    counted = [ln for ln in lines if ln.startswith("Kernel launches")]
    if not counted:
        raise RuntimeError(f"{label}: chat CLI printed no launch counts:\n"
                           f"{cli.stdout}")
    counts = json.loads(counted[-1].split(":", 1)[1])
    log(f"  {label}: CLI exit 0 in {time.perf_counter() - t0:.1f} s; reply "
        f"{reply[:80]!r}; {[ln for ln in lines if 'Speed' in ln]}; "
        f"launches {counts}")
    launched = {k for k, n in counts.items() if n > 0}
    if launched != expect:
        raise RuntimeError(f"{label}: kernels launched on the CLI path "
                           f"{sorted(launched)}, expected {sorted(expect)}")
    return counts


def load_model(torch, work: Path, cfg):
    """Write the synthetic .lmrs of `cfg` (seed 0) and load it onto the
    card; returns (path, config as read, params, load seconds)."""
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import params_from_lmrs
    from lmrs_tpu_torch.io.synthetic import write_synthetic_lmrs

    path = work / "model.lmrs"
    t0 = time.perf_counter()
    write_synthetic_lmrs(str(path), cfg, seed=0)
    log(f"  wrote {path.stat().st_size / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    f = read_lmrs(str(path))
    params = params_from_lmrs(f, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"  loaded in {load_s:.2f} s")
    return path, f.cfg, params, load_s


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (HERE / "lmrs_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    t_run = time.perf_counter()

    # ---- 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    card_line = smi.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    if kind not in PEAKS:
        raise RuntimeError(f"no data-sheet peaks for {kind!r}: add them to "
                           f"PEAKS to compute the bounds")
    peak = PEAKS[kind]
    log(f"card: {card_line}  (peaks used: {kind} data sheet, "
        f"{peak['mem'] / 1e12:.2f} TB/s, {peak['bf16'] / 1e12:.0f} TFLOP/s "
        f"bf16, {peak['f32'] / 1e12:.0f} TFLOP/s f32, "
        f"{peak['int8'] / 1e12:.0f} TOP/s int8)")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    from lmrs_tpu_torch.kernels import cuda

    t0 = time.perf_counter()
    build = cuda.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s into {build}")
    for name in cuda.SOURCES:
        regs = [ln.strip() for ln in (build / f"{name}.log").read_text()
                .splitlines() if "registers" in ln]
        log(f"  {name}: {regs[0] if regs else 'built earlier'}")

    # ---- 2. kernels against their plain versions
    timer = Timer(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("phase 2: kernels vs plain versions at Gemma-2-9B shapes (A, B, C)")
    cases = check_matmul_kernels(torch, timer, peak, GEMMA, "q4")
    cases += check_flash_kernel(torch, timer, peak, GEMMA, "bf16")
    cases += check_flash_kernel(torch, timer, peak, GEMMA, "int4")
    log("phase 2: kernels vs plain versions at Llama-3.2-3B shapes "
        "(D, E, F, C, C on f32, G, H)")
    check_act_quant(torch, torch.Generator(device="cuda").manual_seed(2))
    cases += check_matmul_kernels(torch, timer, peak, LLAMA, "q8")
    for cache in ("bf16", "f32", "int8", "int4"):
        cases += check_flash_kernel(torch, timer, peak, LLAMA, cache)
    log("phase 2: is a row of a T=5 call the row computed alone?")
    row_independent = check_row_independence(torch)
    del timer
    torch.cuda.empty_cache()

    (HERE / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=str(HERE /
                                                              "build")))
    try:
        from lmrs_tpu_torch.config import QuantType, gemma2_9b, llama32_3b

        # ---- 3. the Q4_0 main path at full width and depth, bf16 then
        # int4 KV cache (plain, then speculative), and its CLI
        log("phase 3: Gemma-2-9B Q4_0 main path")
        model, cfg, params, load_s = load_model(
            torch, work, gemma2_9b(quant=QuantType.Q4_0))
        paths = {}
        label = "gemma2-9b Q4_0 bf16 cache"
        res, engine, prompt, plain = drive_main_path(
            torch, label, cfg, params, torch.bfloat16, Q4_PATH)
        paths[label] = dict(load_s=load_s, **res)
        del engine
        torch.cuda.empty_cache()
        label = "gemma2-9b Q4_0 int4 cache"
        res, engine, prompt, plain = drive_main_path(
            torch, label, cfg, params, "int4", Q4_I4_PATH)
        paths[label] = dict(load_s=load_s, **res)
        paths[label + ", speculative"] = drive_speculative(
            torch, label, engine, prompt, plain, Q4_I4_PATH)
        del params, engine
        torch.cuda.empty_cache()
        tok_path = work / "tokenizer.bin"
        synthetic_tokenizer(tok_path, GEMMA["V"])
        cli_counts = {"gemma2-9b Q4_0 bf16 cache": drive_cli(
            "gemma2-9b Q4_0", model, tok_path, Q4_PATH)}
        model.unlink()

        # ---- 4. the Q8_0 main path, bf16, int8 and int4 KV cache; on the
        # int4 engine speculation and a session; an f32 cache; its CLI
        log("phase 4: Llama-3.2-3B Q8_0 main path")
        model, cfg, params, load_s = load_model(
            torch, work, llama32_3b(quant=QuantType.Q8_0))
        greedy = {}
        for what, cache_dtype, expect in (
                ("bf16", torch.bfloat16, Q8_PATH),
                ("int8", torch.int8, Q8_I8_PATH),
                ("int4", "int4", Q8_I4_PATH)):
            label = f"llama3.2-3b Q8_0 {what} cache"
            res, engine, prompt, greedy[what] = drive_main_path(
                torch, label, cfg, params, cache_dtype, expect)
            paths[label] = dict(load_s=load_s, **res)
            if what == "int4":
                paths[label + ", speculative"] = drive_speculative(
                    torch, label, engine, prompt, greedy[what], expect)
            del engine
            torch.cuda.empty_cache()
        paths["llama3.2-3b Q8_0 int4 cache"].update(drive_session(
            torch, "llama3.2-3b Q8_0 int4 cache", work, cfg, params, "int4",
            prompt))
        torch.cuda.empty_cache()
        # an f32 cache is rounded to bf16 as it is read: the bf16 path's
        # tokens, through kernel C's f32 instantiation
        from lmrs_tpu_torch.kernels import launches, reset_launches
        from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

        label = "llama3.2-3b Q8_0 f32 cache"
        torch.cuda.reset_peak_memory_stats()
        engine = Engine(cfg, params, cache_dtype=torch.float32)
        reset_launches()
        toks = engine.generate(prompt, GenerationConfig(
            temperature=0.0, max_new_tokens=64))
        torch.cuda.synchronize()
        counts, m = launches(), engine.metrics
        log(f"  {label}: peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, TTFT "
            f"{1e3 * m.ttft_seconds:.1f} ms, decode "
            f"{m.tokens_per_second:.2f} tok/s, launches {counts}")
        if toks != greedy["bf16"]:
            raise RuntimeError(f"{label}: greedy tokens {toks} differ from "
                               f"the bf16 cache's {greedy['bf16']}")
        if {n for n, c in counts.items() if c > 0} != Q8_PATH:
            raise RuntimeError(f"{label}: kernels launched {counts}")
        paths[label] = dict(
            launches=counts, f32_cache=True,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            runs={"greedy": dict(ttft_ms=1e3 * m.ttft_seconds,
                                 decode_tok_s=m.tokens_per_second)})
        del params, engine
        torch.cuda.empty_cache()
        synthetic_tokenizer(tok_path, LLAMA["V"])
        cli_counts["llama3.2-3b Q8_0 int8 cache"] = drive_cli(
            "llama3.2-3b Q8_0 --cache-dtype int8", model, tok_path,
            Q8_I8_PATH, ("--cache-dtype", "int8"))
        cli_counts["llama3.2-3b Q8_0 int4 cache, speculative"] = drive_cli(
            "llama3.2-3b Q8_0 --cache-dtype int4 --spec-k 4", model,
            tok_path, Q8_I4_PATH, ("--cache-dtype", "int4", "--spec-k", "4"))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 5. results: one unit of work per kernel, (model, shape, T, count)
    g, ll = GEMMA["name"], LLAMA["name"]
    unit = {
        "q4_gemv": ("gemma2-9b decode token: 42 x (wqkv, wo, w13, w2) + "
                    "classifier at T=1",
                    [(g, s, 1, GEMMA["L"]) for s in LAYER_SHAPES]
                    + [(g, "classifier", 1, 1)]),
        "q4_gemm": ("gemma2-9b prefill chunk: 42 x (wqkv, wo, w13, w2) at "
                    "T=256", [(g, s, 256, GEMMA["L"]) for s in LAYER_SHAPES]),
        "flash_attention": ("gemma2-9b decode token at pos 6000: 42 x T=1",
                            [(g, "pos6000", 1, GEMMA["L"])]),
        "q8_gemv_i8": ("llama3.2-3b decode token: 28 x (wqkv, wo, w13, w2) "
                       "at T=1",
                       [(ll, s, 1, LLAMA["L"]) for s in LAYER_SHAPES]),
        "q8_gemv": ("llama3.2-3b decode token: classifier at T=1",
                    [(ll, "classifier", 1, 1)]),
        "q8_gemm": ("llama3.2-3b prefill chunk: 28 x (wqkv, wo, w13, w2) at "
                    "T=256", [(ll, s, 256, LLAMA["L"]) for s in LAYER_SHAPES]),
        "flash_attention_i8": ("llama3.2-3b decode token at pos 6000: 28 x "
                               "T=1", [(ll, "pos6000", 1, LLAMA["L"])]),
        "flash_attention_i4": ("llama3.2-3b decode token at pos 6000: 28 x "
                               "T=1", [(ll, "pos6000", 1, LLAMA["L"])]),
        "flash_attention_f32": ("llama3.2-3b decode token at pos 6000: 28 x "
                                "T=1", [(ll, "pos6000", 1, LLAMA["L"])]),
    }

    def path_launches(name):
        """Launches of `name` over the main paths; C's two instantiations
        share a count, told apart by the path's cache type."""
        counter = COUNTER.get(name, name)
        return sum(p["launches"][counter] for p in paths.values()
                   if counter != "flash_attention"
                   or bool(p.get("f32_cache")) == (name in COUNTER))

    per_kernel = []
    for name in REPLACES:
        mine = [c for c in cases if c["kernel"] == name]
        what, plan = unit[name]
        pick = {(c["model"], c["shape"], c["T"]): c for c in mine}
        tot = {key: sum(n * pick[(m, s, t)][key] for m, s, t, n in plan)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        per_kernel.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name],
            launches=path_launches(name),
            cli_launches=sum(c.get(name, 0) for c in cli_counts.values()),
            max_abs_err=max(c["max_abs_err"] for c in mine),
            err_over_tol=max(c["err_over_tol"] for c in mine),
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by=pick[plan[0][:3]]["bound_by"],
            library_ms=tot["library_ms"], unit=what, cases=mine))
    log("rows of a T=5 call equal the rows alone: "
        + json.dumps(row_independent))
    log("main paths: " + json.dumps(paths))
    log(f"chip_smoke ran {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": per_kernel}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
