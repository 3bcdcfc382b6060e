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
   B (q4_gemm) and C (flash_attention) at the Gemma-2-9B shapes; D
   (q8_gemv_i8, its quantizer pre-pass bit for bit first), E (q8_gemv), F
   (q8_gemm), C and G (flash_attention_i8) at the Llama-3.2-3B shapes.
3. The Q4_0 main path at full width and depth: a synthetic Gemma-2-9B Q4_0
   .lmrs (seed 0) written with the port's own writer, loaded with
   params_from_lmrs onto the card, Engine.generate greedy on a 1,024-token
   prompt (256-token chunks) for 64 new tokens twice across reset()
   (identical tokens), then one top-p generation; A, B and C, and no other
   kernel, must have launched.  Then the chat CLI in a subprocess on the
   same file with a synthetic tokenizer; the launch counts it prints
   (--show-metrics) must show the same kernels.
4. The Q8_0 main path at full width and depth: a synthetic Llama-3.2-3B
   Q8_0 .lmrs (seed 0), the same three generations with the bf16 KV cache
   (D, E, F and C must have launched) and again with the int8 KV cache (D,
   E, F and G), the launch counts set to 0 just before each and read just
   after.  Then the chat CLI with --cache-dtype int8: D, E, F and G.
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
}
SOURCES = {name: f"lmrs_tpu_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["flash_attention_i8"] = SOURCES["flash_attention"]   # one template
Q4_PATH = {"q4_gemv", "q4_gemm", "flash_attention"}
Q8_PATH = {"q8_gemv_i8", "q8_gemv", "q8_gemm", "flash_attention"}
Q8_I8_PATH = {"q8_gemv_i8", "q8_gemv", "q8_gemm", "flash_attention_i8"}


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
    "q4": A (all five shapes, T 1 and 4) and B (layer shapes, T 9 and 256).
    "q8": D (layer shapes, T 1 and 4), E (all five, T 1 and 4) and F (layer
    shapes, T 9 and 256)."""
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
            plan = [("q4_gemv", t) for t in (1, 4)]
            plan += [("q4_gemm", t) for t in (9, 256)] if layer else []
        else:
            q, s = random_q8(torch, gen, o, k)
            w_lib = dequant_q8(q, s, GS)
            plan = [("q8_gemv_i8", t) for t in (1, 4)] if layer else []
            plan += [("q8_gemv", t) for t in (1, 4)]
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


def check_flash_kernel(torch, timer, peak, model, int8):
    """Kernel C (bf16 cache) or G (int8 cache) at `model`'s attention
    geometry, S = 8,192, T 1 and 256 at pos 1,100 and 6,000, against its
    plain version with the per-element bound of flash_attention_tol /
    flash_attention_i8_tol."""
    import torch.nn.functional as F

    from lmrs_tpu_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_plain,
                                                        flash_attention_tol)
    from lmrs_tpu_torch.kernels.flash_attention_i8 import (
        flash_attention_i8, flash_attention_i8_plain, flash_attention_i8_tol)
    from lmrs_tpu_torch.quant import quantize_kv_rows

    H, KH, HD = model["H"], model["KH"], model["HD"]
    window, softcap = model["WINDOW"], model["SOFTCAP"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    S = 8192
    kf = torch.randn(S, KH, HD, device="cuda", generator=gen)
    vf = torch.randn(S, KH, HD, device="cuda", generator=gen)
    if int8:
        name = "flash_attention_i8"
        rows, scales = quantize_kv_rows(torch.stack([kf, vf]))
        k, v = rows[0][None].contiguous(), rows[1][None].contiguous()
        ks, vs = (scales[i].t().contiguous()[None] for i in (0, 1))
        cache = (k, v, ks, vs)
        fns = (flash_attention_i8, flash_attention_i8_plain,
               flash_attention_i8_tol)
        # library yardstick reads the dequantized rows as bf16
        k_lib = (k[0].reshape(S, KH, HD) * ks[0].t()[..., None]).to(
            torch.bfloat16)
        v_lib = (v[0].reshape(S, KH, HD) * vs[0].t()[..., None]).to(
            torch.bfloat16)
        row_bytes = 2 * (KH * HD + 4 * KH)      # K and V values + scales
    else:
        name = "flash_attention"
        k = kf.reshape(1, S, KH * HD).to(torch.bfloat16)
        v = vf.reshape(1, S, KH * HD).to(torch.bfloat16)
        cache = (k, v)
        fns = (flash_attention, flash_attention_plain, flash_attention_tol)
        k_lib, v_lib = k[0].reshape(S, KH, HD), v[0].reshape(S, KH, HD)
        row_bytes = 2 * KH * HD * 2
    kernel_fn, plain_fn, tol_fn = fns
    kw = dict(n_kv=KH, scale=HD ** -0.5, softcap=softcap, window=window)
    cases = []
    for t_q in (1, 256):
        for pos in (1100, 6000):
            q = torch.randn(t_q, H, HD, device="cuda", generator=gen)
            run = lambda: kernel_fn(q, *cache, 0, pos, **kw)    # noqa: E731
            plain = lambda: plain_fn(q, *cache, 0, pos, **kw)   # noqa: E731
            got, want = run(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{name} T={t_q} pos={pos}: non-finite")
            # per-element bound that follows the softmax weights (2^-7 +
            # 2^-9 of the plain version on |v|; see flash_attention_tol)
            tol = tol_fn(q, *cache, 0, pos, **kw)
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
            log(f"  {name:18s} pos={pos:5d} T={t_q:3d}: max_abs_err "
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
    the launch counts and the runs' metrics."""
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
    return dict(peak_memory_gb=peak_gb, launches=counts,
                runs={name: dict(ttft_ms=1e3 * m.ttft_seconds,
                                 prefill_tok_s=m.prefill_tokens_per_second,
                                 decode_tok_s=m.tokens_per_second)
                      for name, m in runs})


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
    cases += check_flash_kernel(torch, timer, peak, GEMMA, int8=False)
    log("phase 2: kernels vs plain versions at Llama-3.2-3B shapes "
        "(D, E, F, C, G)")
    check_act_quant(torch, torch.Generator(device="cuda").manual_seed(2))
    cases += check_matmul_kernels(torch, timer, peak, LLAMA, "q8")
    cases += check_flash_kernel(torch, timer, peak, LLAMA, int8=False)
    cases += check_flash_kernel(torch, timer, peak, LLAMA, int8=True)
    del timer
    torch.cuda.empty_cache()

    (HERE / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=str(HERE /
                                                              "build")))
    try:
        from lmrs_tpu_torch.config import QuantType, gemma2_9b, llama32_3b

        # ---- 3. the Q4_0 main path at full width and depth, and its CLI
        log("phase 3: Gemma-2-9B Q4_0 main path")
        model, cfg, params, load_s = load_model(
            torch, work, gemma2_9b(quant=QuantType.Q4_0))
        paths = {"gemma2-9b Q4_0 bf16 cache": dict(
            load_s=load_s, **drive_main_path(
                torch, "gemma2-9b Q4_0, bf16 cache", cfg, params,
                torch.bfloat16, Q4_PATH))}
        del params
        torch.cuda.empty_cache()
        tok_path = work / "tokenizer.bin"
        synthetic_tokenizer(tok_path, GEMMA["V"])
        cli_counts = {"gemma2-9b Q4_0 bf16 cache": drive_cli(
            "gemma2-9b Q4_0", model, tok_path, Q4_PATH)}
        model.unlink()

        # ---- 4. the Q8_0 main path, bf16 then int8 KV cache, and its CLI
        log("phase 4: Llama-3.2-3B Q8_0 main path")
        model, cfg, params, load_s = load_model(
            torch, work, llama32_3b(quant=QuantType.Q8_0))
        for cache_dtype, expect in ((torch.bfloat16, Q8_PATH),
                                    (torch.int8, Q8_I8_PATH)):
            what = "int8" if cache_dtype == torch.int8 else "bf16"
            paths[f"llama3.2-3b Q8_0 {what} cache"] = dict(
                load_s=load_s, **drive_main_path(
                    torch, f"llama3.2-3b Q8_0, {what} cache", cfg, params,
                    cache_dtype, expect))
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
        synthetic_tokenizer(tok_path, LLAMA["V"])
        cli_counts["llama3.2-3b Q8_0 int8 cache"] = drive_cli(
            "llama3.2-3b Q8_0 --cache-dtype int8", model, tok_path,
            Q8_I8_PATH, ("--cache-dtype", "int8"))
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
    }
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
            launches=sum(p["launches"][name] for p in paths.values()),
            cli_launches=sum(c[name] for c in cli_counts.values()),
            max_abs_err=max(c["max_abs_err"] for c in mine),
            err_over_tol=max(c["err_over_tol"] for c in mine),
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by=pick[plan[0][:3]]["bound_by"],
            library_ms=tot["library_ms"], unit=what, cases=mine))
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
