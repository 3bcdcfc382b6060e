#!/usr/bin/env python3
"""On-card smoke run of lmrs_tpu_torch: the quickest proof that the port
builds and serves on an NVIDIA Hopper GPU.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases (any failure ends the run with a non-zero exit):
1. The card (`nvidia-smi` name and power limit), torch and CUDA versions;
   build the CUDA kernels from lmrs_tpu_torch/csrc.
2. Each kernel against its plain PyTorch version on the card, at the
   Gemma-2-9B shapes of the main path, with CUDA-event timings (median of
   50 launches after warm-up, L2 flushed before each, as a decode step finds
   the weights): kernel, plain version, one PyTorch library call computing
   the same function (timed only, never used by the port), and the bound
   (the larger of bytes / memory rate and operations / peak rate).
3. The main path at full width: a synthetic Gemma-2-9B Q4_0 .lmrs (seed 0)
   written with the port's own writer, loaded with params_from_lmrs onto
   the card, Engine.generate greedy on a 1,024-token prompt (256-token
   chunks) for 64 new tokens twice across reset() (identical tokens), then
   one top-p generation; every kernel must have launched.
4. The chat CLI in a subprocess on the same file with a 256,000-entry
   synthetic tokenizer; the launch counts it prints (--show-metrics) must
   show every kernel.
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

# Gemma-2-9B
D, HID, L, H, KH, HD, V, GS = 3584, 14336, 42, 16, 8, 256, 256000, 128
WINDOW, SOFTCAP = 4096, 50.0
MATMUL_SHAPES = {            # name -> (out_features, in_features)
    "wqkv": (H * HD + 2 * KH * HD, D),
    "wo": (D, H * HD),
    "w13": (2 * HID, D),
    "w2": (D, HID),
    "classifier": (V, D),
}
LAYER_SHAPES = ("wqkv", "wo", "w13", "w2")

# Data-sheet peaks (dense) by torch.cuda.get_device_name: memory bytes/s,
# bf16 tensor FLOP/s, f32 FLOP/s.  Add a card when a run uses it.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 989e12, 67e12),     # H100 SXM
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
}
SOURCES = {name: f"lmrs_tpu_torch/csrc/{name}.cu" for name in REPLACES}


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


def check_matmul_kernels(torch, timer, peak):
    """Kernels A and B against their plain versions at every main-path
    shape; returns per-case results."""
    from lmrs_tpu_torch.kernels.q4_gemm import (dequant_bf16, q4_gemm,
                                                q4_gemm_plain)
    from lmrs_tpu_torch.kernels.q4_gemv import q4_gemv, q4_gemv_plain

    mem, bf16_rate, f32_rate = peak
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for name, (o, k) in MATMUL_SHAPES.items():
        q, s = random_q4(torch, gen, o, k)
        w_lib = dequant_bf16(q, s, GS)          # library yardstick only
        plan = [("q4_gemv", t) for t in (1, 4)]
        if name in LAYER_SHAPES:
            plan += [("q4_gemm", t) for t in (9, 256)]
        for kern, t in plan:
            x = torch.randn(t, k, device="cuda", generator=gen)
            if kern == "q4_gemv":
                run = lambda: q4_gemv(x, q, s, GS)          # noqa: E731
                plain = lambda: q4_gemv_plain(x, q, s, GS)  # noqa: E731
                # f32 both sides, sums over K in another order
                tol_rel = 1e-4
                nbytes = o * k / 2 + 4 * o * k / GS + 4 * t * k + 4 * t * o
                rate = f32_rate
            else:
                xb = x.to(torch.bfloat16)
                run = lambda: q4_gemm(xb, q, s, GS)          # noqa: E731
                plain = lambda: q4_gemm_plain(xb, q, s, GS)  # noqa: E731
                # the same bf16 operands; tensor-core f32 accumulation in
                # another order over K up to 14336
                tol_rel = 1e-3
                nbytes = o * k / 2 + 4 * o * k / GS + 2 * t * k + 4 * t * o
                rate = bf16_rate
            got, want = run(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{kern} {name} T={t}: non-finite output")
            err = (got - want).abs().max().item()
            tol = tol_rel * want.abs().max().item()
            xl = x.to(torch.bfloat16)
            lib = lambda: torch.matmul(xl, w_lib.t())   # noqa: E731
            b_ms, b_by = bound_ms(nbytes, 2.0 * t * o * k, rate, mem)
            case = dict(kernel=kern, shape=name, T=t, O=o, K=k,
                        max_abs_err=err, tol=tol, err_over_tol=err / tol,
                        ms=timer(run),
                        plain_ms=timer(plain), library_ms=timer(lib),
                        bound_ms=b_ms, bound_by=b_by)
            log(f"  {kern:8s} {name:10s} T={t:3d}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e})  kernel {case['ms']:.4f} ms  plain "
                f"{case['plain_ms']:.4f}  library {case['library_ms']:.4f}  "
                f"bound {b_ms:.4f} ({b_by})")
            if not err <= tol:
                raise RuntimeError(f"{kern} {name} T={t}: error {err} > {tol}")
            cases.append(case)
            del got, want
        del q, s, w_lib
        torch.cuda.empty_cache()
    return cases


def attention_work(t_q, pos):
    """(live key rows read, live (query, key) pairs per head) of one call:
    what this call's data needs under the causal mask and the window."""
    first = max(pos - WINDOW, 0)
    rows = pos + t_q - first
    pairs = sum(min(pos + t, WINDOW) + 1 for t in range(t_q))
    return rows, pairs


def check_flash_kernel(torch, timer, peak):
    import torch.nn.functional as F

    from lmrs_tpu_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_plain,
                                                        flash_attention_tol)

    mem, bf16_rate, _ = peak
    gen = torch.Generator(device="cuda").manual_seed(1)
    S = 8192
    k = torch.randn(1, S, KH * HD, device="cuda", generator=gen).to(
        torch.bfloat16)
    v = torch.randn(1, S, KH * HD, device="cuda", generator=gen).to(
        torch.bfloat16)
    kw = dict(n_kv=KH, scale=HD ** -0.5, softcap=SOFTCAP, window=WINDOW)
    cases = []
    for t_q in (1, 256):
        for pos in (1100, 6000):
            q = torch.randn(t_q, H, HD, device="cuda", generator=gen)
            run = lambda: flash_attention(q, k, v, 0, pos, **kw)  # noqa
            plain = lambda: flash_attention_plain(q, k, v, 0, pos, **kw)  # noqa
            got, want = run(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"flash T={t_q} pos={pos}: non-finite")
            # per-element bound that follows the softmax weights (2^-7 +
            # 2^-9 of the plain version on |v|; see flash_attention_tol)
            tol = flash_attention_tol(q, k, v, 0, pos, **kw)
            diff = (got - want).abs()
            err, ratio = diff.max().item(), (diff / tol).max().item()
            # library yardstick: SDPA over the same live rows, no softcap
            first = max(pos - WINDOW, 0)
            n = pos + t_q
            qs = q.to(torch.bfloat16).transpose(0, 1)[None]
            ks = k[0, first:n].reshape(n - first, KH, HD).transpose(0, 1)[None]
            vs = v[0, first:n].reshape(n - first, KH, HD).transpose(0, 1)[None]
            qp = pos + torch.arange(t_q, device="cuda")[:, None]
            kp = first + torch.arange(n - first, device="cuda")[None, :]
            mask = (kp <= qp) & (qp - kp <= WINDOW)
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                qs, ks, vs, attn_mask=mask, enable_gqa=True)
            rows, pairs = attention_work(t_q, pos)
            nbytes = 2 * rows * KH * HD * 2 + 2 * t_q * H * HD * 4
            flops = 4.0 * pairs * H * HD
            b_ms, b_by = bound_ms(nbytes, flops, bf16_rate, mem)
            case = dict(kernel="flash_attention", shape=f"pos{pos}", T=t_q,
                        max_abs_err=err, tol_min=tol.min().item(),
                        err_over_tol=ratio, ms=timer(run),
                        plain_ms=timer(plain), library_ms=timer(lib),
                        bound_ms=b_ms, bound_by=b_by,
                        blocks=((2 * t_q + 63) // 64) * KH)
            log(f"  flash    pos={pos:5d}    T={t_q:3d}: max_abs_err "
                f"{err:.3e} (worst err/tol {ratio:.3f}, tol >= "
                f"{case['tol_min']:.3e})  kernel {case['ms']:.4f} ms  "
                f"plain {case['plain_ms']:.4f}  library "
                f"{case['library_ms']:.4f}  bound {b_ms:.4f} ({b_by})  "
                f"blocks {case['blocks']}")
            if not ratio <= 1.0:
                raise RuntimeError(f"flash T={t_q} pos={pos}: error {ratio} "
                                   f"of the tolerance")
            cases.append(case)
    return cases


def synthetic_tokenizer(path: Path):
    from lmrs_tpu_torch.tokenizer import Tokenizer

    vocab = ["<pad>", "<eos>", "<bos>"] + [f"<0x{b:02X}>" for b in range(256)]
    words = ["hello", " from", " the", " smoke", " run", " card"]
    vocab += words
    vocab += [f"<tok{i}>" for i in range(V - len(vocab))]
    scores = [0.0] * V
    for i, w in enumerate(words):
        scores[259 + i] = 1.0
    Tokenizer(vocab, scores, bos=2, eos=1).save(str(path))


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
        f"{peak[0] / 1e12:.2f} TB/s, {peak[1] / 1e12:.0f} TFLOP/s bf16, "
        f"{peak[2] / 1e12:.0f} TFLOP/s f32)")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    from lmrs_tpu_torch.kernels import cuda, launches, reset_launches

    t0 = time.perf_counter()
    build = cuda.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s into {build}")
    for name in cuda.SOURCES:
        regs = [ln.strip() for ln in (build / f"{name}.log").read_text()
                .splitlines() if "registers" in ln]
        log(f"  {name}: {regs[0] if regs else 'built earlier'}")

    # ---- 2. kernels against their plain versions
    timer = Timer(torch)
    log("phase 2: kernels vs plain versions at Gemma-2-9B shapes")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = check_matmul_kernels(torch, timer, peak)
    cases += check_flash_kernel(torch, timer, peak)
    del timer
    torch.cuda.empty_cache()

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=str(HERE /
                                                              "build")))
    try:
        # ---- 3. the main path at full width
        from lmrs_tpu_torch.config import gemma2_9b, QuantType
        from lmrs_tpu_torch.io.lmrs import read_lmrs
        from lmrs_tpu_torch.io.params import params_from_lmrs
        from lmrs_tpu_torch.io.synthetic import write_synthetic_lmrs
        from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

        log("phase 3: Gemma-2-9B Q4_0 main path")
        model = work / "gemma2-9b-q4.lmrs"
        t0 = time.perf_counter()
        write_synthetic_lmrs(str(model), gemma2_9b(quant=QuantType.Q4_0),
                             seed=0)
        log(f"  wrote {model.stat().st_size / 1e9:.2f} GB in "
            f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        f = read_lmrs(str(model))
        params = params_from_lmrs(f, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        engine = Engine(f.cfg, params)
        rng = torch.Generator().manual_seed(0)
        prompt = torch.randint(0, V, (1024,), generator=rng).tolist()
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
        main_launches = launches()
        if toks_a != toks_b:
            raise RuntimeError("greedy generation differs across reset()")
        if len(toks_a) != 64 or len(toks_p) != 64 or not all(
                0 <= t < V for t in toks_a + toks_p):
            raise RuntimeError("invalid generated tokens")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"  load {load_s:.2f} s, peak memory {peak_gb:.2f} GB, "
            f"launches on the main path {main_launches}")
        for label, m in runs:
            log(f"  {label}: TTFT {1e3 * m.ttft_seconds:.1f} ms, prefill "
                f"{m.prefill_tokens_per_second:.1f} tok/s, decode "
                f"{m.tokens_per_second:.2f} tok/s ({m.decode_tokens} tokens)")
        log(f"  greedy tokens {toks_a[:12]}... top-p {toks_p[:12]}...")
        missing = [k for k, n in main_launches.items() if n == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the main path: "
                               f"{missing}")
        main_path = dict(
            load_s=load_s, peak_memory_gb=peak_gb, launches=main_launches,
            runs={label: dict(ttft_ms=1e3 * m.ttft_seconds,
                              prefill_tok_s=m.prefill_tokens_per_second,
                              decode_tok_s=m.tokens_per_second)
                  for label, m in runs})
        del engine, params, f
        torch.cuda.empty_cache()

        # ---- 4. the chat CLI
        log("phase 4: chat CLI")
        tok_path = work / "tokenizer.bin"
        synthetic_tokenizer(tok_path)
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "lmrs_tpu_torch.cli.chat", "--model",
             str(model), "--tokenizer", str(tok_path), "--temperature", "0",
             "--max-new-tokens", "16", "--show-metrics"],
            input="hello from the smoke run\n", capture_output=True,
            text=True, timeout=600, cwd=str(HERE),
            env=dict(os.environ, PYTHONPATH=str(HERE)))
        if cli.returncode != 0:
            raise RuntimeError(f"chat CLI exit {cli.returncode}:\n"
                               f"{cli.stderr[-4000:]}")
        lines = cli.stdout.splitlines()
        at = [i for i, ln in enumerate(lines) if ln.endswith("Assistant:")]
        reply = lines[at[0] + 1] if at and at[0] + 1 < len(lines) else ""
        if not reply.strip():
            raise RuntimeError(f"chat CLI printed no reply:\n{cli.stdout}")
        counted = [ln for ln in lines if ln.startswith("Kernel launches")]
        if not counted:
            raise RuntimeError(f"chat CLI printed no launch counts:\n"
                               f"{cli.stdout}")
        cli_launches = json.loads(counted[-1].split(":", 1)[1])
        log(f"  CLI exit 0 in {time.perf_counter() - t0:.1f} s; reply "
            f"{reply[:80]!r}; {[ln for ln in lines if 'Speed' in ln]}; "
            f"launches {cli_launches}")
        missing = [k for k in REPLACES if not cli_launches.get(k)]
        if missing:
            raise RuntimeError(f"kernels never launched on the CLI path: "
                               f"{missing}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 5. results
    per_kernel = []
    unit = {"q4_gemv": ("decode token: 42 x (wqkv, wo, w13, w2) + "
                        "classifier at T=1",
                        [(s, 1, L) for s in LAYER_SHAPES]
                        + [("classifier", 1, 1)]),
            "q4_gemm": ("prefill chunk: 42 x (wqkv, wo, w13, w2) at T=256",
                        [(s, 256, L) for s in LAYER_SHAPES]),
            "flash_attention": ("decode token at pos 6000: 42 x T=1",
                                [("pos6000", 1, L)])}
    for name in REPLACES:
        mine = [c for c in cases if c["kernel"] == name]
        what, plan = unit[name]
        pick = {(c["shape"], c["T"]): c for c in mine}
        tot = {key: sum(n * pick[(s, t)][key] for s, t, n in plan)
               for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        per_kernel.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=main_launches[name],
            cli_launches=cli_launches[name],
            max_abs_err=max(c["max_abs_err"] for c in mine),
            err_over_tol=max(c["err_over_tol"] for c in mine),
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by=pick[(plan[0][0], plan[0][1])]["bound_by"],
            library_ms=tot["library_ms"], unit=what, cases=mine))
    log("main path: " + json.dumps(main_path))
    log(f"chip_smoke ran {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": per_kernel}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
