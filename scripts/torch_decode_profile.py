#!/usr/bin/env python3
"""Where a decode token's time goes in lmrs_tpu_torch, on the card.

    python3 scripts/torch_decode_profile.py [--steps 16] [--pos 1024]
        [--model gemma2-9b|llama3.2-3b|...] [--quant Q4_0|Q8_0]
        [--cache-dtype bfloat16|float32|int8|int4] [--spec-k K]
    LMRS_W8A8=0 python3 scripts/torch_decode_profile.py ...  # Q8_0 layers W8A16
    python3 scripts/torch_decode_profile.py --batch 8 [--no-paged] ...
    python3 scripts/torch_decode_profile.py --fuse-ffn on|off|ab ...
    python3 scripts/torch_decode_profile.py --prefill [--pos 1024] ...

Writes a synthetic .lmrs of the chosen preset (default Gemma-2-9B Q4_0,
seed 0) under build/ (or uses and keeps `--lmrs PATH`), loads it onto the
GPU with the chosen KV cache type, prefills `--pos` tokens, then runs
`--steps` decode steps twice: once timed with the host clock after
torch.cuda.synchronize(), once under torch.profiler.  With `--spec-k K`
a step is a greedy speculative verify step of K drafted tokens (a
`runtime.speculative.spec_chunk` of one step, read once; random weights
give a greedy stream that repeats one token, so the tokens per step say
nothing of real text: the figures show a verify step by kernel).  Prints
the card's name and power limit, device time per step by kernel (from the
profiled steps), the device's busy share of a step (device time per
step over the UNPROFILED host-clock time per step: the profiler's own
host overhead would stretch the traced window), and one JSON line with
the same numbers.
With `--batch B` a step is one step of the continuous-batching scheduler
(`serve.scheduler.BatchScheduler`, the paged pool unless `--no-paged`,
`--spec-k` for its speculative chunk): B greedy requests with prompts of
`--pos` tokens are prefilled, then `--steps` decode chunks of 8 steps run
with every slot active, and the figures are per decode step (B tokens, or
more with speculation).  `--fuse-ffn on` runs each layer's FFN through
the fused kernels (K, or L at 9..16 rows: `ModelConfig.fuse_ffn`); `ab`
measures off, on, on, off in turns on the one loaded model, each turn on
a fresh engine (or scheduler), and prints one JSON line of the turns.
With `--prefill` the unit is prefill instead: the TTFT of a `--pos`-token
prompt (host clock around `Engine.generate` of one token, median of
`--steps` runs after one warm-up, each on a reset engine), and device time
by kernel per 256-row prefill chunk from one profiled prefill of the same
prompt (its device time over its chunks; later chunks attend to more
rows), the busy share over that prefill's host-clock time.  Needs one
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


# flash_kernel<HD, (Cache)n>: the enumerators of csrc/flash_attention.cu
FLASH_CACHES = ("bf16", "int8", "f32", "int4 half", "int4 pair")


def _kernel_group(name: str) -> str:
    if "ffn_xe_kernel" in name or "ffn_kernel" in name:
        return "ffn_fused_xe (K)"   # K: both launches (an older K: one)
    if "qgemm_kernel" in name and ("Epi)1" in name or "Epi)2" in name):
        return "ffn_fused (L)"      # L: B/F's template, Glu and Down stages
    if "flash_merge_kernel" in name:  # kernel M: the split pass's merge
        return "flash_merge (M)"
    if "flash_kernel" in name:      # kernels C, G and H: one template
        m = re.search(r"Cache\)\s*(\d)", name)
        return (f"flash_kernel ({FLASH_CACHES[int(m.group(1))]} cache)"
                if m else "flash_kernel")
    if "qgemm_kernel" in name:      # kernels B and F: one template
        return "q8_gemm" if "Quant)1" in name else "q4_gemm"
    for key in ("q4_gemv", "q4_gemm", "q8_act_quant", "q8_gemv_i8",
                "q8_gemv", "q8_gemm"):
        if key in name:
            return key
    return "other (PyTorch ops)"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--pos", type=int, default=1024)
    ap.add_argument("--model", default="gemma2-9b")
    ap.add_argument("--quant", default="Q4_0", choices=["Q4_0", "Q8_0"])
    ap.add_argument("--cache-dtype", dest="cache_dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "int8", "int4"])
    ap.add_argument("--spec-k", dest="spec_k", type=int, default=0,
                    help="profile speculative verify steps of K drafts")
    ap.add_argument("--batch", type=int, default=0,
                    help="profile the batched scheduler's step at B slots")
    ap.add_argument("--no-paged", dest="no_paged", action="store_true",
                    help="with --batch: the contiguous per-slot cache")
    ap.add_argument("--lmrs", default=None,
                    help="the synthetic .lmrs to use: written there first "
                         "if missing, and kept (runs in turns share it)")
    ap.add_argument("--prefill", action="store_true",
                    help="profile prefill: TTFT and device time a chunk")
    ap.add_argument("--fuse-ffn", dest="fuse_ffn", default="off",
                    choices=["off", "on", "ab"],
                    help="the fused FFN kernels; ab: off, on, on, off")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from lmrs_tpu_torch.config import PRESETS, QuantType
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import params_from_lmrs
    from lmrs_tpu_torch.io.synthetic import write_synthetic_lmrs

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="profile_", dir=str(ROOT / "build")))
    try:
        path = Path(args.lmrs) if args.lmrs else work / "model.lmrs"
        if not path.exists():
            write_synthetic_lmrs(str(path), PRESETS[args.model](
                quant=QuantType[args.quant]))
        f = read_lmrs(str(path))
        w8a8 = os.environ.get("LMRS_W8A8", "1") == "1"   # as the chat CLI
        params = params_from_lmrs(f, device="cuda")
        print(card)
        turns = {"off": [False], "on": [True],
                 "ab": [False, True, True, False]}[args.fuse_ffn]
        results = []
        for fuse in turns:
            cfg = f.cfg.replace(fuse_ffn=fuse)
            profile = (profile_prefill if args.prefill else
                       profile_batched if args.batch else profile_decode)
            results.append(profile(torch, args, card, cfg, params, w8a8))
            torch.cuda.empty_cache()
        print(json.dumps(results[0] if len(results) == 1
                         else dict(card=card, turns=results)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


def report(result: dict, per_step: dict, wall_ms: float,
           unit: str = "step") -> dict:
    """Print device time per step (or chunk) by kernel group and the busy
    share."""
    if per_step:
        busy = sum(per_step.values()) / wall_ms
        result.update(device_ms_per_step=per_step, device_busy_share=busy,
                      device_idle_share=1.0 - busy)
        for g, v in sorted(per_step.items(), key=lambda kv: -kv[1]):
            print(f"  {g:30s} {v:8.3f} ms of device time per {unit}")
        print(f"  device busy {100 * busy:.1f}% of a {unit}")
    else:
        result["device_ms_per_step"] = "not measured"
        print("  the profiler recorded no device activity: device time not "
              "measured")
    return result


def profile_decode(torch, args, card, cfg, params, w8a8) -> dict:
    """Single-stream decode (or verify) steps after a `--pos`-token prompt
    (see the module note)."""
    from lmrs_tpu_torch.runtime.engine import Engine
    from lmrs_tpu_torch.runtime.speculative import spec_chunk

    engine = Engine(cfg, params, cache_dtype=args.cache_dtype, w8a8=w8a8)
    prompt = torch.randint(0, cfg.vocab_size, (args.pos,),
                           generator=torch.Generator().manual_seed(0))
    engine.prefill(prompt.tolist())
    tok = torch.tensor([5], device="cuda")
    k = args.spec_k

    def steps() -> int:
        """`--steps` decode (or verify) steps; the tokens they gave."""
        nonlocal tok
        n_tokens = 0
        for _ in range(args.steps):
            if k:
                with torch.no_grad():
                    _, n_acc, _, _ = spec_chunk(
                        engine._run, engine.cfg, engine._hist, engine.pos, 1,
                        k, 0.0, 1.0)
                n = int(n_acc.item())         # the step's one host read
                engine.pos += n
                n_tokens += n
            else:
                logits = engine.decode_step(tok)
                tok = torch.argmax(logits).reshape(1)
                n_tokens += 1
        return n_tokens

    if k:
        engine._note(tok)                     # the token at `pos`
    steps()                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_tokens = steps()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        steps()
        torch.cuda.synchronize()
    result = dict(card=card, model=args.model, quant=args.quant,
                  cache_dtype=args.cache_dtype, w8a8=w8a8,
                  fuse_ffn=cfg.fuse_ffn, pos=args.pos, steps=args.steps,
                  spec_k=k, wall_ms_per_step=wall_ms,
                  tokens_per_step=n_tokens / args.steps,
                  wall_ms_per_token=wall_ms * args.steps / n_tokens,
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    what = f"verify (k={k})" if k else "decode"
    print(f"{args.model} {args.quant}, {args.cache_dtype} cache, fuse_ffn "
          f"{cfg.fuse_ffn}, {what} at pos {args.pos}: {wall_ms:.3f} ms per "
          f"step on the host clock, {n_tokens / args.steps:.2f} tokens per "
          f"step ({1e3 * n_tokens / args.steps / wall_ms:.2f} tok/s)")
    del engine
    return report(result, device_time(torch, prof, args.steps), wall_ms)


def profile_prefill(torch, args, card, cfg, params, w8a8) -> dict:
    """TTFT of a `--pos`-token prompt and device time by kernel per
    prefill chunk (see the module note)."""
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

    engine = Engine(cfg, params, cache_dtype=args.cache_dtype, w8a8=w8a8)
    prompt = torch.randint(0, cfg.vocab_size, (args.pos,),
                           generator=torch.Generator().manual_seed(0))
    prompt = prompt.tolist()
    one = GenerationConfig(temperature=0.0, max_new_tokens=1)
    ttft = []
    for i in range(args.steps + 1):            # the first run warms up
        engine.reset()
        engine.generate(prompt, one)
        if i:
            ttft.append(1e3 * engine.metrics.ttft_seconds)
    ttft_ms = sorted(ttft)[len(ttft) // 2]
    n_chunks = -(-args.pos // engine.prefill_chunk)
    engine.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.prefill(prompt)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n_chunks
    engine.reset()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        engine.prefill(prompt)
        torch.cuda.synchronize()
    result = dict(card=card, model=args.model, quant=args.quant,
                  cache_dtype=args.cache_dtype, w8a8=w8a8,
                  fuse_ffn=cfg.fuse_ffn, prompt=args.pos,
                  chunk_rows=engine.prefill_chunk, chunks=n_chunks,
                  ttft_ms=ttft_ms, ttft_runs_ms=ttft,
                  wall_ms_per_chunk=wall_ms,
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"{args.model} {args.quant}, {args.cache_dtype} cache, fuse_ffn "
          f"{cfg.fuse_ffn}, a {args.pos}-token prompt: TTFT {ttft_ms:.2f} ms "
          f"(median of {len(ttft)}: {', '.join(f'{t:.1f}' for t in ttft)}), "
          f"{wall_ms:.3f} ms per {engine.prefill_chunk}-row chunk on the "
          f"host clock")
    del engine
    return report(result, device_time(torch, prof, n_chunks), wall_ms,
                  "chunk")


def device_time(torch, prof, steps: int):
    """Device time per step by kernel group of a profiled window."""
    by_group = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_group[_kernel_group(e.name)] += e.time_range.elapsed_us()
    return {g: v / 1e3 / steps for g, v in by_group.items()}


def profile_batched(torch, args, card, cfg, params, w8a8) -> dict:
    """The batched scheduler's decode step at `--batch` slots (see the
    module note)."""
    from lmrs_tpu_torch.serve.scheduler import BatchScheduler

    b, chunk = args.batch, 8
    max_ctx = min(cfg.seq_len, args.pos + (3 * args.steps + 2) * chunk
                  * (args.spec_k + 1) + 64)
    # a pool that holds every slot's whole context: all B slots run at once
    pool = None if args.no_paged else b * -(-max_ctx // 512) * 512
    sched = BatchScheduler(cfg, params, max_batch=b, max_ctx=max_ctx,
                           cache_dtype=args.cache_dtype, prefill_chunk=256,
                           decode_chunk=chunk, speculative_k=args.spec_k,
                           pool_tokens=pool, w8a8=w8a8)
    rng = torch.Generator().manual_seed(0)
    for _ in range(b):
        sched.submit(torch.randint(0, cfg.vocab_size, (args.pos,),
                                   generator=rng).tolist(),
                     max_new_tokens=1 << 30, temperature=0.0)
    for _ in range(64):                     # prefill every slot
        if sched.active == b:
            break
        sched.step()
    else:
        raise RuntimeError(f"only {sched.active} of {b} slots became active")

    def chunks():
        """`--steps` scheduler ticks, each one decode chunk; the tokens."""
        before = sched.tokens_emitted
        for _ in range(args.steps):
            sched.step()
        return sched.tokens_emitted - before

    chunks()                                # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_tokens = chunks()
    torch.cuda.synchronize()
    n_steps = args.steps * chunk
    wall_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        chunks()
        torch.cuda.synchronize()
    per_step = device_time(torch, prof, n_steps)
    result = dict(card=card, model=args.model, quant=args.quant,
                  cache_dtype=args.cache_dtype, w8a8=w8a8,
                  fuse_ffn=cfg.fuse_ffn, batch=b, paged=pool is not None,
                  pos=args.pos, spec_k=args.spec_k, steps=n_steps,
                  wall_ms_per_step=wall_ms,
                  tokens_per_step=n_tokens / n_steps,
                  aggregate_tok_s=1e3 * n_tokens / n_steps / wall_ms,
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"{args.model} {args.quant}, {args.cache_dtype} "
          f"{'pool' if pool else 'per-slot cache'}, fuse_ffn "
          f"{cfg.fuse_ffn}, batch {b} "
          f"{'verify (k=%d)' % args.spec_k if args.spec_k else 'decode'} "
          f"from pos {args.pos}: {wall_ms:.3f} ms per step on the host "
          f"clock, {n_tokens / n_steps:.2f} tokens per step "
          f"({result['aggregate_tok_s']:.1f} tok/s aggregate)")
    del sched
    return report(result, per_step, wall_ms)


if __name__ == "__main__":
    sys.exit(main())
