#!/usr/bin/env python3
"""Where a decode token's time goes in lmrs_tpu_torch, on the card.

    python3 scripts/torch_decode_profile.py [--steps 16] [--pos 1024]
        [--model gemma2-9b|llama3.2-3b|...] [--quant Q4_0|Q8_0]
        [--cache-dtype bfloat16|float32|int8|int4] [--spec-k K]
    LMRS_W8A8=0 python3 scripts/torch_decode_profile.py ...  # Q8_0 layers W8A16

Writes a synthetic .lmrs of the chosen preset (default Gemma-2-9B Q4_0,
seed 0) under build/, loads it onto the GPU with the chosen KV cache type,
prefills `--pos` tokens, then runs `--steps` decode steps twice: once
timed with the host clock after torch.cuda.synchronize(), once under
torch.profiler.  With `--spec-k K` a step is a greedy speculative verify
step of K drafted tokens (random weights give a greedy stream that
repeats one token, so the tokens per step say nothing of real text: the
figures show a verify step by kernel).  Prints the card's name and power
limit, device time per step by kernel (from the profiled steps), the
device's busy share of a step (device time per step over the UNPROFILED
host-clock time per step: the profiler's own host overhead would stretch
the traced window), and one JSON line with the same numbers.  Needs one
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
    if "flash_kernel" in name:      # kernels C, G and H: one template
        m = re.search(r"Cache\)\s*(\d)", name)
        return (f"flash_kernel ({FLASH_CACHES[int(m.group(1))]} cache)"
                if m else "flash_kernel")
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
    from lmrs_tpu_torch.runtime.engine import Engine
    from lmrs_tpu_torch.runtime.speculative import verify_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="profile_", dir=str(ROOT / "build")))
    try:
        path = work / "model.lmrs"
        write_synthetic_lmrs(str(path), PRESETS[args.model](
            quant=QuantType[args.quant]))
        f = read_lmrs(str(path))
        w8a8 = os.environ.get("LMRS_W8A8", "1") == "1"   # as the chat CLI
        engine = Engine(f.cfg, params_from_lmrs(f, device="cuda"),
                        cache_dtype=args.cache_dtype, w8a8=w8a8)
        prompt = torch.randint(0, f.cfg.vocab_size, (args.pos,),
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
                        n_acc, emitted = verify_step(
                            engine.params, engine.cfg, engine.cache,
                            engine._hist, engine.pos, k, 0.0, 1.0,
                            w8a8=engine.w8a8)
                        engine._hist[engine.pos + 1:
                                     engine.pos + k + 2] = emitted
                    n = int(n_acc.item()) + 1     # the step's one host read
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
        by_group = defaultdict(float)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_group[_kernel_group(e.name)] += e.time_range.elapsed_us()
        result = dict(card=card, model=args.model, quant=args.quant,
                      cache_dtype=args.cache_dtype, w8a8=w8a8, pos=args.pos,
                      steps=args.steps, spec_k=k, wall_ms_per_step=wall_ms,
                      tokens_per_step=n_tokens / args.steps,
                      wall_ms_per_token=wall_ms * args.steps / n_tokens,
                      peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(card)
        what = f"verify (k={k})" if k else "decode"
        print(f"{args.model} {args.quant}, {args.cache_dtype} cache, {what} "
              f"at pos {args.pos}: {wall_ms:.3f} ms per step on the "
              f"host clock, {n_tokens / args.steps:.2f} tokens per step "
              f"({1e3 * n_tokens / args.steps / wall_ms:.2f} tok/s)")
        if by_group:
            per_token = {g: v / 1e3 / args.steps for g, v in by_group.items()}
            busy = sum(per_token.values()) / wall_ms
            result.update(device_ms_per_step=per_token,
                          device_busy_share=busy,
                          device_idle_share=1.0 - busy)
            for g, v in sorted(per_token.items(), key=lambda kv: -kv[1]):
                print(f"  {g:30s} {v:8.3f} ms of device time per step")
            print(f"  device busy {100 * busy:.1f}% of a step")
        else:
            result["device_ms_per_step"] = "not measured"
            print("  the profiler recorded no device activity: device time "
                  "not measured")
        print(json.dumps(result))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
