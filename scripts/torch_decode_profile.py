#!/usr/bin/env python3
"""Where a decode token's time goes in lmrs_tpu_torch, on the card.

    python3 scripts/torch_decode_profile.py [--steps 16] [--pos 1024]

Writes a synthetic Gemma-2-9B Q4_0 .lmrs (seed 0) under build/, loads it
onto the GPU, prefills `--pos` tokens, then runs `--steps` decode steps
twice: once timed with the host clock after torch.cuda.synchronize(), once
under torch.profiler.  Prints the card's name and power limit, device time
per token by kernel (from the profiled steps), the device's busy share of
a decode step (device time per token over the UNPROFILED host-clock time
per token: the profiler's own host overhead would stretch the traced
window), and one JSON line with the same numbers.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _kernel_group(name: str) -> str:
    for key in ("q4_gemv", "q4_gemm", "flash_kernel"):
        if key in name:
            return key
    return "other (PyTorch ops)"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--pos", type=int, default=1024)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from lmrs_tpu_torch.config import QuantType, gemma2_9b
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import params_from_lmrs
    from lmrs_tpu_torch.io.synthetic import write_synthetic_lmrs
    from lmrs_tpu_torch.runtime.engine import Engine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="profile_", dir=str(ROOT / "build")))
    try:
        path = work / "gemma2-9b-q4.lmrs"
        write_synthetic_lmrs(str(path), gemma2_9b(quant=QuantType.Q4_0))
        f = read_lmrs(str(path))
        engine = Engine(f.cfg, params_from_lmrs(f, device="cuda"))
        prompt = torch.randint(0, f.cfg.vocab_size, (args.pos,),
                               generator=torch.Generator().manual_seed(0))
        engine.prefill(prompt.tolist())
        tok = torch.tensor([5], device="cuda")

        def steps():
            nonlocal tok
            for _ in range(args.steps):
                logits = engine.decode_step(tok)
                tok = torch.argmax(logits).reshape(1)

        steps()                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps()
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
        result = dict(card=card, pos=args.pos, steps=args.steps,
                      wall_ms_per_token=wall_ms)
        print(card)
        print(f"decode at pos {args.pos}: {wall_ms:.3f} ms per token on the "
              f"host clock ({1e3 / wall_ms:.2f} tok/s)")
        if by_group:
            per_token = {k: v / 1e3 / args.steps for k, v in by_group.items()}
            busy = sum(per_token.values()) / wall_ms
            result.update(device_ms_per_token=per_token,
                          device_busy_share=busy,
                          device_idle_share=1.0 - busy)
            for k, v in sorted(per_token.items(), key=lambda kv: -kv[1]):
                print(f"  {k:22s} {v:8.3f} ms of device time per token")
            print(f"  device busy {100 * busy:.1f}% of a decode step")
        else:
            result["device_ms_per_token"] = "not measured"
            print("  the profiler recorded no device activity: device time "
                  "not measured")
        print(json.dumps(result))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
