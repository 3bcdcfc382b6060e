#!/usr/bin/env python3
"""Kernel D (`q8_gemv_i8`) at every K split on one card: which cluster size
S should a layer shape take?

    python3 scripts/torch_q8_gemv_split.py [--ts 1,8]

Times D at the four layer matmuls (wqkv, wo, w13, w2) of Llama-3.2-3B,
Gemma-2-9B and Phi-3.5-mini as Q8_0 (group size 128) at every S of 1-8
that the kernel takes there (a rank's groups within its scales' budget),
and at the S its rule picks (`lmrs_q8_gemv_i8_split`), at each T of `--ts`:
the device time of one call (torch.profiler over 20 calls, each after a
read of 256 MB, which leaves L2 holding clean lines as a decode step finds
it), the S's turns run forward then backward and the faster kept.  Each
output is held against `q8_gemv_i8_plain` (1e-4 of the output scale) and
every S against the rule's S (the sums' order differs: the same
tolerance).  Prints the card's name and power limit, one line per shape
and T, and one JSON line.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GS = 128
PHI = dict(name="phi3.5-mini", D=3072, HID=8192, L=32, H=32, KH=32, HD=96,
           V=32064)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ts", default="1,8", help="rows of x")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import GEMMA, LAYER_SHAPES, LLAMA, matmul_shapes, random_q8
    from lmrs_tpu_torch.kernels import cuda
    from lmrs_tpu_torch.kernels.q8_gemv_i8 import q8_gemv_i8_plain

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    cuda.plain_numerics()
    lib = cuda.library("q8_gemv_i8")
    p, i = ctypes.c_void_p, ctypes.c_int
    gemv = lib.lmrs_q8_gemv_i8_at_split
    gemv.argtypes = [p, p, p, p, i, i, i, i, i, p]
    gemv.restype = ctypes.c_int
    rule = lib.lmrs_q8_gemv_i8_split
    rule.argtypes = [i, i, i]
    rule.restype = ctypes.c_int
    clean = torch.ones(64 << 20, dtype=torch.float32, device="cuda")

    def call(x, q, s, split):
        t, k = x.shape
        y = torch.empty((t, q.shape[0]), dtype=torch.float32, device="cuda")
        err = gemv(x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(),
                   t, q.shape[0], k, GS, split,
                   torch.cuda.current_stream().cuda_stream)
        return y if err == 0 else None

    def device_us(fn, calls=20):
        fn()
        torch.cuda.synchronize()
        ours = []
        for _ in range(3):      # a trace that lost kernels is taken again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    clean.sum()
                    fn()
                torch.cuda.synchronize()
            ours = [ev for ev in prof.key_averages()
                    if "q8_gemv_i8" in ev.key]
            if sum(ev.count for ev in ours) >= calls:
                break
        return sum(getattr(ev, "self_device_time_total",
                           getattr(ev, "self_cuda_time_total", 0.0))
                   for ev in ours) / calls

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for model in (LLAMA, GEMMA, PHI):
        for shape in LAYER_SHAPES:
            o, k = matmul_shapes(model)[shape]
            q, s = random_q8(torch, gen, o, k)
            picked = rule(o, k, GS)
            for t in (int(v) for v in args.ts.split(",")):
                x = torch.randn(t, k, device="cuda", generator=gen)
                want = q8_gemv_i8_plain(x, q, s, GS)
                scale = want.abs().max().item()
                splits = [c for c in range(1, 9)
                          if call(x, q, s, c) is not None]
                us = {}
                for c in splits + splits[::-1]:
                    got = call(x, q, s, c)
                    err = (got - want).abs().max().item() / scale
                    if not err <= 1e-4:
                        raise RuntimeError(f"{model['name']} {shape} T={t} "
                                           f"S={c}: {err} of the scale")
                    v = device_us(lambda: call(x, q, s, c))
                    us[c] = min(us.get(c, v), v)
                best = min(us, key=us.get)
                rows.append(dict(model=model["name"], shape=shape, T=t, O=o,
                                 K=k, us=us, rule=picked, best=best))
                print(f"{model['name']:12s} {shape:5s} T={t}: "
                      + "  ".join(f"S{c} {v:.1f}" for c, v in us.items())
                      + f"  (us; rule S{picked}, best S{best})", flush=True)
            del q, s
            torch.cuda.empty_cache()
    print(card)
    print(json.dumps(dict(card=card, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
