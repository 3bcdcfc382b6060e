#!/usr/bin/env python3
"""Two versions of kernels B (`q4_gemm.cu`) and F (`q8_gemm.cu`) side by
side on one card: did a change to either source move them?

    python3 scripts/torch_gemm_ab.py --parent DIR [--ts 9,16,64,80,256,512]

DIR holds the other version's `q4_gemm.cu` and `q8_gemm.cu` (with any
header they include), e.g. an earlier commit's
`git show <commit>:lmrs_tpu_torch/csrc/q4_gemm.cu`.  Both versions build
with the package's nvcc flags; the change is the tree's `lmrs_tpu_torch/
csrc`.  Cases: B at Gemma-2-9B's four layer matrices (wqkv, wo, w13, w2),
F at Llama-3.2-3B's, B and F at Phi-3.5-mini's (D 3,072, hidden 8,192,
wqkv 9,216), each at every T of `--ts`, Q4_0 / Q8_0 weights with group
size 128 and negative / positive scales of the synthetic writer's size.
Each result is held against the plain version first (1e-3 of the output
scale, as chip_smoke.py), then timed in the order parent, change, change,
parent (`chip_smoke.Timer`: median of 50 calls, 128 MB of L2 flushed
before each), so that drift within the call shows as a difference between
the two runs of one version.  Beside each time: the host's time per call
(the wall time of 200 calls enqueued back to back over 200, median of 5),
one `torch.matmul` of the bf16 x and the pre-dequantized bf16 weights
(timed only: the yardstick), and the bound (bytes: packed weights, scales,
x and y once each, over 3.35 TB/s; operations: 2*T*O*K over 989 TFLOP/s;
the larger).  Prints the card's name and power limit, one line per case
and one JSON line.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GS = 128
PHI = dict(name="phi3.5-mini", D=3072, HID=8192, H=32, KH=32, HD=96,
           V=32064)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="directory of the other q4_gemm.cu and q8_gemm.cu")
    ap.add_argument("--ts", default="9,16,64,80,256,512",
                    help="rows of x to time")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (GEMMA, LAYER_SHAPES, LLAMA, PEAKS, Timer,
                            bound_ms, matmul_shapes, random_q4, random_q8)
    from lmrs_tpu_torch.kernels import cuda
    from lmrs_tpu_torch.kernels.q4_gemm import dequant_bf16 as dequant_q4
    from lmrs_tpu_torch.kernels.q4_gemm import q4_gemm, q4_gemm_plain
    from lmrs_tpu_torch.kernels.q8_gemm import dequant_bf16 as dequant_q8
    from lmrs_tpu_torch.kernels.q8_gemm import q8_gemm, q8_gemm_plain

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    peak = PEAKS[torch.cuda.get_device_name(0)]
    cuda.plain_numerics()
    timed = Timer(torch)
    ts = [int(t) for t in args.ts.split(",")]
    kernels = {"q4_gemm": (q4_gemm, q4_gemm_plain, random_q4, dequant_q4,
                           0.5),
               "q8_gemm": (q8_gemm, q8_gemm_plain, random_q8, dequant_q8,
                           1.0)}
    plan = [("q4_gemm", GEMMA), ("q8_gemm", LLAMA), ("q4_gemm", PHI),
            ("q8_gemm", PHI)]

    def host_us(fn, calls=200, runs=5) -> float:
        per_call = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        return statistics.median(per_call)

    (ROOT / "build").mkdir(exist_ok=True)
    results = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        libs = {}
        for version, src in (("parent", Path(args.parent)),
                             ("change", cuda.CSRC)):
            for name in kernels:
                lib = Path(tmp) / f"lib{name}_{version}.so"
                subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o",
                                str(lib), str(src / f"{name}.cu")],
                               check=True, capture_output=True)
                libs[(name, version)] = ctypes.CDLL(str(lib))
        for name, model in plan:
            fn, plain, make, dequant, wbytes = kernels[name]
            for shape in LAYER_SHAPES:
                o, k = matmul_shapes(model)[shape]
                q, s = make(torch, gen, o, k)
                w_lib = dequant(q, s, GS)
                for t in ts:
                    x = torch.randn(t, k, device="cuda", generator=gen)
                    xl = x.to(torch.bfloat16)
                    want = plain(x, q, s, GS)
                    row = dict(kernel=name, model=model["name"],
                               shape=shape, T=t, O=o, K=k, ms={},
                               host_us={})
                    for turn, version in enumerate(("parent", "change",
                                                    "change", "parent")):
                        cuda._libs[name] = libs[(name, version)]
                        got = fn(x, q, s, GS)
                        torch.cuda.synchronize()
                        err = ((got - want).abs().max()
                               / want.abs().max()).item()
                        if not err <= 1e-3:
                            raise RuntimeError(
                                f"{version} {name} {model['name']} {shape} "
                                f"T={t}: {err} of the output scale")
                        col = f"{version}_{turn}"
                        row["ms"][col] = timed(lambda: fn(x, q, s, GS))
                        row["host_us"][col] = host_us(
                            lambda: fn(x, q, s, GS))
                    cuda._libs.pop(name)
                    row["library_ms"] = timed(
                        lambda: torch.matmul(xl, w_lib.t()))
                    nbytes = (wbytes * o * k + 4 * o * k / GS + 2 * t * k
                              + 4 * t * o)
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        nbytes, 2.0 * t * o * k, peak["bf16"], peak["mem"])
                    par = min(row["ms"]["parent_0"], row["ms"]["parent_3"])
                    chg = max(row["ms"]["change_1"], row["ms"]["change_2"])
                    row["parent_over_change"] = par / chg
                    results.append(row)
                    print(f"{name} {model['name']:12s} {shape:5s} T={t:3d}: "
                          + "  ".join(f"{c} {v:.4f}"
                                      for c, v in row["ms"].items())
                          + f"  library {row['library_ms']:.4f}  bound "
                          f"{row['bound_ms']:.4f} ({row['bound_by']})  "
                          f"x {row['parent_over_change']:.2f}  host us "
                          + " ".join(f"{v:.1f}"
                                     for v in row["host_us"].values()),
                          flush=True)
                del q, s, w_lib
                torch.cuda.empty_cache()
    print(card)
    print(json.dumps(dict(card=card, cases=results)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
