#!/usr/bin/env python3
"""How kernels B (`q4_gemm`) and F (`q8_gemm`) split K, and what each split
costs on this card.

    python3 scripts/torch_gemm_split.py [--ts 9,16,64,256,512]

The kernels (`lmrs_tpu_torch/csrc/qgemm_sm90.cuh`) let a cluster of S
blocks share one output tile, each block a range of K, and pick S at run
time (`split_k`): the largest S <= 8 for which the card holds the clusters
of all tiles at once.  This script builds a probe library from that header
which launches the kernel at a given S.  For B at Gemma-2-9B's four layer
matrices and F at Llama-3.2-3B's, at each T, it prints for every S: the
clusters of S blocks the card holds at once (cudaOccupancyMaxActiveClusters
for the kernel of that width), the time (`chip_smoke.Timer`: median of 50
calls, 128 MB of L2 flushed before each) and the S that `split_k` picks.
Every S is held against the plain version first (1e-3 of the output
scale).  Prints the card's name and power limit, one line per case and one
JSON line.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GS = 128
PROBE = r"""
#include "qgemm_sm90.cuh"
using namespace lmrs_sm90;

extern "C" int probe_gemm(int q4, const void* x, const void* q,
                          const float* s, float* y, int T, int O, int K,
                          int gs, int split, cudaStream_t stream) {
  return q4 ? launch<Quant::Q4>(x, q, s, y, T, O, K, gs, stream, split)
            : launch<Quant::Q8>(x, q, s, y, T, O, K, gs, stream, split);
}

extern "C" int probe_clusters(int q4, int T, int split) {
  return with_width(T, [&](auto n) {
    constexpr int N = decltype(n)::value;
    return q4 ? max_clusters<Quant::Q4, N>(split)
              : max_clusters<Quant::Q8, N>(split);
  });
}

extern "C" int probe_split(int q4, int T, int O, int K) {
  return with_width(T, [&](auto n) {
    constexpr int N = decltype(n)::value;
    return q4 ? split_k<Quant::Q4, N>(T, O, K)
              : split_k<Quant::Q8, N>(T, O, K);
  });
}
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ts", default="9,16,64,256,512", help="rows of x")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (GEMMA, LAYER_SHAPES, LLAMA, Timer, matmul_shapes,
                            random_q4, random_q8)
    from lmrs_tpu_torch.kernels import cuda
    from lmrs_tpu_torch.kernels.q4_gemm import q4_gemm_plain
    from lmrs_tpu_torch.kernels.q8_gemm import q8_gemm_plain

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    cuda.plain_numerics()
    timed = Timer(torch)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        src, lib = Path(tmp) / "probe.cu", Path(tmp) / "libprobe.so"
        src.write_text(PROBE)
        subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC),
                        "-o", str(lib), str(src)], check=True,
                       capture_output=True)
        probe = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    probe.probe_gemm.argtypes = [i, p, p, p, p, i, i, i, i, i, p]
    probe.probe_clusters.argtypes = [i, i, i]
    probe.probe_split.argtypes = [i, i, i, i]

    gen = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for q4, model, make, plain in ((1, GEMMA, random_q4, q4_gemm_plain),
                                   (0, LLAMA, random_q8, q8_gemm_plain)):
        for shape in LAYER_SHAPES:
            o, k = matmul_shapes(model)[shape]
            q, s = make(torch, gen, o, k)
            for t in (int(v) for v in args.ts.split(",")):
                x = torch.randn(t, k, device="cuda",
                                generator=gen).to(torch.bfloat16)
                want = plain(x, q, s, GS)
                y = torch.empty(t, o, device="cuda")

                def call(split):
                    return probe.probe_gemm(q4, x.data_ptr(), q.data_ptr(),
                                            s.data_ptr(), y.data_ptr(), t, o,
                                            k, GS, split, stream)

                row = dict(kernel="q4_gemm" if q4 else "q8_gemm",
                           model=model["name"], shape=shape, T=t, O=o, K=k,
                           ms={}, clusters={})
                for split in range(1, 9):
                    if split > k // (128 if q4 else 64):
                        break
                    y.fill_(float("nan"))
                    cuda.check(call(split), f"split {split}")
                    torch.cuda.synchronize()
                    err = ((y - want).abs().max() / want.abs().max()).item()
                    if not err <= 1e-3:
                        raise RuntimeError(f"{row['kernel']} {shape} T={t} "
                                           f"split {split}: {err}")
                    row["ms"][split] = timed(lambda: call(split))
                    row["clusters"][split] = probe.probe_clusters(q4, t,
                                                                  split)
                row["picked"] = probe.probe_split(q4, t, o, k)
                best = min(row["ms"], key=row["ms"].get)
                row["picked_over_best"] = (row["ms"][row["picked"]]
                                           / row["ms"][best])
                cases.append(row)
                print(f"{row['kernel']} {model['name']:11s} {shape:5s} "
                      f"T={t:3d} tiles {-(-o // 128) * -(-t // 256)}: "
                      + "  ".join(f"S{sp} {ms * 1e3:6.1f} us "
                                  f"({row['clusters'][sp]})"
                                  for sp, ms in row["ms"].items())
                      + f"  picked S{row['picked']}, "
                      f"{row['picked_over_best']:.3f} of the fastest",
                      flush=True)
            del q, s
            torch.cuda.empty_cache()
    print(card)
    print(json.dumps(dict(card=card, cases=cases)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
