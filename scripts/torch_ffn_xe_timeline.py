#!/usr/bin/env python3
"""Where a call of kernel K (`ffn_fused_xe`) spends its time, block by block.

    python3 scripts/torch_ffn_xe_timeline.py [--t 1] [--calls 3]

Builds a copy of `lmrs_tpu_torch/csrc/ffn_fused.cu` with %globaltimer
stamps added (the tree's source is not changed; the copy goes under
`build/`), runs K at Gemma-2-9B's FFN (Q4_0, tanh-GELU) and Llama-3.2-3B's
(Q8_0, silu) on random weights, each call after the timer's 128 MB L2
flush (`chip_smoke.Timer`), and prints for both launches (the GLU stage,
the down stage), in microseconds from the GLU stage's first block start,
the min / median / max over blocks of: the block's start; its prologue
done (scales and activations staged; the down stage: also
griddepcontrol.wait returned, `wait`); its first and last weight stage
landed; its products done; its sums ready to store (after the cluster's
sum where K is split).  Then, over the
blocks, the median time a stage took from its issue to its landing
(`latency`) and from its landing to its products' end (`products`), and
the gap from the GLU stage's last block's sums to the down stage's wait
return.  The stamps cost a few global stores a stage; the figures are the
instrumented kernel's, not the tree's.  Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAX_BLOCKS, MAX_STAGES = 1024, 32

# (anchor in csrc/ffn_fused.cu, text put after it): the stamps
STAMPS = [
    ("// ---- kernel K\n",
     "__device__ unsigned long long g_tl[2][%d][8];\n"
     "__device__ unsigned long long g_st[2][%d][%d][3];\n"
     "__device__ __forceinline__ unsigned long long now() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     "#define STAMP(k) do { if (threadIdx.x == 0) "
     "g_tl[S][blockIdx.x][k] = now(); } while (0)\n"
     % (MAX_BLOCKS, MAX_BLOCKS, MAX_STAGES)),
    ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
     "  STAMP(0);\n"),
    ("      asm volatile(\"griddepcontrol.wait;\\n\" ::: \"memory\");\n",
     "      STAMP(1);\n"),
    ("  __syncthreads();   // the barriers, scales and activations are ready\n",
     "  STAMP(2);\n"),
    ("    sm90::mbar_wait(full(slot), (i / D) & 1);\n",
     "    if (i == 0) STAMP(3);\n    if (i == nst - 1) STAMP(4);\n"
     "    if (tid == 0 && i < %d) g_st[S][blockIdx.x][i][1] = now();\n"
     % MAX_STAGES),
    ("    __syncwarp();\n    if (lane == 0) sm90::mbar_arrive(empty(slot));\n",
     "    if (tid == 0 && i < %d) g_st[S][blockIdx.x][i][2] = now();\n"
     % MAX_STAGES),
    ("  auto issue = [&](int i) {\n",
     "    if (i < %d) g_st[S][blockIdx.x][i][0] = now();\n" % MAX_STAGES),
    ("  // acc[tile][2h + cc]: row pg + 8h of box `tile`, column 2t4 + cc.\n",
     "  STAMP(5);\n"),
    ("    if (half == 1) return;\n",
     "    if (threadIdx.x == 0) g_tl[S][blockIdx.x][6] = now();\n"),
    ("  sm90::cluster_sync();\n  auto sum", None),
    ("}  // namespace\n",
     "extern \"C\" int tl_copy(void* a, void* b) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(a, g_tl, sizeof(g_tl));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(b, g_st, "
     "sizeof(g_st));\n  return (int)e;\n}\n"
     "extern \"C\" int tl_clear(const void* a, const void* b) {\n"
     "  cudaError_t e = cudaMemcpyToSymbol(g_tl, a, sizeof(g_tl));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_st, b, "
     "sizeof(g_st));\n  return (int)e;\n}\n"),
]
NAMES = ("start", "wait", "prologue", "first stage", "last stage",
         "products", "sums ready")


def instrument(src: str) -> str:
    for anchor, text in STAMPS:
        at = src.find(anchor)
        if at < 0:
            raise RuntimeError(f"csrc/ffn_fused.cu changed: no {anchor!r}")
        if text is None:        # the split path's end: after the sum
            cut = at + len("  sm90::cluster_sync();\n")
            src = src[:cut] + "  STAMP(6);\n" + src[cut:]
        else:
            src = src[:at + len(anchor)] + text + src[at + len(anchor):]
    return src


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--t", type=int, default=1, help="rows of x")
    ap.add_argument("--calls", type=int, default=3,
                    help="calls before the one read (warm-up)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import GEMMA, LLAMA, Timer, random_q4, random_q8
    from lmrs_tpu_torch.kernels import cuda
    from lmrs_tpu_torch.kernels.ffn_fused import ffn_fused_xe

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    (ROOT / "build").mkdir(exist_ok=True)
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(3)
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        for name in ("gemv_sm90.cuh", "qgemm_sm90.cuh", "wgmma_sm90.cuh"):
            shutil.copy(cuda.CSRC / name, Path(tmp) / name)
        src = Path(tmp) / "ffn_fused.cu"
        src.write_text(instrument((cuda.CSRC / "ffn_fused.cu").read_text()))
        lib_path = Path(tmp) / "libffn_fused_timeline.so"
        subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(lib_path),
                        str(src)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(lib_path))
        cuda._libs["ffn_fused"] = lib
        print(card)
        for model, quant, act in ((GEMMA, "q4", "gelu"),
                                  (LLAMA, "q8", "silu")):
            d, h = model["D"], model["HID"]
            make = random_q4 if quant == "q4" else random_q8
            w = [*make(torch, gen, 2 * h, d), *make(torch, gen, d, h)]
            x = torch.randn(args.t, d, device="cuda", generator=gen)
            tl = np.zeros((2, MAX_BLOCKS, 8), dtype=np.uint64)
            st = np.zeros((2, MAX_BLOCKS, MAX_STAGES, 3), dtype=np.uint64)
            for _ in range(args.calls + 1):
                ffn_fused_xe(x, *w, 128, act)
                torch.cuda.synchronize()
                if lib.tl_clear(ctypes.c_void_p(tl.ctypes.data),
                                ctypes.c_void_p(st.ctypes.data)):
                    raise RuntimeError("clearing the stamps failed")
                timer.flush.zero_()
                ffn_fused_xe(x, *w, 128, act)
                torch.cuda.synchronize()
            if lib.tl_copy(ctypes.c_void_p(tl.ctypes.data),
                           ctypes.c_void_p(st.ctypes.data)):
                raise RuntimeError("reading the stamps failed")
            t0 = int(tl[0][tl[0][:, 0] > 0][:, 0].min())
            print(f"{model['name']} T={args.t} (us from the GLU stage's "
                  f"first block start; min / median / max over blocks)")
            ends = {}
            for s_ in range(2):
                live = tl[s_][:, 0] > 0
                rows = tl[s_][live].astype(np.int64)
                print(f"  {'GLU' if s_ == 0 else 'down'} stage, "
                      f"{int(live.sum())} blocks")
                for k, nm in enumerate(NAMES):
                    v = rows[:, k][rows[:, k] > 0]
                    if not v.size:
                        continue
                    v = (v - t0) / 1e3
                    print(f"    {nm:12s} {v.min():8.2f} {np.median(v):8.2f} "
                          f"{v.max():8.2f}")
                    ends[(s_, nm)] = v
                sts = st[s_][live].astype(np.int64)
                ok = (sts[:, :, 0] > 0) & (sts[:, :, 1] > 0) & \
                    (sts[:, :, 2] > 0)
                lat = (sts[:, :, 1] - sts[:, :, 0])[ok] / 1e3
                prod = (sts[:, :, 2] - sts[:, :, 1])[ok] / 1e3
                print(f"    a stage: latency {np.median(lat):.2f} us, "
                      f"products {np.median(prod):.2f} us (medians)")
            if (1, "wait") in ends:
                print(f"  gap from the GLU stage's last block's sums to the "
                      f"down stage's wait return: "
                      f"{np.median(ends[(1, 'wait')]) - ends[(0, 'sums ready')].max():.2f}"
                      f" us")
            del w
            torch.cuda.empty_cache()
        cuda._libs.pop("ffn_fused")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
