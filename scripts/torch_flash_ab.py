#!/usr/bin/env python3
"""Two versions of `flash_attention.cu` side by side on one card: did a
change to the kernel template move kernels C, G and H?

    python3 scripts/torch_flash_ab.py --parent path/to/old/flash_attention.cu

Builds the given source and the tree's `lmrs_tpu_torch/csrc/
flash_attention.cu` with the package's nvcc flags, then times kernel C
(bf16 cache), kernel G (int8 cache) and kernel H (int4 cache: pair packing
at Llama's geometry, half at Gemma's) of each at Llama-3.2-3B's and
Gemma-2-9B's attention geometry, S = 8,192, T = 1 at pos 1,100 and 6,000:
median of 50 launches with the L2 flushed before each (as `chip_smoke.py`
times them), in the order parent, change, change, parent, so that drift
within the call shows as a difference between the two runs of one version.
Each version's result is held against the plain version first.  Prints the
card's name and power limit, one line per case and one JSON line.  Needs
one CUDA device and nvcc; the entry points C, G and H must exist in both
sources.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
S = 8192
# name, heads, kv heads, head_dim, window, softcap
MODELS = [("llama3.2-3b", 24, 8, 128, None, None),
          ("gemma2-9b", 16, 8, 256, 4096, 50.0)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="the other version of flash_attention.cu")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from lmrs_tpu_torch.kernels import cuda
    from lmrs_tpu_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_plain,
                                                        flash_attention_tol)
    from lmrs_tpu_torch.kernels.flash_attention_i4 import (
        flash_attention_i4, flash_attention_i4_plain, flash_attention_i4_tol)
    from lmrs_tpu_torch.kernels.flash_attention_i8 import (
        flash_attention_i8, flash_attention_i8_plain, flash_attention_i8_tol)
    from lmrs_tpu_torch.quant import quantize_kv_rows, quantize_kv_rows_q4

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    cuda.plain_numerics()
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")

    def timed(fn) -> float:
        for _ in range(5):
            fn()
        pairs = []
        for _ in range(50):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    cases = []      # (label, kernel, plain, bound function, arguments, kw)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, H, KH, HD, window, softcap in MODELS:
        kf = torch.randn(S, KH, HD, device="cuda", generator=gen)
        vf = torch.randn(S, KH, HD, device="cuda", generator=gen)
        rows, scales = quantize_kv_rows(torch.stack([kf, vf]))
        ks, vs = (scales[i].t().contiguous()[None] for i in (0, 1))
        bf16 = (kf.reshape(1, S, KH * HD).to(torch.bfloat16),
                vf.reshape(1, S, KH * HD).to(torch.bfloat16))
        int8 = (rows[0][None].contiguous(), rows[1][None].contiguous(),
                ks, vs)
        rows4, scales4 = quantize_kv_rows_q4(torch.stack([kf, vf]))
        int4 = (rows4[0][None].contiguous(), rows4[1][None].contiguous(),
                *(scales4[i].t().contiguous()[None] for i in (0, 1)))
        kw = dict(n_kv=KH, scale=HD ** -0.5, softcap=softcap, window=window)
        q = torch.randn(1, H, HD, device="cuda", generator=gen)
        for pos in (1100, 6000):
            cases.append((f"C {name} pos {pos}", flash_attention,
                          flash_attention_plain, flash_attention_tol,
                          (q, *bf16, 0, pos), kw))
            cases.append((f"G {name} pos {pos}", flash_attention_i8,
                          flash_attention_i8_plain, flash_attention_i8_tol,
                          (q, *int8, 0, pos), kw))
            cases.append((f"H {name} pos {pos}", flash_attention_i4,
                          flash_attention_i4_plain, flash_attention_i4_tol,
                          (q, *int4, 0, pos), kw))

    sources = {"parent": Path(args.parent),
               "change": cuda.CSRC / "flash_attention.cu"}
    (ROOT / "build").mkdir(exist_ok=True)
    results = {label: {} for label, *_ in cases}
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        libs = {}
        for version, src in sources.items():
            lib = Path(tmp) / f"lib{version}.so"
            subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(lib),
                            str(src)], check=True, capture_output=True)
            libs[version] = ctypes.CDLL(str(lib))
        for turn, version in enumerate(("parent", "change", "change",
                                        "parent")):
            cuda._libs["flash_attention"] = libs[version]
            for label, kernel, plain, tol_fn, a, kw in cases:
                got, want = kernel(*a, **kw), plain(*a, **kw)
                ratio = ((got - want).abs() / tol_fn(*a, **kw)).max().item()
                if not ratio <= 1.0:
                    raise RuntimeError(f"{version} {label}: {ratio} of the "
                                       f"tolerance")
                results[label][f"{version}_{turn}"] = timed(
                    lambda: kernel(*a, **kw))
        cuda._libs.pop("flash_attention")

    print(card)
    for label, row in results.items():
        print(f"{label:24s}" + "  ".join(f"{k} {v:.4f} ms"
                                         for k, v in row.items()))
    print(json.dumps(dict(card=card, ms=results)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
