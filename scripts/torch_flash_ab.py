#!/usr/bin/env python3
"""Two versions of `flash_attention.cu` side by side on one card: did a
change to the kernel template move kernels C, G, H, I and J?

    python3 scripts/torch_flash_ab.py --parent path/to/old/flash_attention.cu
        [--splits 0,128,256,512]

Builds the given source and the tree's `lmrs_tpu_torch/csrc/
flash_attention.cu` with the package's nvcc flags, then times kernel C
(bf16 cache), kernel G (int8 cache) and kernel H (int4 cache: pair packing
at Llama's geometry, half at Gemma's) of each at Llama-3.2-3B's and
Gemma-2-9B's attention geometry, S = 8,192, T = 1 at pos 1,100 and 6,000,
and kernels I (per-slot cache) and J (pool of 512-row pages) at Gemma's, 8
slots at `chip_smoke.BATCH_POS`, bf16, T = 1, in the order parent, change,
change, parent, so that drift within the call shows as a difference
between the two runs of one version: the median of 50 calls with the L2
flushed before each (128 MB, `chip_smoke.Timer`), the device time of one
call (torch.profiler over 20 calls, each after the same flush: the sum of
the call's kernels, the split pass and kernel M), its span (the median,
over a trace of 100 such calls, of the time from the split pass's start to
M's end: where M is a programmatic dependent launch its blocks wait
inside the kernel, so the sum overstates the call) and the host's time per
call (the wall time of 200 calls enqueued back to back over 200, median of
5).  Both versions run with the package's split and the tree's wrappers,
so the parent must take the tree's arguments.  Each result is held against
the plain version, and the change's against the parent's bit for bit
(`same_bits`).  Then the change alone at each split of `--splits` (0: the
change's template unsplit; empty: none), which is how SPLIT is chosen; the
splits run in turns too (each once forward, once backward).  Prints the
card's name and power limit, one line per case and one JSON line.  Needs
one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
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
    ap.add_argument("--splits", default="0,128,256,512",
                    help="rows per split to time the change at, after the "
                         "turns (0: unsplit; empty: none)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (BATCH_POS, GEMMA, Timer, batched_cache,
                            profile_calls, to_pool)
    from lmrs_tpu_torch.kernels import cuda
    from lmrs_tpu_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_plain,
                                                        flash_attention_tol)
    from lmrs_tpu_torch.kernels.flash_attention_batched import (
        flash_attention_batched, flash_attention_batched_plain,
        flash_attention_batched_tol)
    from lmrs_tpu_torch.kernels.flash_attention_i4 import (
        flash_attention_i4, flash_attention_i4_plain, flash_attention_i4_tol)
    from lmrs_tpu_torch.kernels.flash_attention_i8 import (
        flash_attention_i8, flash_attention_i8_plain, flash_attention_i8_tol)
    from lmrs_tpu_torch.kernels.flash_attention_paged import (
        flash_attention_paged, flash_attention_paged_plain,
        flash_attention_paged_tol)
    from lmrs_tpu_torch.quant import quantize_kv_rows, quantize_kv_rows_q4

    # the modules (the package's names are the wrappers)
    flash_merge = importlib.import_module(
        "lmrs_tpu_torch.kernels.flash_merge")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    cuda.plain_numerics()
    timed = Timer(torch)

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
    (k, v, _, _), _, _ = batched_cache(torch, GEMMA, "bf16", BATCH_POS)
    kp, vp, table, _, _ = to_pool(torch, (k, v, None, None), 512,
                                  [p + 1 for p in BATCH_POS])
    bpos = torch.tensor(BATCH_POS, dtype=torch.int32, device="cuda")
    kw = dict(n_kv=GEMMA["KH"], scale=GEMMA["HD"] ** -0.5,
              softcap=GEMMA["SOFTCAP"], window=GEMMA["WINDOW"])
    qb = torch.randn(len(BATCH_POS), 1, GEMMA["H"], GEMMA["HD"],
                     device="cuda", generator=gen)
    cases.append(("I gemma2-9b 8 slots", flash_attention_batched,
                  flash_attention_batched_plain, flash_attention_batched_tol,
                  (qb, k, v, 0, bpos), kw))
    cases.append(("J gemma2-9b 8 slots", flash_attention_paged,
                  flash_attention_paged_plain, flash_attention_paged_tol,
                  (qb, kp, vp, table, 0, bpos), kw))

    first = {}      # label -> the first parent turn's output
    same_bits = {label: [] for label, *_ in cases}

    def run_all(results, column):
        for label, kernel, plain, tol_fn, a, kw in cases:
            got, want = kernel(*a, **kw), plain(*a, **kw)
            diff = (got - want).abs()
            ratio = torch.where(diff == 0, 0.0,
                                diff / tol_fn(*a, **kw)).max().item()
            if not ratio <= 1.0:
                raise RuntimeError(f"{column} {label}: {ratio} of the "
                                   f"tolerance")
            if column.startswith(("parent", "change")):
                if label not in first:
                    first[label] = got
                elif column.startswith("change"):
                    same_bits[label].append(torch.equal(got, first[label]))
            results[label][column] = timed(lambda: kernel(*a, **kw))
            devices[label][column] = device_ms(lambda: kernel(*a, **kw))
            spans[label][column] = profile_calls(
                torch, lambda: kernel(*a, **kw),
                ("flash_kernel", "flash_merge_kernel"), timed.flush.zero_,
                calls=100)[1]
            hosts[label][column] = host_us(lambda: kernel(*a, **kw))

    def device_ms(fn, calls=20) -> float:
        """Device time of one call: the flash kernels it launches (the
        split pass, and a parent's kernel M), from the profiler's trace of
        `calls` calls, each after an L2 flush."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        ours = []
        for _ in range(3):      # a trace that lost kernels is taken again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    timed.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            ours = [ev for ev in prof.key_averages()
                    if "flash_kernel" in ev.key
                    or "flash_merge_kernel" in ev.key]
            if sum(ev.count for ev in ours) >= calls:
                break
        us = sum(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
                 for ev in ours)
        return us / calls / 1e3

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

    sources = {"parent": Path(args.parent),
               "change": cuda.CSRC / "flash_attention.cu"}
    (ROOT / "build").mkdir(exist_ok=True)
    results = {label: {} for label, *_ in cases}
    hosts = {label: {} for label, *_ in cases}
    devices = {label: {} for label, *_ in cases}
    spans = {label: {} for label, *_ in cases}
    package_split = flash_merge.SPLIT
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
            run_all(results, f"{version}_{turn}")
        cuda._libs["flash_attention"] = libs["change"]
        splits = [int(x) for x in args.splits.split(",") if x]
        for i, rows in enumerate(splits + splits[::-1]):
            flash_merge.SPLIT = rows
            run_all(results, f"split{rows}_{i}")
        flash_merge.SPLIT = package_split
        cuda._libs.pop("flash_attention")

    print(card)
    for label, row in results.items():
        print(f"{label:24s}" + "  ".join(f"{k} {v:.4f}"
                                         for k, v in row.items()) + "  (ms)")
        print(f"{'':24s}" + "  ".join(f"{k} {v:.4f}" for k, v in
                                      devices[label].items())
              + "  (device ms)")
        print(f"{'':24s}" + "  ".join(f"{k} {v:.4f}" for k, v in
                                      spans[label].items())
              + "  (span ms: first kernel's start to the last one's end)")
        print(f"{'':24s}" + "  ".join(f"{k} {v:.1f}"
                                      for k, v in hosts[label].items())
              + f"  (host us a call)  change == parent bit for bit: "
              f"{all(same_bits[label])}")
    print(json.dumps(dict(card=card, split=package_split, ms=results,
                          device_ms=devices, span_ms=spans,
                          host_us=hosts,
                          same_bits={k: all(v) for k, v in
                                     same_bits.items()})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
