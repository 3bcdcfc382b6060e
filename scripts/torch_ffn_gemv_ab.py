#!/usr/bin/env python3
"""Two versions of kernel A (`q4_gemv.cu`), of kernels K and L
(`ffn_fused.cu`) and of kernel D (`q8_gemv_i8.cu`) side by side on one
card: did a change to a source move them?

    python3 scripts/torch_ffn_gemv_ab.py --parent DIR [--only a,k,l,d]
        [--ts 1,2,4,5,8] [--ffn-ts 9,12,16] [--xe-ts 1,5,8]

DIR holds the other version's sources of the kernels compared
(`q4_gemv.cu`, `ffn_fused.cu` with any header it includes, `q8_gemv_i8.cu`
with any header it includes), e.g. `git show <commit>:lmrs_tpu_torch/csrc/
q4_gemv.cu > DIR/q4_gemv.cu`.  Both versions build with the package's nvcc
flags; the change is the tree's `lmrs_tpu_torch/csrc`.  Cases:

- A at the five matmuls (wqkv, wo, w13, w2, classifier) of Gemma-2-9B,
  Llama-3.2-3B and Phi-3.5-mini as Q4_0 (group size 128), at every T of
  `--ts`; held against `q4_gemv_plain` within 1e-4 of the output scale;
- D at the four layer matmuls (wqkv, wo, w13, w2) of the same models as
  Q8_0 (group size 128), at every T of `--ts`; held against
  `q8_gemv_i8_plain` within 1e-4 of the output scale.  A parent whose entry
  point takes the quantizer's scratch (x, xq, xs, q, s, y, ...: the two
  launches of the pre-pass design) is called with it, allocated a call as
  its wrapper did;
- L at Gemma-2-9B's FFN (Q4_0, tanh-GELU) and Llama-3.2-3B's (Q8_0, silu)
  at every T of `--ffn-ts`, K at the same FFNs at every T of `--xe-ts`;
  held against their plain versions within 1e-3 of the output scale.  K's
  own yardstick beside the library's: the unfused pair, A (Q4_0) or D
  (Q8_0) on W13 and on W2 at the same T (timer, device time and span),
  which says whether `fuse_ffn` is worth having.  For K also each call's span
  (its first kernel's start to its last one's end, median of 20 calls):
  its second launch is a programmatic dependent launch whose blocks wait
  inside the kernel, so the sum of its device times overstates the call.

Each case is timed in the order parent, change, change, parent, so that
drift within the call shows as a difference between the two runs of one
version: `chip_smoke.Timer` (median of 50 calls, 128 MB of L2 flushed
before each: its window holds the host's time where a call is shorter),
the device time of one call (torch.profiler over 20 calls, each after the
same flush: the sum of the call's kernels' device time, PyTorch's own
kernels left out) and the host's time per call (200 calls enqueued back to
back, median of 5).  Beside them: the library yardstick (A and D: one
`torch.matmul` of bf16 x and the pre-dequantized bf16 weights; D also
`torch._int_mm` of int8 x and the int8 weights, x padded to 17 rows, the
fewest it takes; K and L: the unfused chain of PyTorch calls, as
chip_smoke.py's; for D also the device time of both, every kernel of the
call but the flush's) and the bound (A: the packed weights, scales, f32 x and y
once each over 3.35 TB/s, or three bf16 slices of x through the tensor
cores at 989 TFLOP/s; D: int8 weights, scales, f32 x and y over 3.35
TB/s, or 2*T*O*K at 1,979 TOP/s; K and L: weights, scales, x and y over
3.35 TB/s, or 2*T*3*H*D at 989 TFLOP/s; the larger).  Then the per-token
units: for each model and T, A's layers x (wqkv, wo, w13, w2) + the
classifier, D's layers x (wqkv, wo, w13, w2), from the timer and from the
device times; for K, a token's FFNs (the model's layers x one call).
Prints the card's name and power limit, one line per case and one JSON
line.  Needs one CUDA device and nvcc.
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
PHI = dict(name="phi3.5-mini", D=3072, HID=8192, L=32, H=32, KH=32, HD=96,
           V=32064)
TURNS = ("parent", "change", "change", "parent")
# the kernels of A, K, L and D (and D's parent's quantizer pre-pass) by
# the names the profiler sees; K's two launches (ffn_xe_kernel), or an
# older K's one (ffn_kernel)
OURS = ("q4_gemv", "ffn_xe_kernel", "ffn_kernel", "qgemm_kernel",
        "q8_gemv_i8", "q8_act_quant")
# the library source of each kernel letter
SOURCE = {"a": "q4_gemv", "k": "ffn_fused", "l": "ffn_fused",
          "d": "q8_gemv_i8"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True,
                    help="directory of the other q4_gemv.cu and ffn_fused.cu")
    ap.add_argument("--only", default="a,k,l,d",
                    help="kernels to compare: a, k, l, d")
    ap.add_argument("--ts", default="1,2,4,5,8", help="A's and D's rows "
                    "of x")
    ap.add_argument("--parent-d-abi", dest="parent_d_abi", default="plain",
                    choices=("plain", "scratch"),
                    help="the parent lmrs_q8_gemv_i8's arguments: plain "
                         "(x, q, s, y, ...) or scratch (x, xq, xs, q, s, y, "
                         "...: the pre-pass design)")
    ap.add_argument("--ffn-ts", dest="ffn_ts", default="9,12,16",
                    help="L's rows of x")
    ap.add_argument("--xe-ts", dest="xe_ts", default="1,2,4,5,8",
                    help="K's rows of x")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (GEMMA, LAYER_SHAPES, LLAMA, PEAKS, Timer,
                            bound_ms, matmul_shapes, profile_calls,
                            random_q4, random_q8)
    from lmrs_tpu_torch.kernels import cuda
    from lmrs_tpu_torch.kernels.ffn_fused import (ffn_fused, ffn_fused_plain,
                                                  ffn_fused_xe,
                                                  ffn_fused_xe_plain)
    from lmrs_tpu_torch.kernels.q4_gemm import dequant_bf16 as dequant_q4
    from lmrs_tpu_torch.kernels.q4_gemv import q4_gemv, q4_gemv_plain
    from lmrs_tpu_torch.kernels.q8_gemm import dequant_bf16 as dequant_q8
    from lmrs_tpu_torch.kernels.q8_gemv_i8 import (q8_gemv_i8,
                                                   q8_gemv_i8_plain)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    peak = PEAKS[torch.cuda.get_device_name(0)]
    cuda.plain_numerics()
    timed = Timer(torch)
    only = set(args.only.split(","))
    ts = [int(t) for t in args.ts.split(",")]

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

    seen = []

    def device_ms(fn, calls=20, library=False) -> float:
        """Device time of one call: the kernels it launches (ours, or with
        `library` every kernel but the flush's), from the profiler's trace
        of `calls` calls, each after an L2 flush."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        for _ in range(3):      # a trace that lost kernels is taken again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    timed.flush.zero_()
                    fn()
                torch.cuda.synchronize()
            ours = [ev for ev in prof.key_averages()
                    if (library and "FillFunctor" not in ev.key)
                    or (not library and any(key in ev.key for key in OURS))]
            if not seen and not library:   # the names the profiler gives
                # once
                seen.extend(ev.key for ev in ours)
                print("profiled kernel names: " + "; ".join(seen),
                      flush=True)
            if sum(ev.count for ev in ours) >= calls:
                break
        us = sum(getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
                 for ev in ours)
        return us / calls / 1e3

    def turns(row, name, fn, check, span_keys=None):
        """Time `fn` under both versions of library `name` in turns (`fn`
        a callable, or version -> callable where the versions' entry
        points differ); with `span_keys` (kernel names), also a call's
        span on the profiler's clock (a programmatic dependent launch
        waits inside the kernel, so the sum of device times overstates
        it)."""
        row.update(ms={}, device_ms={}, host_us={})
        if span_keys:
            row["span_ms"] = {}
        for turn, version in enumerate(TURNS):
            cuda._libs[name] = libs[(name, version)]
            run = fn[version] if isinstance(fn, dict) else fn
            check(version, run)
            col = f"{version}_{turn}"
            row["ms"][col] = timed(run)
            row["device_ms"][col] = device_ms(run)
            if span_keys:
                row["span_ms"][col] = profile_calls(
                    torch, run, span_keys, timed.flush.zero_)[1]
            row["host_us"][col] = host_us(run)
        cuda._libs.pop(name)
        for key in ("ms", "device_ms") + (("span_ms",) if span_keys else ()):
            par = min(row[key]["parent_0"], row[key]["parent_3"])
            chg = max(row[key]["change_1"], row[key]["change_2"])
            row[f"parent_over_change_{key}"] = par / chg

    def show(label, row):
        print(f"{label}: "
              + "  ".join(f"{c} {v:.4f}" for c, v in row["ms"].items())
              + "  device " + " ".join(f"{v:.4f}"
                                       for v in row["device_ms"].values())
              + ("  span " + " ".join(f"{v:.4f}"
                                      for v in row["span_ms"].values())
                 if "span_ms" in row else "")
              + f"  library {row['library_ms']:.4f}"
              + (f"  unfused pair {row['pair_ms']:.4f} (device "
                 f"{row['pair_device_ms']:.4f}, span "
                 f"{row['pair_span_ms']:.4f})" if "pair_ms" in row else "")
              + (f"  _int_mm {row['int_mm_ms']:.4f} (device: library "
                 f"{row['library_device_ms']:.4f}, _int_mm "
                 f"{row['int_mm_device_ms']:.4f})" if "int_mm_ms" in row
                 else "")
              + f"  bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']})  x "
              f"{row['parent_over_change_ms']:.2f} (device "
              f"{row['parent_over_change_device_ms']:.2f})  host us "
              + " ".join(f"{v:.1f}" for v in row["host_us"].values()),
              flush=True)

    def d_cases(libs, results):
        """D at the three models' Q8 layer shapes, every T of --ts."""
        import ctypes

        def parent_d(x, q, s, gs):
            """The parent's entry point with its own arguments."""
            fn = libs[("q8_gemv_i8", "parent")].lmrs_q8_gemv_i8
            p, i = ctypes.c_void_p, ctypes.c_int
            t, k = x.shape
            o = q.shape[0]
            y = torch.empty((t, o), dtype=torch.float32, device=x.device)
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if args.parent_d_abi == "scratch":
                fn.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
                xq = torch.empty((t, k), dtype=torch.int8, device=x.device)
                xs = torch.empty((t, k // gs), dtype=torch.float32,
                                 device=x.device)
                err = fn(x.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                         q.data_ptr(), s.data_ptr(), y.data_ptr(), t, o, k,
                         gs, stream)
            else:
                fn.argtypes = [p, p, p, p, i, i, i, i, p]
                err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                         y.data_ptr(), t, o, k, gs, stream)
            cuda.check(err, "parent q8_gemv_i8")
            return y

        for model in (GEMMA, LLAMA, PHI):
            for shape in LAYER_SHAPES:
                o, k = matmul_shapes(model)[shape]
                q, s = random_q8(torch, gen, o, k)
                w_lib = dequant_q8(q, s, GS)
                qt = q.t()
                for t in ts:
                    x = torch.randn(t, k, device="cuda", generator=gen)
                    xl = x.to(torch.bfloat16)
                    xi = torch.randint(-127, 128, (max(t, 17), k),
                                       dtype=torch.int8, device="cuda",
                                       generator=gen)
                    want = q8_gemv_i8_plain(x, q, s, GS)
                    scale = want.abs().max().item()

                    def check(version, run):
                        got = run()
                        torch.cuda.synchronize()
                        err = (got - want).abs().max().item() / scale
                        if not err <= 1e-4:
                            raise RuntimeError(
                                f"{version} q8_gemv_i8 {model['name']} "
                                f"{shape} T={t}: {err} of the output scale")

                    row = dict(kernel="q8_gemv_i8", model=model["name"],
                               shape=shape, T=t, O=o, K=k)
                    turns(row, "q8_gemv_i8",
                          {"parent": lambda: parent_d(x, q, s, GS),
                           "change": lambda: q8_gemv_i8(x, q, s, GS)},
                          check)
                    lib = lambda: torch.matmul(xl, w_lib.t())   # noqa: E731
                    imm = lambda: torch._int_mm(xi, qt)         # noqa: E731
                    row["library_ms"] = timed(lib)
                    row["int_mm_ms"] = timed(imm)
                    row["library_device_ms"] = device_ms(lib, library=True)
                    row["int_mm_device_ms"] = device_ms(imm, library=True)
                    nbytes = o * k + 4 * o * k / GS + 4 * t * k + 4 * t * o
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        nbytes, 2.0 * t * o * k, peak["int8"], peak["mem"])
                    results.append(row)
                    show(f"q8_gemv_i8 {model['name']:12s} {shape:10s} "
                         f"T={t}", row)
                del q, s, w_lib, qt
                torch.cuda.empty_cache()

    (ROOT / "build").mkdir(exist_ok=True)
    results = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as tmp:
        libs = {}
        builds = []
        for version, src in (("parent", Path(args.parent)),
                             ("change", cuda.CSRC)):
            for name in sorted({SOURCE[c] for c in only}):
                lib = Path(tmp) / f"lib{name}_{version}.so"
                builds.append((name, version, lib, subprocess.Popen(
                    [cuda._nvcc(), *cuda.NVCC_FLAGS, "-o", str(lib),
                     str(src / f"{name}.cu")], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT)))
        for name, version, lib, proc in builds:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc {version} {name}.cu:\n"
                                   + log.decode(errors="replace"))
            libs[(name, version)] = ctypes.CDLL(str(lib))

        if "a" in only:
            for model in (GEMMA, LLAMA, PHI):
                for shape, (o, k) in matmul_shapes(model).items():
                    q, s = random_q4(torch, gen, o, k)
                    w_lib = dequant_q4(q, s, GS)
                    for t in ts:
                        x = torch.randn(t, k, device="cuda", generator=gen)
                        xl = x.to(torch.bfloat16)
                        want = q4_gemv_plain(x, q, s, GS)
                        scale = want.abs().max().item()

                        def check(version, run):
                            got = run()
                            torch.cuda.synchronize()
                            err = (got - want).abs().max().item() / scale
                            if not err <= 1e-4:
                                raise RuntimeError(
                                    f"{version} q4_gemv {model['name']} "
                                    f"{shape} T={t}: {err} of the output "
                                    f"scale")

                        row = dict(kernel="q4_gemv", model=model["name"],
                                   shape=shape, T=t, O=o, K=k)
                        turns(row, "q4_gemv", lambda: q4_gemv(x, q, s, GS),
                              check)
                        row["library_ms"] = timed(
                            lambda: torch.matmul(xl, w_lib.t()))
                        nbytes = (0.5 * o * k + 4 * o * k / GS + 4 * t * k
                                  + 4 * t * o)
                        row["bound_ms"], row["bound_by"] = bound_ms(
                            nbytes, 3 * 2.0 * t * o * k, peak["bf16"],
                            peak["mem"])
                        results.append(row)
                        show(f"q4_gemv {model['name']:12s} {shape:10s} "
                             f"T={t}", row)
                    del q, s, w_lib
                    torch.cuda.empty_cache()

        if "d" in only:
            d_cases(libs, results)

        ffn_plan = []
        if "l" in only:
            ffn_plan += [("ffn_fused", ffn_fused, ffn_fused_plain, t)
                         for t in (int(v) for v in args.ffn_ts.split(","))]
        if "k" in only:
            ffn_plan += [("ffn_fused_xe", ffn_fused_xe, ffn_fused_xe_plain,
                          t) for t in (int(v) for v in args.xe_ts.split(","))]
        for model, quant, act in ((GEMMA, "q4", "gelu"),
                                  (LLAMA, "q8", "silu")):
            if not ffn_plan:
                break
            d, h = model["D"], model["HID"]
            make = random_q4 if quant == "q4" else random_q8
            dequant = dequant_q4 if quant == "q4" else dequant_q8
            w = [*make(torch, gen, 2 * h, d), *make(torch, gen, d, h)]
            w13d, w2d = dequant(w[0], w[1], GS), dequant(w[2], w[3], GS)
            wbytes = ((0.5 if quant == "q4" else 1.0) * 3 * h * d
                      + 4 * 3 * h * d / GS)

            def chain(xb):
                gu = torch.matmul(xb, w13d.t())
                gate, up = gu[:, :h], gu[:, h:]
                a = (F.gelu(gate, approximate="tanh") if act == "gelu"
                     else F.silu(gate))
                return torch.matmul(a * up, w2d.t())

            for kern, fn, plain, t in ffn_plan:
                x = torch.randn(t, d, device="cuda", generator=gen)
                xb = x.to(torch.bfloat16)
                want = plain(x, *w, GS, act)
                scale = want.abs().max().item()

                def check(version, run):
                    got = run()
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item() / scale
                    if not err <= 1e-3:
                        raise RuntimeError(f"{version} {kern} "
                                           f"{model['name']} T={t}: {err} "
                                           f"of the output scale")

                row = dict(kernel=kern, model=model["name"], shape="ffn",
                           T=t, D=d, H=h, act=act)
                turns(row, "ffn_fused", lambda: fn(x, *w, GS, act), check,
                      ("ffn_xe_kernel", "ffn_kernel")
                      if kern == "ffn_fused_xe" else None)
                row["library_ms"] = timed(lambda: chain(xb))
                if kern == "ffn_fused_xe":
                    # K's yardstick: the unfused path's two calls of A
                    # (Q4_0) or D (Q8_0) on W13 and W2 at the same T
                    gemv = q4_gemv if quant == "q4" else q8_gemv_i8
                    gin = torch.randn(t, h, device="cuda", generator=gen)

                    def pair():
                        gemv(x, w[0], w[1], GS)
                        return gemv(gin, w[2], w[3], GS)

                    row["pair_ms"] = timed(pair)
                    row["pair_device_ms"] = device_ms(pair)
                    row["pair_span_ms"] = profile_calls(
                        torch, pair, ("q4_gemv", "q8_gemv_i8"),
                        timed.flush.zero_)[1]
                row["bound_ms"], row["bound_by"] = bound_ms(
                    wbytes + 8 * t * d, 2.0 * t * 3 * h * d, peak["bf16"],
                    peak["mem"])
                results.append(row)
                show(f"{kern:12s} {model['name']:12s} ffn T={t}", row)
            del w, w13d, w2d
            torch.cuda.empty_cache()

    # the units: a decode step's matmuls of each model at each T (A: the
    # layers and the classifier; D: the layers)
    units = []
    for kern, shapes in (("q4_gemv", LAYER_SHAPES + ("classifier",)),
                         ("q8_gemv_i8", LAYER_SHAPES)):
        for model in (GEMMA, LLAMA, PHI):
            for t in ts:
                mine = {r["shape"]: r for r in results
                        if r["kernel"] == kern
                        and r["model"] == model["name"] and r["T"] == t}
                if len(mine) < len(shapes):
                    continue
                n = {s: (1 if s == "classifier" else model["L"])
                     for s in shapes}
                unit = dict(kernel=kern, model=model["name"], T=t)
                for key in ("ms", "device_ms"):
                    unit[key] = {c: sum(n[s] * mine[s][key][c] for s in n)
                                 for c in mine["wo"][key]}
                for key in ("library_ms", "int_mm_ms", "library_device_ms",
                            "int_mm_device_ms", "bound_ms"):
                    if all(mine[s].get(key) is not None for s in n):
                        unit[key] = sum(n[s] * mine[s][key] for s in n)
                units.append(unit)
                print(f"unit {kern} {model['name']} T={t} ({model['L']} x "
                      f"{'4 + classifier' if len(shapes) == 5 else '4'}): "
                      + "  ".join(f"{c} {v:.3f}"
                                  for c, v in unit["ms"].items())
                      + "  device " + " ".join(
                          f"{v:.3f}" for v in unit["device_ms"].values())
                      + f"  library {unit['library_ms']:.3f}"
                      + (f"  _int_mm {unit['int_mm_ms']:.3f}"
                         if "int_mm_ms" in unit else "")
                      + (f"  (device: library {unit['library_device_ms']:.3f}"
                         f", _int_mm {unit['int_mm_device_ms']:.3f})"
                         if "int_mm_device_ms" in unit else "")
                      + f"  bound {unit['bound_ms']:.3f}", flush=True)
    # K's unit: a decode token's FFNs (the model's layers x one call)
    for model in (GEMMA, LLAMA):
        for r in results:
            if r["kernel"] != "ffn_fused_xe" or r["model"] != model["name"]:
                continue
            n = model["L"]
            unit = dict(kernel="ffn_fused_xe", model=model["name"], T=r["T"])
            for key in ("ms", "device_ms", "span_ms"):
                unit[key] = {c: n * v for c, v in r[key].items()}
            for key in ("library_ms", "pair_ms", "pair_device_ms",
                        "pair_span_ms", "bound_ms"):
                unit[key] = n * r[key]
            units.append(unit)
            print(f"unit ffn_fused_xe {model['name']} T={r['T']} ({n} x 1): "
                  + "  ".join(f"{c} {v:.3f}" for c, v in unit["ms"].items())
                  + "  device " + " ".join(
                      f"{v:.3f}" for v in unit["device_ms"].values())
                  + "  span " + " ".join(
                      f"{v:.3f}" for v in unit["span_ms"].values())
                  + f"  unfused pair {unit['pair_ms']:.3f} (device "
                  f"{unit['pair_device_ms']:.3f}, span "
                  f"{unit['pair_span_ms']:.3f})  library "
                  f"{unit['library_ms']:.3f}  bound {unit['bound_ms']:.3f}",
                  flush=True)
    print(card)
    print(json.dumps(dict(card=card, cases=results, units=units)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
