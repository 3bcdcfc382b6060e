"""One batched decode step of Phi-3.5-mini Q4_0 (the benchmark's
configuration, cut to --layers) eager and replayed as the scheduler's CUDA
graph (`models.transformer.DecodeGraph`), on the card.

    python3 scripts/torch_decode_graph_probe.py [--layers 8] [--lanes 64]
        [--ctx 3000]

The lanes sit at --ctx rows of random bf16 K/V on pages of their own.
Prints, in turns (eager, graph, graph, eager), the CUDA-event device time
and the host's launch time a step; then, under `torch.profiler`, the
device time a step by kind (J's split pass, M, the quantized products,
the rest) in each mode; then the captured graph's edges by (from port, to
port, type): type 1 is a programmatic edge (J's split pass to kernel M,
a programmatic dependent launch).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lmrs_tpu_torch.models.transformer import (DecodeGraph,  # noqa: E402
                                               forward_batched, init_kv_pool)
from portbench import serving  # noqa: E402

PSZ = 512


def edges(graph: torch.cuda.CUDAGraph) -> dict:
    """The graph's edges counted by (from port, to port, type), read with
    libcuda's cuGraphGetEdges_v2."""
    cu = ctypes.CDLL("libcuda.so.1")
    fn = cu.cuGraphGetEdges_v2
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    raw, n = graph.raw_cuda_graph(), ctypes.c_size_t(0)
    if fn(raw, None, None, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetEdges_v2 failed")
    frm, to = (ctypes.c_void_p * n.value)(), (ctypes.c_void_p * n.value)()
    data = (ctypes.c_ubyte * (8 * n.value))()
    if fn(raw, frm, to, data, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetEdges_v2 failed")
    out = {}
    for i in range(n.value):
        key = str(tuple(data[8 * i:8 * i + 3]))
        out[key] = out.get(key, 0) + 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--ctx", type=int, default=3000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    conf = json.loads((ROOT / "portbench/configs/phi35-mini-q4.json")
                      .read_text())
    conf["num_hidden_layers"] = args.layers
    dev = torch.device("cuda")
    cfg, _, params = serving.build_text(conf, 7, dev)
    b = args.lanes
    maxp = -(-(conf["max_context"] + 8 + 256) // PSZ)
    per = -(-(args.ctx + 16) // PSZ)
    cache = init_kv_pool(cfg, dev, 1 + b * per, PSZ)
    gen = torch.Generator(device=dev).manual_seed(1)
    for t in (cache.k, cache.v):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.5)
    table = torch.zeros((b, maxp), dtype=torch.int32, device=dev)
    for i in range(b):
        table[i, :per] = torch.arange(1 + i * per, 1 + (i + 1) * per)
    toks = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=dev)
    pos = torch.full((b,), args.ctx, dtype=torch.int32, device=dev)
    dg = DecodeGraph(params, cfg)

    def step(mode):
        if mode == "eager":
            return forward_batched(params, cfg, cache, toks, pos, table=table)
        return dg(cache, toks, pos, table)

    print(torch.cuda.get_device_name(0), f"{args.layers} layers, {b} lanes "
          f"at {args.ctx} rows")
    with torch.no_grad():
        step("graph")                    # eager, then the capture
        torch.cuda.synchronize()
        for mode in ("eager", "graph", "graph", "eager"):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            for _ in range(20):
                step(mode)
            e1.record()
            host = (time.perf_counter() - t0) / 20
            torch.cuda.synchronize()
            print(f"{mode}: {e0.elapsed_time(e1) / 20:.3f} ms a step, host "
                  f"launch {1e3 * host:.3f} ms")
        from torch.profiler import ProfilerActivity, profile

        for mode in ("eager", "graph"):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    step(mode)
                torch.cuda.synchronize()
            kinds = {}
            for e in prof.events():
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                k = ("J split pass" if "flash_kernel" in e.name else
                     "M" if "flash_merge" in e.name else
                     "quantized products" if "qgemm" in e.name else "rest")
                kinds[k] = kinds.get(k, 0.0) + e.time_range.elapsed_us() / 1e4
            print(f"{mode}: device ms a step "
                  f"{json.dumps({k: round(v, 3) for k, v in kinds.items()})}")
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=torch.cuda.Stream()):
            forward_batched(params, cfg, cache, toks, pos, table=table)
    print("graph edges by (from port, to port, type):", edges(graph),
          f"({args.layers} decode attention calls)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
