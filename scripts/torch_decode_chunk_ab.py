#!/usr/bin/env python3
"""The single-stream decode loop before and after the chunked decode, side
by side on one card: `Engine.decode_step` a token at a host position (the
per-token loop `Engine.generate` ran before decode chunks) against
`Engine._decode_chunk` (`runtime.engine.decode_chunk` and its history
write) of 1 and of 8 steps at a device position.

    python3 scripts/torch_decode_chunk_ab.py [--model llama3.2-3b]
        [--quant Q8_0] [--cache-dtype bfloat16,int8,int4] [--layers N]
        [--tokens 64] [--prompt 1024] [--turns 3] [--lmrs PATH]

Writes a synthetic .lmrs of the preset (seed 0) under build/ unless
`--lmrs` names one, loads it onto the GPU, prefills a `--prompt`-token
prompt and decodes `--tokens` greedy tokens in each mode, with no host read
until the end (the token stays on the device, as both loops keep it), in
`--turns` turns of the modes in order and reversed (step, chunk 1, chunk
8, chunk 8, chunk 1, step, ...).  Prints per cache type and mode the
median and every turn's decode tok/s (host clock from the first dispatch
to the synchronized end) and host ms a token spent dispatching (the host
clock until the last launch returns), and fails unless every mode gives
the step loop's tokens bit for bit.  The card's name and power limit come
first, one JSON line of the numbers last.  Needs one CUDA device (or
`--device cpu` to rehearse the control flow: its times are the CPU's, not
a device metric).
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODES = ("step", "chunk 1", "chunk 8")


def decode(torch, engine, mode, prompt, n_tokens):
    """(tokens, tok/s, host ms a token dispatching) of one greedy run."""
    from lmrs_tpu_torch.ops.sampling import sample
    from lmrs_tpu_torch.runtime.engine import GenerationConfig

    sync = (torch.cuda.synchronize if engine.device.type == "cuda"
            else (lambda: None))
    engine.reset()
    with torch.no_grad():
        tok = torch.argmax(engine.prefill(prompt)).reshape(1)
        sync()
        t0 = time.perf_counter()
        out = []
        if mode == "step":
            for _ in range(n_tokens):
                tok = sample(engine.decode_step(tok), 0.0, 1.0,
                             None).reshape(1)
                out.append(tok)
        else:
            n = int(mode.split()[1])
            gen = GenerationConfig(temperature=0.0)
            for _ in range(n_tokens // n):
                toks = engine._decode_chunk(tok, engine.pos, n, gen, None, 0)
                engine.pos += n
                tok = toks[-1:]
                out.append(toks)
        t_host = time.perf_counter() - t0
        toks = torch.cat(out).tolist()
        sync()
        t_all = time.perf_counter() - t0
    return toks, n_tokens / t_all, 1e3 * t_host / n_tokens


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama3.2-3b")
    ap.add_argument("--quant", default="Q8_0", choices=["Q4_0", "Q8_0"])
    ap.add_argument("--cache-dtype", dest="caches",
                    default="bfloat16,int8,int4")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the preset to N layers (full width)")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--prompt", type=int, default=1024,
                    help="prompt tokens prefilled before each run")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--lmrs", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from lmrs_tpu_torch.config import PRESETS, QuantType
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import params_from_lmrs
    from lmrs_tpu_torch.io.synthetic import write_synthetic_lmrs
    from lmrs_tpu_torch.runtime.engine import Engine

    card = "cpu (a rehearsal: no device metric)"
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chunk_ab_",
                                 dir=str(ROOT / "build")))
    try:
        path = Path(args.lmrs) if args.lmrs else work / "model.lmrs"
        cfg = PRESETS[args.model](quant=QuantType[args.quant])
        if args.layers:
            cfg = cfg.replace(n_layers=args.layers)
        if not path.exists():
            write_synthetic_lmrs(str(path), cfg)
        f = read_lmrs(str(path))
        params = params_from_lmrs(f, device=args.device)
        gen = torch.Generator().manual_seed(0)
        prompt = torch.randint(0, f.cfg.vocab_size, (args.prompt,),
                               generator=gen).tolist()
        results = {}
        for cache in args.caches.split(","):
            engine = Engine(f.cfg, params, device=args.device,
                            cache_dtype=cache)
            decode(torch, engine, "chunk 8", prompt, 8)     # warm-up
            runs = {m: dict(tok_s=[], host_ms=[]) for m in MODES}
            want = None
            for turn in range(args.turns):
                for mode in MODES if turn % 2 == 0 else MODES[::-1]:
                    toks, tok_s, host_ms = decode(torch, engine, mode,
                                                  prompt, args.tokens)
                    if want is None:
                        want = toks
                    if toks != want:
                        raise RuntimeError(f"{cache} {mode}: tokens {toks} "
                                           f"differ from {want}")
                    runs[mode]["tok_s"].append(tok_s)
                    runs[mode]["host_ms"].append(host_ms)
            for mode, r in runs.items():
                print(f"{args.model} {args.quant} {f.cfg.n_layers} layers, "
                      f"{cache} cache, {mode}: decode "
                      f"{statistics.median(r['tok_s']):.2f} tok/s "
                      f"(turns {[round(v, 2) for v in r['tok_s']]}), host "
                      f"{statistics.median(r['host_ms']):.3f} ms a token "
                      f"dispatching "
                      f"(turns {[round(v, 3) for v in r['host_ms']]})",
                      flush=True)
            results[cache] = runs
            del engine
        print(json.dumps(dict(card=card, model=args.model, quant=args.quant,
                              layers=f.cfg.n_layers, tokens=args.tokens,
                              results=results)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
