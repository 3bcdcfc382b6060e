"""The output check's readings over many seeds, in one process: each seed's
run of a cell (a short window at the cell's own load), its widest gap (the
lower reading's samples), and the controls' readings on the same sample.

    python3 -m portbench.study --workload <name> --seeds a,b,c --seconds 30 \\
        [--controls cache_int8,kv_int8,kv_fp8,act_fp8] [--out FILE]

Controls: `cache_int8` is the program with its own int8 KV pool switched
on (the configuration states bf16), run and checked as the cell is: the
control that has to come out not correct; `act_int8`, `act_fp8`,
`kv_int8`, `kv_fp8` are the plain reference in a lower precision put in
the program's place, fed the served tokens, read at the token it puts
first.  Each control's readings are judged by `check.verdict`, as a run's
are (`correct` in its entry).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path


def program_teacher_forced(cell, weights, picked):
    """A diagnostic of the port's own logit error: its single-stream
    forward (bf16 cache, 256-row chunks, every row's logits) over each
    sampled turn's sequence; the reference's gap of the port's first
    token at each served row, and the largest |port - reference| logit."""
    import torch

    from lmrs_tpu_torch.models.transformer import forward, init_kv_cache
    from portbench import arch as A
    from portbench import check as C

    mod = A.load(cell.config["model_type"])
    cfg = mod.port_config(cell.config)
    params = mod.port_params(cfg, weights)
    model, _ = C.reference(cell.config, weights)
    gaps, err = [], 0.0
    for r in picked:
        seq = list(r.context) + list(r.spec.prompt) + list(r.out[:-1])
        first = len(r.context) + len(r.spec.prompt) - 1
        rows = list(range(first, first + len(r.out)))
        cache = init_kv_cache(cfg, "cuda", torch.bfloat16,
                              seq_len=len(seq) + 256)
        ids = torch.as_tensor(seq, device="cuda")
        with torch.no_grad():
            lg = torch.cat([forward(params, cfg, cache, ids[p:p + 256], p,
                                    logit_idx="all")
                            for p in range(0, len(seq), 256)])[rows]
        ref = model.logits(seq, rows, "cuda")
        pick = lg.argmax(dim=1)
        gaps += (ref.max(dim=1).values
                 - ref.gather(1, pick[:, None])[:, 0]).tolist()
        err = max(err, (lg - ref).abs().max().item())
        del cache
    return gaps, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", default="")
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from portbench import check as C
    from portbench.run import run_cell
    from portbench.spec import load_cell

    cell = load_cell(args.workload, Path.cwd())
    controls = [c for c in args.controls.split(",") if c]
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        res = run_cell(cell, seed, args.seconds, bool(args.trace), "cuda",
                       keep=True)
        weights, picked, served = res.pop("_sample")
        row = dict(workload=args.workload, seed=seed,
                   correct=res["correct"], check=res["check"],
                   metrics=res["metrics"], device=res["device"],
                   info=res["_info"], sample_turns=len(picked),
                   sound_widest=max(served) if served else None,
                   sound_mean=sum(served) / len(served) if served else None)
        for ctl in controls:
            t1 = time.perf_counter()
            if ctl == "program_tf":
                got, err = program_teacher_forced(cell, weights, picked)
                row["program_tf_max_logit_error"] = err
            elif ctl == "cache_int8":
                c2 = copy.copy(cell)
                c2.config = copy.deepcopy(cell.config)
                c2.config["serve"]["cache_dtype"] = "int8"
                r2 = run_cell(c2, seed, args.seconds, False, "cuda",
                              keep=True)
                got = r2.pop("_sample")[2]
            else:
                what, prec = ctl.split("_")
                kw = {"act_quant" if what == "act" else "kv_quant": prec}
                model, mod = C.reference(cell.config, weights)
                low, _ = C.reference(cell.config, weights, **kw)
                got = []
                for r in picked:
                    got += mod.control_gaps(model, low, r.context,
                                            r.spec.prompt, r.out,
                                            "cuda").tolist()
                del model, low      # they hold this seed's weights
            checks = C.verdict(cell.config, got)
            row[ctl] = dict(widest=max(got) if got else None,
                            mean=sum(got) / len(got) if got else None,
                            n=len(got),
                            correct=all(c["ok"] for c in checks.values()),
                            seconds=time.perf_counter() - t1)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
        del weights, picked, served, res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
