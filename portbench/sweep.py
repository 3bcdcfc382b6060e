"""Find the highest session rate an open-loop cell sustains: one run at each
rate in one process, printing for each the sessions due and finished in
the window, the backlog (sessions due that had no slot yet) at the
window's two ends, and the end-to-end metrics.  A rate is sustained where
the backlog does not grow across the window (`sustained`).

    python3 -m portbench.sweep --workload <name> --rates 0.3,0.5,0.7 \\
        --seconds 40 --seed 1 [--out FILE]

The cell's mix file then takes four fifths of the highest rate sustained
as its `sessions_per_s`.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from portbench.run import run_cell
    from portbench.spec import load_cell

    cell = load_cell(args.workload, Path.cwd())
    out = open(args.out, "a") if args.out else None
    for rate in [float(r) for r in args.rates.split(",")]:
        c = copy.copy(cell)
        c.traffic = dict(cell.traffic, sessions_per_s=rate)
        res = run_cell(c, args.seed, args.seconds, False, "cuda")
        info = res["_info"]
        row = dict(workload=args.workload, rate=rate, seed=args.seed,
                   sessions_due=info.get("sessions_due"),
                   sessions_done=info.get("sessions_done"),
                   backlog=info.get("backlog"),
                   turns_due=info["turns_due"], failed=res["failed"],
                   metrics={k: v["value"] for k, v in res["metrics"].items()},
                   late=info.get("generator_late_ms"),
                   correct=res["correct"],
                   widest_gap=res["check"]["widest_gap"]["value"])
        b0, b1 = info.get("backlog") or (0, 0)
        row["sustained"] = b1 <= max(1, b0)
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
