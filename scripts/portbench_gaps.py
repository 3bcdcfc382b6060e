"""Run one benchmark cell as `python3 -m portbench.run` does, with the
traced run's idle gaps listed in full in its result line's `breakdown`:
every host span's name (not the ten longest), and the gaps inside each of
`model.decode_step`, `sched.decode`, `scheduler.step` and `sched.tick`
by the innermost span at the gap's middle.

    python3 scripts/portbench_gaps.py --workload <name> --seed <n> \\
        --seconds 51 --trace 1

From the root of a checkout (or of another tree with `portbench/`); the
arguments are `portbench.run`'s."""

import bisect
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))

import portbench.trace as T  # noqa: E402

_breakdown = T.breakdown
OUTER = ("model.decode_step", "sched.decode", "scheduler.step", "sched.tick")


def breakdown(tr, top=10):
    out = _breakdown(tr, top=1 << 20)
    busy = tr.busy_intervals()
    starts = [s[0] for s in tr.spans]
    for outer in OUTER:
        box = sorted((a, b) for a, b, n in tr.spans if n == outer)
        los = [a for a, _ in box]
        by = defaultdict(float)
        for (_, a), (b, _) in zip(busy, busy[1:]):
            m = 0.5 * (a + b)
            i = bisect.bisect_right(los, m) - 1
            if i >= 0 and box[i][0] <= m <= box[i][1]:
                by[T._host_at(tr.spans, starts, m)] += b - a
        out["gaps_in." + outer] = sorted(([k, v] for k, v in by.items()),
                                         key=lambda kv: -kv[1])
    out["host_spans"] = len(tr.spans)
    return out


if __name__ == "__main__":
    T.breakdown = breakdown
    from portbench.run import main

    sys.exit(main())
