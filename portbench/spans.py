"""The port's own host spans and request times, as the per-layer readers
see them.

The batched scheduler keeps a bounded ring of span records
(`BatchScheduler.spans`: `(name, t0_ns, t1_ns, rid, n, profiled)` on
`time.perf_counter_ns()`'s clock) and stamps each request with
`submit_time`, `admit_time` and `first_time` (seconds on the same clock).
The readers take the unprofiled part of a traced run's window, [w0, t_p):
t_p is the start of the first span recorded while the profiler ran (w1 if
none did), so the profiler's host overhead stays out.  A span belongs to
the range in which it ends, as the port's counters count a decode chunk
when it ends.

`window` is None, and every reader with it, without a recorder, with a
program that keeps no ring, or when the ring's oldest record started after
w0 (it overflowed and lost part of the range)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

NAME, T0, T1, RID, N, PROFILED = range(6)


@dataclasses.dataclass
class Window:
    records: List[tuple]          # the spans that end inside [lo, hi)
    lo: float                     # w0, seconds
    hi: float                     # t_p, seconds
    batch: int                    # the scheduler's lanes
    requests: list                # the scheduler's Request of each turn

    def named(self, name: str) -> List[tuple]:
        return [r for r in self.records if r[NAME] == name]

    def inside(self, t: Optional[float]) -> bool:
        return t is not None and self.lo <= t < self.hi


def window(ctx) -> Optional[Window]:
    sched = getattr(ctx.recorder, "sched", None)
    ring = getattr(sched, "spans", None)
    if ring is None:
        return None
    recs = list(ring)
    lo_ns, hi_ns = ctx.w0 * 1e9, ctx.w1 * 1e9
    if not recs or recs[0][T0] > lo_ns:
        return None
    hi_ns = min([hi_ns] + [r[T0] for r in recs
                           if r[PROFILED] and r[T0] >= lo_ns])
    return Window(records=[r for r in recs if lo_ns <= r[T1] < hi_ns],
                  lo=ctx.w0, hi=hi_ns * 1e-9, batch=sched.B,
                  requests=[r.req for r in ctx.recs if r.req is not None])


def seconds(rec: tuple) -> float:
    return (rec[T1] - rec[T0]) * 1e-9
