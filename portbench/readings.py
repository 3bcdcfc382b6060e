"""What the metric readers read: the run's context, and the arithmetic
they share (percentiles, the traced window's forwards and kernels).

The context (`Context`) holds the measured window, each turn's record, the
port's counters at the window's two ends, and, in a traced run, the
device trace and the forwards recorded while it ran (`Recorder`).  What a
forward costs is counted by the module of the configuration's
architecture (`arch/<model_type>.py`)."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from portbench import arch as A
from portbench import roofline as R


@dataclasses.dataclass
class Context:
    cfg: object                   # the port's ModelConfig
    conf: dict                    # the configuration file
    mix: dict                     # the traffic file
    card: str
    w0: float
    w1: float
    setup_s: float
    recs: list                    # drive.Rec, every turn sent
    c0: Dict[str, float]          # the port's counters at w0 and w1
    c1: Dict[str, float]
    trace: object = None          # trace.TraceData of the traced stretch
    recorder: object = None       # Recorder
    spans: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def delta(self, key: str) -> float:
        return self.c1[key] - self.c0[key]

    def due(self):
        return [r for r in self.recs if self.w0 <= r.due < self.w1]

    def peak(self):
        return R.peaks(self.card)

    @property
    def arch(self):
        """The module of the configuration's architecture."""
        return A.load(self.conf["model_type"])

    def arch_counts(self) -> Dict[str, float]:
        """The window's change of each counter the architecture's costs
        name (its `COUNTERS`)."""
        return {k: self.delta(k) for k in A.counters(self.arch)}


def p90(values: List[float]) -> Optional[float]:
    """The nearest-rank 90th percentile (inf counts: a failed turn)."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(0.9 * len(v)) - 1)]


def ttft_p90_ms(ctx: Context) -> Optional[float]:
    """90th percentile, over the turns due inside the window, of (first
    token's delivery - the turn's due time), in ms (host clock); a turn
    that failed or never had a first token counts as infinite."""
    return p90([float("inf") if r.first is None or r.error is not None
                else 1e3 * (r.first - r.due) for r in ctx.due()])


def tpot_p90_ms(ctx: Context) -> Optional[float]:
    """90th percentile, over the turns completed inside the window, of
    (last token - first token) / (tokens - 1), in ms (host clock); a turn
    that failed counts as infinite."""
    vals = []
    for r in ctx.recs:
        if r.done is None or not ctx.w0 <= r.done < ctx.w1:
            continue
        if r.error is not None or len(r.times) < 2:
            vals.append(float("inf"))
        else:
            vals.append(1e3 * (r.times[-1] - r.times[0])
                        / (len(r.times) - 1))
    return p90(vals)


def decode_step_ms(ctx: Context) -> Optional[float]:
    """The scheduler's time a decode step: the port's `decode_seconds`
    (host clock around each decode chunk, its one read included) over its
    `decode_steps`, both over the window, in ms."""
    steps = ctx.delta("decode_steps")
    if steps <= 0:
        return None
    return 1e3 * ctx.delta("decode_seconds") / steps


def least_time_s(ctx: Context, kinds) -> float:
    """The summed least time of the traced stretch's forwards of `kinds`
    (each costed by the architecture's `forward_cost`), and of its other
    device work of `kinds`."""
    arch, peak, counts = ctx.arch, ctx.peak(), ctx.arch_counts()
    total = 0.0
    for f in ctx.recorder.forwards:
        if f["kind"] not in kinds:
            continue
        cost = arch.forward_cost(ctx.cfg, ctx.conf, f, counts)
        total += R.bound_s(cost["bytes"], cost["ops_bf16"],
                           cost["ops_int8"], peak)
    for sp in ctx.recorder.extra_costs:
        if sp["kind"] in kinds:
            total += R.bound_s(sp["bytes"], sp["ops_bf16"], sp["ops_int8"],
                               peak)
    return total


def decode_attention_span_s(ctx: Context) -> float:
    """Device time of the decode steps' attention: each call of the flash
    split pass over all slots (grid z = the batch) from its start to the
    end of the merge (kernel M) that follows it, a programmatic dependent
    launch that overlaps it."""
    b = ctx.mix["batch"]
    total, open_call = 0.0, None
    for k in ctx.trace.kernels(r"flash_kernel<|flash_merge_kernel"):
        if "flash_merge_kernel" in k.name:
            if open_call is not None:
                open_call[1] = max(open_call[1], k.end)
                total += open_call[1] - open_call[0]
                open_call = None
            continue
        if open_call is not None:       # a split pass with no merge
            total += open_call[1] - open_call[0]
            open_call = None
        if k.grid[2] == b:
            open_call = [k.start, k.end]
    if open_call is not None:
        total += open_call[1] - open_call[0]
    return total


def traced(ctx: Context, kind: str) -> bool:
    """A traced run whose stretch recorded forwards of `kind` on a card
    whose peaks the yardstick knows."""
    return (ctx.trace is not None and ctx.peak() is not None
            and any(f["kind"] == kind for f in ctx.recorder.forwards))


def busy_within(ctx: Context, name: str) -> float:
    """Device busy seconds inside the host spans called `name` (a job on
    the scheduler's thread that ends synchronised: its kernels run
    inside it)."""
    spans = [(a, b) for a, b, n in ctx.trace.spans if n == name]
    total = 0.0
    for a, b in ctx.trace.busy_intervals():
        for s0, s1 in spans:
            lo, hi = max(a, s0), min(b, s1)
            if hi > lo:
                total += hi - lo
    return total
