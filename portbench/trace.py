"""The traced run's device trace: `torch.profiler` (CUPTI) over a stretch of
whole scheduler ticks at the end of the window, read from its Chrome trace.

- busy: the union of the device's operation intervals (kernels, copies,
  sets), so that overlapping launches (kernel M behind the flash split
  pass, K's second launch) count once;
- the breakdown: device time by kernel, and the idle gaps between busy
  intervals named by the innermost span the host was in at the gap's
  middle (the harness's `record_function` spans around the calls into the
  scheduler, the model and the image encoder).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Kernel:
    name: str
    start: float        # seconds on the trace's clock
    end: float
    grid: Tuple[int, int, int]


@dataclasses.dataclass
class TraceData:
    window_s: float                 # host clock from start to stop
    ops: List[Kernel]               # every device operation, by start
    spans: List[Tuple[float, float, str]]   # host spans (start, end, name)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[List[float]] = []
        for k in self.ops:
            if out and k.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], k.end)
            else:
                out.append([k.start, k.end])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernels(self, pattern: str) -> List[Kernel]:
        rx = re.compile(pattern)
        return [k for k in self.ops if rx.search(k.name)]


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list, at most 96 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    return name[:cut][:96]


class Profiler:
    """Start and stop on the thread that steps the scheduler, between
    ticks (`SchedulerThread.call`), so that the traced stretch is whole
    ticks and the device is drained at both ends."""

    def __init__(self):
        self._prof = None
        self.t0 = self.t1 = 0.0
        self.path: Optional[str] = None

    @staticmethod
    def prime() -> None:
        """Start and stop the profiler once over a tiny op (set-up): its
        first start initializes the tracer, which takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(8, device="cuda").sum().item()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.stop()
        fd, self.path = tempfile.mkstemp(prefix="portbench_", suffix=".json")
        os.close(fd)
        self._prof.export_chrome_trace(self.path)
        self._prof = None

    def read(self) -> TraceData:
        try:
            with open(self.path) as f:
                data = json.load(f)
        finally:
            os.unlink(self.path)
        return parse(data, self.t1 - self.t0)


def parse(data, window_s: float) -> TraceData:
    events = data["traceEvents"] if isinstance(data, dict) else data
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, dur = 1e-6 * float(e["ts"]), 1e-6 * float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            g = (e.get("args") or {}).get("grid") or (0, 0, 0)
            ops.append(Kernel(e["name"], ts, ts + dur, tuple(g)))
        elif cat == "user_annotation":
            spans.append((ts, ts + dur, e["name"]))
    ops.sort(key=lambda k: k.start)
    spans.sort()
    return TraceData(window_s=window_s, ops=ops, spans=spans)


def breakdown(tr: TraceData, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps summed by what the host was doing."""
    by_op: Dict[str, float] = defaultdict(float)
    for k in tr.ops:
        by_op[short_name(k.name)] += k.end - k.start
    busy = tr.busy_intervals()
    starts = [s[0] for s in tr.spans]
    by_gap: Dict[str, float] = defaultdict(float)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        by_gap[_host_at(tr.spans, starts, 0.5 * (a + b))] += b - a
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}


def _host_at(spans, starts, t: float) -> str:
    """The innermost (latest-starting) host span covering time t."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(spans[max(0, i - 4096):i]):
        if s <= t <= e:
            return name
    return "host outside any span"
