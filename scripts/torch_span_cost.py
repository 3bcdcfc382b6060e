"""Host cost of the port's spans on this machine: ns a ring span, a stage
with no profiler, the flag check; and the flag under a CUDA profiler.

    PYTHONPATH=. python3 scripts/torch_span_cost.py
"""
import time

import torch

from lmrs_tpu_torch import tracing

N = 200000
ring = tracing.ring()
for rep in range(3):
    t = time.perf_counter_ns()
    for _ in range(N):
        with tracing.Span(ring, "sched.decode", -1, 4):
            pass
    a = (time.perf_counter_ns() - t) / N
    on = tracing.profiling()
    t = time.perf_counter_ns()
    for _ in range(N):
        with tracing.stage("fwd.qkv", on):
            pass
    b = (time.perf_counter_ns() - t) / N
    t = time.perf_counter_ns()
    for _ in range(N):
        tracing.profiling()
    c = (time.perf_counter_ns() - t) / N
    print(f"span_cost: ring span {a:.0f} ns, stage off {b:.0f} ns, "
          f"flag check {c:.0f} ns")
from torch.profiler import ProfilerActivity, profile  # noqa: E402
acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                 if torch.cuda.is_available() else [])
with profile(activities=acts):
    inside = tracing.profiling()
    t = time.perf_counter_ns()
    for _ in range(20000):
        with tracing.stage("fwd.qkv", True):
            pass
    d = (time.perf_counter_ns() - t) / 20000
print(f"span_cost: flag under the profiler {inside}, after "
      f"{tracing.profiling()}; a stage under the profiler {d:.0f} ns")
