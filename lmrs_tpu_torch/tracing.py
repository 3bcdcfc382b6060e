"""Host spans of the batched server, and stage annotations for a profiler.

The ring: `BatchScheduler.spans` is a bounded `collections.deque` of span
records, always on, filled on the scheduler's one thread.  A record is
`Record(name, t0_ns, t1_ns, rid, n, profiled)`:

- `t0_ns`, `t1_ns`: `time.perf_counter_ns()` at the span's start and end,
  the clock of `Request.submit_time`, `admit_time`, `first_time` and
  `done_time` (those in seconds);
- `rid`: the request's id, or -1 for work on the whole batch;
- `n`: the span's one count (see the names below);
- `profiled`: whether a torch profiler was recording when it started.

A record is appended when its span ends, so a child precedes its parent;
parents are implied by nesting in time.  When the ring is full the oldest
records drop.  The names (rid / n):

    sched.tick          a scheduler step               -1 / lanes holding a
                                                       request after admission
    sched.admit         admission                      -1 / requests staged
    sched.prefix        prefix search and fork, per    rid / tokens forked
                        staged request                 (0: a miss)
    sched.prefill       one prefill chunk's launch     rid / real rows
    sched.first_token   the first token's sampling     rid / 1
                        and its host read
    sched.decode        a decode chunk, plain or       -1 / lanes holding a
                        speculative                    request
    sched.decode.launch its uploads, forwards and      -1 / steps
                        samplings, up to the read
    sched.decode.graph  inside the launch, its steps   -1 / steps that
                        where the forward is a CUDA    replayed the graph
                        graph (one CUDA device)
    sched.decode.read   the chunk's one host read      -1 / steps
    sched.emit          the chunk's tokens handed to   -1 / tokens emitted
                        the callbacks

While a torch profiler records, each span is also a `record_function` of
its name, so the spans sit in the profiler's trace on its own clock; the
batched forward then marks its stages too (`stage`: `fwd.embed`, per layer
`fwd.qkv`, `fwd.kv_write`, `fwd.attn`, `fwd.post`, then `fwd.head`; and
`sample` around the decode step's sampling).  Stages go to the profiler
only, never to the ring; when no profiler records they cost one flag
check a forward and an empty `with` a stage.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler

RING_SPANS = 65536

Record = collections.namedtuple("Record",
                                "name t0_ns t1_ns rid n profiled")

_NULL = contextlib.nullcontext()


def ring() -> collections.deque:
    """An empty span ring that keeps the newest `RING_SPANS` records."""
    return collections.deque(maxlen=RING_SPANS)


def profiling() -> bool:
    """Whether a torch profiler is recording (one attribute read)."""
    return _autograd_profiler._is_profiler_enabled


def stage(name: str, on: bool):
    """A profiler annotation `name` when `on` (from `profiling()`), else a
    context that does nothing."""
    return torch.profiler.record_function(name) if on else _NULL


class Span:
    """`with Span(ring, name, rid, n) as sp:` appends one record to `ring`
    when the block ends, also when it raises; set `sp.n` inside the block
    when the count is known only there.  `seconds` is its duration."""

    __slots__ = ("ring", "name", "rid", "n", "t0", "t1", "profiled", "_rf")

    def __init__(self, ring: collections.deque, name: str, rid: int = -1,
                 n: int = 0):
        self.ring = ring
        self.name = name
        self.rid = rid
        self.n = n
        self.t0 = self.t1 = 0
        self.profiled = False
        self._rf = None

    def __enter__(self) -> "Span":
        self.profiled = profiling()
        if self.profiled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.ring.append(Record(self.name, self.t0, self.t1, self.rid,
                                self.n, self.profiled))
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9
