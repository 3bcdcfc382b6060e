"""The traced run's host-side records, taken from the benchmark's side of
the calls into the port: each scheduler call wrapped in a
`record_function` span (read by the trace's idle-gap breakdown), the
prompt tokens each admission takes, and, while the device trace runs, each
forward with its raw sizes: a decode step's lanes as (physical pages,
rows read) with the pool's page size, a chunk's start position and rows.
What a forward of those sizes reads and computes is its architecture's
(`arch/<model_type>.py`), counted after the window.

Wrappers are instance attributes of one `BatchScheduler`; untraced runs
install none."""

from __future__ import annotations

import functools
from typing import List


class Recorder:
    def __init__(self, sched):
        self.sched = sched
        self.on = False               # forwards are recorded while True
        self.admitted_tokens = 0      # prompt tokens of admitted requests
        self.forwards: List[dict] = []
        self.extra_costs: List[dict] = []   # other device work, e.g. images
        self._j = 0                   # decode step within the tick's chunk

    def install(self) -> None:
        s = self.sched
        self._wrap("step", "scheduler.step", self._before_step)
        self._wrap("_advance_prefills", "scheduler.prefill")
        self._wrap("_emit", "scheduler.emit")
        orig_admit = s._admit

        def admit():
            from torch.profiler import record_function

            before = list(s.waiting)
            with record_function("scheduler.admit"):
                orig_admit()
            left = set(map(id, s.waiting))
            self.admitted_tokens += sum(
                len(r.prompt) for r in before
                if id(r) not in left and r.error is None)

        s._admit = admit
        orig_prefill = s._prefill_call

        def prefill_call(slot_idx, xt, pos, logit_idx, real_rows):
            from torch.profiler import record_function

            if self.on:
                self._prefill(xt, pos, logit_idx, real_rows)
            with record_function("model.prefill_chunk"):
                return orig_prefill(slot_idx, xt, pos, logit_idx, real_rows)

        s._prefill_call = prefill_call
        orig_fwd = s._fwd_b

        def fwd_b(x, p, t_q=1, table=None, logit_idx=None,
                  want_logits=True):
            from torch.profiler import record_function

            if t_q == 1 and x.dim() == 1 and x.shape[0] == s.B:
                if self.on:
                    self._decode()
                self._j += 1
                with record_function("model.decode_step"):
                    return orig_fwd(x, p, t_q, table, logit_idx,
                                    want_logits)
            return orig_fwd(x, p, t_q, table, logit_idx, want_logits)

        s._fwd_b = fwd_b

    def _wrap(self, name: str, label: str, before=None) -> None:
        orig = getattr(self.sched, name)

        @functools.wraps(orig)
        def wrapped(*a, **kw):
            from torch.profiler import record_function

            if before is not None:
                before()
            with record_function(label):
                return orig(*a, **kw)

        setattr(self.sched, name, wrapped)

    def _before_step(self) -> None:
        self._j = 0

    def _prefill(self, xt, pos: int, logit_idx, real_rows: int) -> None:
        self.forwards.append(dict(
            kind="embeds" if xt.dtype.is_floating_point else "prefill",
            start=pos, rows=real_rows, t_q=xt.shape[0],
            logit_rows=0 if logit_idx is None else 1))

    def _decode(self) -> None:
        s = self.sched
        # a lane whose reply ends inside the chunk still runs to its end;
        # only the steps whose tokens are delivered count
        lanes = [(tuple(sl.pages), sl.pos + self._j + 1) for sl in s.slots
                 if sl.req is not None
                 and len(sl.req.out) + self._j < sl.req.max_new_tokens]
        n = len(lanes)
        self.forwards.append(dict(
            kind="decode", rows=n, t_q=s.B, logit_rows=n, lanes=lanes,
            page_size=s.psz))
