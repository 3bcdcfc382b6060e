"""The load: clients that send a mix's turns to the port's batched server
(`SchedulerThread.submit` with `on_token` / `on_done`, conversation leases
for sessions), and what each turn saw on the host clock.

Closed loop: a client sends its next turn when the reply before it is
done (its due time).  Open loop: sessions start at their arrival times
whatever the server does; the turns inside a session are closed.  A turn
is timed from its due time, so a wait before the server takes it counts.
A conversation that starts with an image has it encoded and filled into
its leased slot on the scheduler's thread, between ticks, before its
first turn is sent: the turn's wait for its first token includes the
image's job.

Ramp (part of set-up): with shared documents, the first client that asks
for a document sends at once and the others that ask for it wait for its
first token (so the document is resident when they arrive, as in a loop
that has run); without, every client sends at once.  The window opens
when every client has its first token.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from portbench.traffic import Script, TurnSpec


@dataclasses.dataclass
class Rec:
    spec: TurnSpec
    context: List[int]              # the conversation's cached tokens before
    due: float = 0.0
    times: List[float] = dataclasses.field(default_factory=list)
    out: List[int] = dataclasses.field(default_factory=list)
    done: Optional[float] = None
    error: Optional[str] = None
    req: object = None              # the scheduler's Request
    session_ok: bool = True         # no earlier turn of its session failed
    started: Optional[float] = None  # open loop: when its slot was had

    @property
    def first(self) -> Optional[float]:
        return self.times[0] if self.times else None


class Load:
    """Drives a `SchedulerThread` with a script.  Every send and every
    callback runs on the scheduler's thread (`start` through
    `SchedulerThread.call`), so a turn's record is complete before the
    scheduler can finish it."""

    def __init__(self, thread, script: Script, lease: bool,
                 image_job: Optional[Callable] = None,
                 ramp_seconds: float = 0.0):
        self.thread = thread
        self.sched = thread.sched
        self.script = script
        self.lease = lease
        self.image_job = image_job
        self.recs: List[Rec] = []
        self.stopping = False
        self._lock = threading.Lock()
        n = len(script.clients)
        self._next = [0] * n
        self._leases: List[Optional[object]] = [None] * n
        self._history: List[List[int]] = [[] for _ in range(n)]
        self._ok = [True] * n
        self._started = threading.Event()
        self._n_first = 0
        self._waiting_on: Dict[int, List[int]] = {}
        self.ramp_seconds = ramp_seconds
        self.t0 = 0.0
        self.stop_at = float("inf")   # open loop: no session due after it
        self.late: List[tuple] = []   # open loop: (due, start - due)
        self._starter: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    # -- the clients ----------------------------------------------------
    def start(self) -> None:
        """The ramp's first turns (module note); an open loop's session
        starter."""
        self.t0 = time.perf_counter()
        if self.script.arrivals is not None:
            self._starter = threading.Thread(target=self._start_sessions,
                                             daemon=True)
            self._starter.start()
            return
        primer: Dict[int, int] = {}
        for c, turns in enumerate(self.script.clients):
            d = turns[0].doc
            if d >= 0 and d in primer:
                self._waiting_on.setdefault(primer[d], []).append(c)
                continue
            if d >= 0:
                primer[d] = c
            self._send(c, between_ticks=True)

    def wait_started(self, timeout: float) -> bool:
        if self.script.arrivals is not None:
            time.sleep(max(0.0, self.t0 + self.ramp_seconds
                           - time.perf_counter()))
            return True
        return self._started.wait(timeout)

    def _start_sessions(self) -> None:
        """Open loop (its own thread): each session at its arrival time,
        whatever the server does; it waits for a free slot, then its image
        is encoded and filled on the scheduler's thread (between ticks),
        then its first turn is sent.  An exception stops the starter and
        is kept in `error` for the run to raise."""
        try:
            self._sessions()
        except BaseException as e:  # re-raised by the run
            self.error = e

    def _sessions(self) -> None:
        free_at = self.t0
        for c, at in enumerate(self.script.arrivals):
            due = self.t0 + at
            if due >= self.stop_at:
                return
            time.sleep(max(0.0, due - time.perf_counter()))
            if due >= self.stop_at:
                return
            # the generator's own delay: past the due time, or past the
            # end of the session before, whichever is later (waiting on
            # the server is not the generator's)
            self.late.append((due, time.perf_counter() - max(due, free_at)))
            lease = None
            while lease is None:
                # between ticks (see `_send`)
                lease = self.thread.call(self.sched.new_conversation)
                if lease is None:
                    time.sleep(0.002)
            spec = self.script.clients[c][0]
            self._next[c] = 1
            self._leases[c] = lease
            rec = Rec(spec=spec, context=[("image", spec.image)]
                      if spec.image is not None else [], due=due,
                      started=time.perf_counter())
            with self._lock:
                self.recs.append(rec)
            err = None
            if spec.image is not None:
                err = self.thread.call(lambda: self.image_job(lease,
                                                              spec.image))
            if err is not None:
                # the session ends with its image
                rec.error, rec.done = err, time.perf_counter()
                self._next[c] = len(self.script.clients[c])
                self.thread.call(lambda: self._after(c, rec))
            else:
                self.thread.call(lambda: self._submit(c, rec))
            free_at = time.perf_counter()

    def _send(self, c: int, due: Optional[float] = None,
              between_ticks: bool = False) -> None:
        turns = self.script.clients[c]
        i = self._next[c]
        if self.stopping or i >= len(turns):
            if self.lease and i >= len(turns) and \
                    self._leases[c] is not None:
                self.sched.end_conversation(self._leases[c])
                self._leases[c] = None
            return
        spec = turns[i]
        if self.lease and (spec.new_session or self._leases[c] is None) \
                and not between_ticks:
            # a slot is leased between ticks only: inside a tick the
            # scheduler sets the slot's position after the callbacks, and
            # a conversation leased there would start at the old one's
            self._defer(c, time.perf_counter() if due is None else due)
            return
        self._next[c] = i + 1
        err = None
        if self.lease and (spec.new_session or self._leases[c] is None):
            if self._leases[c] is not None:
                self.sched.end_conversation(self._leases[c])
            self._leases[c] = self.sched.new_conversation()
            self._history[c] = []
            self._ok[c] = True
            if self._leases[c] is None:
                raise RuntimeError(f"client {c}: no free slot for a "
                                   f"conversation")
            if spec.image is not None:
                # between ticks, on the scheduler's thread (see above)
                self._history[c] = [("image", spec.image)]
                err = self.image_job(self._leases[c], spec.image)
        rec = Rec(spec=spec, context=list(self._history[c]),
                  due=time.perf_counter() if due is None else due,
                  session_ok=self._ok[c])
        with self._lock:
            self.recs.append(rec)
        if err is not None:
            # the conversation ends with its image
            rec.error, rec.done = err, time.perf_counter()
            self._after(c, rec)
            return
        self._submit(c, rec)

    def _defer(self, c: int, due: float) -> None:
        """Send client c's next turn from a job between ticks, timed from
        `due`."""
        def job():
            if not self.stopping:
                self._send(c, due, between_ticks=True)

        def call():
            if not self.stopping:
                self.thread.call(job)

        threading.Thread(target=call, daemon=True).start()

    def _submit(self, c: int, rec: Rec) -> None:
        spec = rec.spec
        rec.req = self.thread.submit(
            spec.prompt, max_new_tokens=spec.max_new,
            on_token=lambda t, r=rec, c=c: self._on_token(c, r, t),
            on_done=lambda out, r=rec, c=c: self._on_done(c, r),
            lease=self._leases[c] if self.lease else None,
            temperature=0.0 if spec.greedy else None)

    def _on_token(self, c: int, rec: Rec, tok: int) -> None:
        rec.times.append(time.perf_counter())
        rec.out.append(tok)
        if len(rec.out) == 1 and self.script.arrivals is None:
            for f in self._waiting_on.pop(c, []):
                self._send(f)
            self._ramp(rec)

    def _on_done(self, c: int, rec: Rec) -> None:
        rec.done = time.perf_counter()
        rec.error = rec.req.error
        if rec.error is None and len(rec.out) < rec.spec.max_new:
            rec.error = "reply ended early"
        self._after(c, rec)

    def _ramp(self, rec: Rec) -> None:
        """Count a client's first turn as settled (first token or failed);
        the window opens when all are."""
        if rec.spec.index == 0:
            self._n_first += 1
            if self._n_first == len(self.script.clients):
                self._started.set()

    def _after(self, c: int, rec: Rec) -> None:
        if not rec.out and self.script.arrivals is None:
            self._ramp(rec)
        if rec.error is not None:
            # the conversation's cache no longer holds what it sent: its
            # next turn starts a new one
            self._ok[c] = False
            if self.lease and self._leases[c] is not None:
                self.sched.end_conversation(self._leases[c])
                self._leases[c] = None
        elif self.lease:
            self._history[c] = (list(rec.context) + rec.spec.prompt
                                + rec.out[:-1])
        for f in self._waiting_on.pop(c, []):
            self._send(f)           # a primer that failed: send anyway
        self._send(c)

    # -- after the window -----------------------------------------------
    def due_in(self, w0: float, w1: float) -> List[Rec]:
        with self._lock:
            return [r for r in self.recs if w0 <= r.due < w1]

    def backlog(self, t: float) -> int:
        """Open loop: sessions due by t that had no slot yet at t."""
        arrived = sum(1 for a in self.script.arrivals
                      if self.t0 + a <= min(t, self.stop_at))
        with self._lock:
            started = sum(1 for r in self.recs
                          if r.started is not None and r.started <= t)
        return arrived - started

    def settled(self, w0: float, w1: float) -> bool:
        """Every turn due in the window has its first token or failed."""
        return all(r.first is not None or r.done is not None
                   for r in self.due_in(w0, w1))
