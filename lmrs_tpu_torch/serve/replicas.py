"""Data-parallel serving: dp scheduler replicas behind one router
(counterpart of `lmrs_tpu/serve/replicas.py`).

`dp` independent continuous-batching schedulers (`serve.scheduler.
BatchScheduler`), each on a device group of its own with its own copy of
the weights, behind a least-loaded router: requests and new conversations
go to the least-loaded replica, conversations pin to the replica that
holds their KV.  The
replicas share nothing on the device.  Over tp = 1 every replica is a
scheduler of this process on one device (the same device may be named
twice); over tp > 1 every replica is a mesh scheduler (`parallel.tp.
make_mesh_scheduler`) whose rank 0 is this process, one process group per
replica, so that each replica steps from its own thread
(`run_threaded`, or `start_threads` for live traffic, as `serve.backend`
serves it).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Sequence

from lmrs_tpu_torch.serve.scheduler import (BatchScheduler, Lease, Request,
                                            SchedulerThread)


@dataclasses.dataclass
class RouterLease:
    """A conversation lease pinned to one replica (its KV lives there)."""

    replica: int
    lease: Lease


def _devices(devices: Optional[Sequence], need: int) -> List:
    import torch

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu', ...] "
                               "to run the replicas on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < need:
        raise ValueError(f"dp x tp needs {need} devices, have "
                         f"{len(devices)}")
    return devices


class ReplicaRouter:
    """dp BatchScheduler replicas over disjoint `tp`-device groups."""

    def __init__(self, f, dp: int, tp: int = 1, devices=None, **sched_kw):
        """f: a parsed .lmrs file (or its path).  Replica i runs on
        devices[i*tp:(i+1)*tp] (a list of torch devices or their names;
        default every GPU): one device and this process for tp = 1, else a
        mesh whose rank 0 is this process on devices[i*tp] (its ranks on
        that device and the next tp - 1, by device index; every rank on the
        CPU when the devices are "cpu").  Each replica assembles its own
        copy of the weights."""
        import torch

        from lmrs_tpu_torch.parallel.tp import _open, make_mesh_scheduler

        if dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        f = _open(f)
        devices = _devices(devices, dp * tp)
        self.cfg = f.cfg
        self.replicas: List[BatchScheduler] = []
        self.threads: List[SchedulerThread] = []
        try:
            for i in range(dp):
                dev = torch.device(devices[i * tp])
                if tp == 1:
                    from lmrs_tpu_torch.io.params import params_from_lmrs

                    self.replicas.append(BatchScheduler(
                        f.cfg, params_from_lmrs(f, dev), device=dev,
                        **sched_kw))
                else:
                    from lmrs_tpu_torch.parallel.distributed import Mesh

                    mesh = Mesh.start(f, tp=tp, device=dev.type,
                                      first_device=dev.index or 0)
                    self.replicas.append(make_mesh_scheduler(
                        f, mesh=mesh, **sched_kw))
        except BaseException:
            self.close()
            raise

    # -- routing ---------------------------------------------------------
    def _load(self, r: BatchScheduler) -> int:
        """Slots in use (leased, running or staged) plus requests waiting
        for a free one.  A conversation counts from its lease on (the JAX
        router counts only requests in flight), so that connections that
        lease at once spread over the replicas instead of filling the
        first: its later turns stay where it leased."""
        return (sum(1 for s in r.slots if s.lease is not None
                    or s.req is not None or s.pending is not None)
                + sum(1 for q in list(r.waiting) if q.lease is None))

    def _by_load(self) -> List[int]:
        return sorted(range(len(self.replicas)),
                      key=lambda i: self._load(self.replicas[i]))

    def _on(self, i: int, fn: Callable[[], object]):
        """fn() on replica i's stepping thread once `start_threads` ran
        (between its chunks), else here."""
        return self.threads[i].call(fn) if self.threads else fn()

    def submit(self, prompt: Sequence[int],
               lease: Optional[RouterLease] = None, **kw) -> Request:
        """Route to the lease's replica, else the least-loaded one."""
        i = self._by_load()[0] if lease is None else lease.replica
        target = self.threads[i] if self.threads else self.replicas[i]
        return target.submit(prompt, lease=None if lease is None
                             else lease.lease, **kw)

    def new_conversation(self) -> Optional[RouterLease]:
        """Lease a slot on the least-loaded replica that has one free."""
        for i in self._by_load():
            lease = self._on(i, self.replicas[i].new_conversation)
            if lease is not None:
                return RouterLease(replica=i, lease=lease)
        return None

    def end_conversation(self, lease: RouterLease):
        r = self.replicas[lease.replica]
        self._on(lease.replica, lambda: r.end_conversation(lease.lease))

    def prefill_embeds(self, lease: RouterLease, embeds):
        self.replicas[lease.replica].prefill_embeds(lease.lease, embeds)

    # -- driving ---------------------------------------------------------
    def has_work(self) -> bool:
        return any(r.has_work() for r in self.replicas)

    def step(self):
        """One tick of every replica with work, in turn on this thread."""
        for r in self.replicas:
            if r.has_work():
                r.step()

    def run(self, poll: Optional[Callable[[], bool]] = None):
        while self.has_work():
            self.step()
            if poll is not None and not poll():
                return

    def run_threaded(self):
        """Drain every replica on a stepping thread of its own (what the
        backend's SchedulerThreads do for live traffic): the replicas'
        host work overlaps instead of taking turns.  A replica's error is
        raised here after every thread ended."""
        errors = []

        def drain(r: BatchScheduler):
            try:
                r.bind_thread()
                while r.has_work():
                    r.step()
            except BaseException as e:  # raised on the calling thread
                errors.append(e)

        threads = [threading.Thread(target=drain, args=(r,), daemon=True)
                   for r in self.replicas if r.has_work()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def start_threads(self) -> List[SchedulerThread]:
        """Step every replica from a SchedulerThread of its own, for live
        traffic: from then on `submit`, `new_conversation` and
        `end_conversation` reach a replica through its thread."""
        self.threads = [SchedulerThread(r) for r in self.replicas]
        return self.threads

    def warmup(self):
        for r in self.replicas:
            r.warmup()

    def close(self):
        """Stop the stepping threads, then every replica's mesh (tp > 1)."""
        for t in getattr(self, "threads", []):
            t.shutdown()
        for r in getattr(self, "replicas", []):
            if r.mesh is not None:
                r.close()
                r.mesh.shutdown()

    # -- aggregate metrics -----------------------------------------------
    @property
    def tokens_emitted(self) -> int:
        return sum(r.tokens_emitted for r in self.replicas)

    @property
    def decode_seconds(self) -> float:
        # replicas decode concurrently under run_threaded / the backend's
        # per-replica threads: the aggregate is the longest replica's time
        return max((r.decode_seconds for r in self.replicas), default=0.0)

    @property
    def spec_proposed(self) -> int:
        return sum(r.spec_proposed for r in self.replicas)

    @property
    def spec_accepted(self) -> int:
        return sum(r.spec_accepted for r in self.replicas)


def make_replica_router(f, dp: int, tp: int = 1, devices=None, **sched_kw):
    """The --dp entry point of serve.backend: a parsed .lmrs file (or its
    path) -> a dp x tp ReplicaRouter."""
    return ReplicaRouter(f, dp=dp, tp=tp, devices=devices, **sched_kw)
