"""The collectives of the parallel forward, on torch.distributed.

One `Comm` per rank holds its process groups (the whole mesh, the rank's
tp group and its cp group), its place in the (tp, cp) grid and its device,
and offers the four operations the forward needs: `sum`, `max`,
`gather_last` (the tp logits) and `gather_rows` (the cp rows), plus
`broadcast` for rank 0's calls.  Only two collectives are used:
all-reduce (SUM, MAX) and broadcast.  Gloo lists no all-gather for CUDA
tensors, and ranks that share one GPU must use gloo (NCCL refuses two ranks
on one device), so one code path serves gloo on the CPU, gloo on one card
and NCCL with a GPU per rank.  A gather is an all-reduce of a zero buffer
into which each rank writes its own slice: the zeros add exactly.

Rank r sits at tp index r // cp and cp index r % cp (the JAX package's
(tp, cp) mesh, `devices.reshape(tp, cp)`).  A sum over more than two ranks
gathers the ranks' terms and adds them in rank order, so that every rank
gets the same bits and a row's sum never depends on the rows beside it
(what keeps speculative greedy decoding exact); over two ranks the
all-reduce is that already (a + b == b + a).

`calls` and `seconds` count the collectives and their host time (rank 0's
per-step metric), `broadcasts` the broadcasts among them.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


def _reduce_opts(op):
    opts = dist.AllreduceOptions()
    opts.reduceOp = op
    return opts


class Comm:
    """One rank's groups and collectives.  `world`, `tp_group` and
    `cp_group` are process groups (a `ProcessGroup` or a backend such as
    `ProcessGroupGloo`); a group of one rank may be None."""

    def __init__(self, world, rank: int, size: int, tp: int, cp: int,
                 tp_group, cp_group, device: torch.device,
                 backend: str = "gloo"):
        if tp * cp != size:
            raise ValueError(f"tp={tp} x cp={cp} != {size} ranks")
        self.world = world
        self.rank = rank
        self.size = size
        self.tp = tp
        self.cp = cp
        self.tp_rank = rank // cp
        self.cp_rank = rank % cp
        self.groups = {"tp": tp_group, "cp": cp_group, "world": world}
        self.sizes = {"tp": tp, "cp": cp, "world": size}
        self.device = torch.device(device)
        self.backend = backend
        self.calls = 0
        self.seconds = 0.0
        self.broadcasts = 0

    def index(self, axis: str) -> int:
        return {"tp": self.tp_rank, "cp": self.cp_rank,
                "world": self.rank}[axis]

    def _run(self, work_fn):
        t0 = time.perf_counter()
        work_fn().wait()
        self.calls += 1
        self.seconds += time.perf_counter() - t0

    def _all_reduce(self, t: torch.Tensor, axis: str, op) -> torch.Tensor:
        """In place on a contiguous tensor of the comm's device."""
        if self.sizes[axis] == 1:
            return t
        group = self.groups[axis]
        self._run(lambda: group.allreduce([t], _reduce_opts(op)))
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0,
                  axis: str = "world") -> torch.Tensor:
        """Broadcast the contiguous `t` from group rank `src`, in place."""
        if self.sizes[axis] == 1:
            return t
        opts = dist.BroadcastOptions()
        opts.rootRank = src
        opts.rootTensor = 0
        group = self.groups[axis]
        self._run(lambda: group.broadcast([t], opts))
        self.broadcasts += 1
        return t

    def _stack(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """(n, *t.shape): every rank's t along `axis`, in rank order."""
        n = self.sizes[axis]
        buf = torch.zeros((n, *t.shape), dtype=t.dtype, device=t.device)
        buf[self.index(axis)] = t
        return self._all_reduce(buf, axis, dist.ReduceOp.SUM)

    def sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of `t` over the ranks of `axis` ("tp", "cp" or
        "world"), the same bits on every rank (module note)."""
        n = self.sizes[axis]
        if n == 1:
            return t
        if n == 2:
            return self._all_reduce(t.contiguous().clone(), axis,
                                    dist.ReduceOp.SUM)
        parts = self._stack(t, axis)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def max(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        if self.sizes[axis] == 1:
            return t
        return self._all_reduce(t.contiguous().clone(), axis,
                                dist.ReduceOp.MAX)

    def gather_last(self, t: torch.Tensor, axis: str = "tp") -> torch.Tensor:
        """The ranks' t concatenated along the last axis in rank order (the
        vocab-sharded logits)."""
        if self.sizes[axis] == 1:
            return t
        parts = self._stack(t, axis)
        return torch.cat(list(parts.unbind(0)), dim=-1)

    def gather_rows(self, t: torch.Tensor, axis: str = "cp") -> torch.Tensor:
        """The ranks' t concatenated along the first axis in rank order
        (the row tiles of the sequence-parallel prefill)."""
        if self.sizes[axis] == 1:
            return t
        parts = self._stack(t, axis)
        return parts.reshape(-1, *t.shape[1:])

