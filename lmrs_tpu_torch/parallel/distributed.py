"""Ranks: multi-process initialization, rank 0's handle on a mesh of
ranks, and the followers' loop.

The JAX package runs one controller over many devices.  Here each rank is a
process of its own, so that each has its own host thread (the port is
host-bound: one process launching for every device in turn would make tp
slower than one card).  Rank 0 leads: the front ends, `Engine`,
`BatchScheduler`, sampling, the token history and the sessions live there,
as in the JAX single controller.  Ranks 1..N-1 are followers: each runs
`Follower.loop`, receives rank 0's calls, runs the same forward on its
shard (`models.transformer` with its local config and communicator) and
takes part in its collectives.  A follower holds its own shard of every KV
cache, keyed by a cache id: the non-batched backend gives each connection
its own Engine over the shared weights.

A call is one broadcast of a fixed header (the op, its integers, the
shapes and types of up to four tensors, and one integer copied into it on
the device), then one broadcast per tensor (token ids or embedding rows,
positions, a page table, a history), then the op itself on every rank
(`Shard.run`).  Only rank 0 reads logits, except in the decode and
speculative chunks (`Mesh.decode_chunk`, `Mesh.spec_chunk`, the JAX
`_make_mesh_fns._decode_chunk` and `make_spec_chunk_mesh`): one call a
chunk, whose header carries the input token (a device integer, so that
rank 0 reads nothing), the position, the step counts, the sampling
settings and a seed.  Every rank runs the chunk on its shard with its
forward's logits, which are whole on every rank after the tp gather, and
samples from a generator seeded alike; once a chunk the ranks hold their
token buffers against each other in one all-reduce (`agree`) and raise on
a difference, so that no rank goes on with another stream unseen.

`Mesh.start` starts the other ranks itself (`torch.multiprocessing`,
spawn; the CUDA kernels are built first so that the ranks load them and do
not race to build them) over a TCP store on localhost, so that `--tp 2`
works on one command line; rank r takes device r % the device count.
Under a process group that `initialize_multihost` started (a coordinator
address, or torchrun's RANK / WORLD_SIZE) the ranks are the group's: rank
0 returns the handle, every other rank serves as a follower until the
leader stops and then leaves the program.  Gloo runs where ranks share a
device (one GPU, or the CPU), NCCL where every rank has a GPU of its own.

No fallback hides a fault: a rank that asks for a GPU and has none fails;
a kernel that fails raises on its rank; a follower that raises prints its
traceback and exits, and rank 0's next collective then fails (the
peer's connection closes) or times out after `timeout` seconds; rank 0
also checks its followers' processes around every call and raises for a
dead one.  The mesh is then broken: every later call raises.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import struct
import threading
import time
import traceback
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from lmrs_tpu_torch.config import ModelConfig, local_config
from lmrs_tpu_torch.models.transformer import (KVCache, copy_rows,
                                               embed_tokens, forward,
                                               forward_batched, is_packed4,
                                               new_cache, slot_view)
from lmrs_tpu_torch.parallel.comm import Comm

# ops
(FORWARD, FORWARD_B, NEW_CACHE, FREE, COPY, SAVE, LOAD, STATS, RESET, STOP,
 EMBED, DECODE_CHUNK, SPEC_CHUNK) = range(1, 14)
MAX_TENSORS = 4
MAX_INTS = 11
# the header's last slot carries a device integer (a chunk's input token)
HEADER = 2 + 5 * MAX_TENSORS + MAX_INTS + 1
DTYPES = [torch.float32, torch.int64, torch.int32, torch.int8]
CACHE_CODES = [torch.bfloat16, torch.float32, torch.int8, "int4"]
NO_LOGITS, ALL_LOGITS = -2, -1
DEFAULT_TIMEOUT = 600.0


def choose_backend(device: torch.device, local_ranks: int,
                   first_device: int = 0) -> str:
    """NCCL when every local rank has a GPU of its own (ranks on devices
    first_device.. first_device + local_ranks - 1), gloo otherwise (ranks
    sharing one GPU, or the CPU)."""
    if (device.type == "cuda"
            and first_device + local_ranks <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int,
                first: int = 0) -> torch.device:
    """Rank `local_rank`'s device: cuda:((first + local_rank) % device
    count), or the CPU when asked.  A rank that asks for a GPU and has none
    fails."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {local_rank}: no CUDA device")
    return torch.device("cuda",
                        (first + local_rank) % torch.cuda.device_count())


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         timeout: float = DEFAULT_TIMEOUT) -> bool:
    """Start the default process group over several processes, the
    counterpart of `lmrs_tpu.parallel.distributed.initialize_multihost`:
    `coordinator` "host:port" becomes init_method tcp://host:port; without
    it torchrun's environment (MASTER_ADDR, RANK, WORLD_SIZE) is read.
    Returns False (nothing to do) for one process, True once a group is
    up (also when one already was)."""
    if dist.is_initialized():
        return True
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if coordinator is None and num_processes in (None, 1) and env_world <= 1:
        return False
    world = num_processes or env_world
    rank = process_id if process_id is not None \
        else int(os.environ.get("RANK", "0"))
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = choose_backend(
            torch.device("cuda" if torch.cuda.is_available() else "cpu"),
            local)
    dist.init_process_group(
        backend,
        init_method=(f"tcp://{coordinator}" if coordinator else "env://"),
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    return True


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------

def _group(store, prefix: str, rank: int, size: int, backend: str,
           timeout: datetime.timedelta):
    if size == 1:
        return None
    sub = dist.PrefixStore(prefix, store)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(sub, rank, size, opts)
    return dist.ProcessGroupGloo(sub, rank, size, timeout)


def connect(store, rank: int, tp: int, cp: int, device: torch.device,
            backend: str, timeout: float) -> Comm:
    """One rank's Comm over a store: the world group, its tp group (the
    ranks of its cp index) and its cp group (the ranks of its tp index),
    each a process group of its own."""
    td = datetime.timedelta(seconds=timeout)
    world = _group(store, "world", rank, tp * cp, backend, td)
    tp_rank, cp_rank = rank // cp, rank % cp
    return Comm(world, rank, tp * cp, tp, cp,
                _group(store, f"tp{cp_rank}", tp_rank, tp, backend, td),
                _group(store, f"cp{tp_rank}", cp_rank, cp, backend, td),
                device, backend)


def comm_from_world(tp: int, cp: int, device: torch.device) -> Comm:
    """The Comm of this process inside the default process group: the
    world, and tp and cp subgroups (every rank creates every subgroup, in
    one order, as `dist.new_group` asks)."""
    rank, size = dist.get_rank(), dist.get_world_size()
    if tp * cp != size:
        raise ValueError(f"tp={tp} x cp={cp} needs {tp * cp} processes, "
                         f"the group has {size}")
    tp_groups = [dist.new_group([i * cp + j for i in range(tp)])
                 for j in range(cp)]
    cp_groups = [dist.new_group([i * cp + j for j in range(cp)])
                 for i in range(tp)]
    return Comm(dist.group.WORLD, rank, size, tp, cp,
                tp_groups[rank % cp] if tp > 1 else None,
                cp_groups[rank // cp] if cp > 1 else None, device,
                dist.get_backend())


# ---------------------------------------------------------------------------
# what every rank runs
# ---------------------------------------------------------------------------

def load_shard(f, cfg: ModelConfig, comm: Comm, device: torch.device):
    """The rank's parameters and local config: its tp block of the
    weights (cp ranks of one tp index hold the same block)."""
    from lmrs_tpu_torch.parallel.tp import tp_params

    cfg_l = local_config(cfg, comm.tp, comm.cp)
    return tp_params(f, cfg, comm.tp, comm.tp_rank, device), cfg_l


class Shard:
    """One rank's part of a mesh: its communicator, local config,
    parameters and KV caches, and the ops every rank runs alike."""

    def __init__(self, comm: Comm, cfg: ModelConfig, cfg_l: ModelConfig,
                 params):
        self.comm = comm
        self.cfg = cfg
        self.cfg_l = cfg_l
        self.params = params
        self.caches: Dict[int, KVCache] = {}
        self.load_s = 0.0

    def _run(self, cid: int, w8a8: int):
        """The forward of cache `cid` at a device position with its host
        bounds, logits on every rank: the chunks' `run`."""
        cache = self.caches[cid]

        def run(x, p, logit_idx, pos_range):
            return forward(self.params, self.cfg_l, cache, x, p, logit_idx,
                           w8a8=bool(w8a8), comm=self.comm,
                           pos_range=pos_range, every_rank=True)
        return run

    def _generator(self, temperature: float, seed: int):
        if temperature == 0.0:
            return None
        return torch.Generator(device=self.comm.device).manual_seed(seed)

    def run(self, op: int, ints: List[int], tensors: List[torch.Tensor],
            carry: Optional[torch.Tensor] = None):
        comm, cfg_l = self.comm, self.cfg_l
        if op == DECODE_CHUNK:
            from lmrs_tpu_torch.runtime.engine import decode_chunk

            cid, pos, n, temp, top_p, seed, w8a8 = ints[:7]
            temp, top_p = _float(temp), _float(top_p)
            toks = decode_chunk(self._run(cid, w8a8), carry, pos, n, temp,
                                top_p, self._generator(temp, seed))
            agree(comm, toks)
            return toks
        if op == SPEC_CHUNK:
            from lmrs_tpu_torch.runtime.speculative import spec_chunk

            cid, pos, n_steps, k, temp, top_p, seed, w8a8 = ints[:8]
            temp, top_p = _float(temp), _float(top_p)
            h = tensors[0]
            out, n_out, accs, p = spec_chunk(
                self._run(cid, w8a8), self.cfg, h, pos, n_steps, k, temp,
                top_p, self._generator(temp, seed))
            agree(comm, torch.cat([out, n_out.reshape(1), accs]))
            return out, n_out, accs, p, h
        if op == FORWARD:
            cid, slot, pos, logit, w8a8 = ints[:5]
            cache = self.caches[cid]
            if slot >= 0:
                cache = slot_view(cache, slot)
            return forward(self.params, cfg_l, cache, tensors[0], pos,
                           None if logit == NO_LOGITS
                           else "all" if logit == ALL_LOGITS else logit,
                           w8a8=bool(w8a8), comm=comm)
        if op == FORWARD_B:
            cid, t_q, logit, want, w8a8 = ints[:5]
            return forward_batched(
                self.params, cfg_l, self.caches[cid], tensors[0], tensors[1],
                t_q=t_q, table=tensors[2] if len(tensors) > 2 else None,
                logit_idx=None if logit == NO_LOGITS else logit,
                w8a8=bool(w8a8), want_logits=bool(want), comm=comm)
        if op == NEW_CACHE:
            cid, kind, code, a, b = ints[:5]
            self.caches[cid] = new_cache(cfg_l, comm.device, kind,
                                         CACHE_CODES[code], a, b)
            return self.caches[cid]
        if op == FREE:
            self.caches.pop(ints[0], None)
            return None
        if op == COPY:
            cid, kind, src, dst, n = ints[:5]
            copy_rows(self.caches[cid], kind, src, dst, n, comm.cp_rank)
            return None
        if op == EMBED:
            return embed_tokens(self.params, cfg_l, tensors[0], comm)
        if op == SAVE:
            return gather_cache(self, ints[0], ints[1])
        if op == LOAD:
            return scatter_cache(self, ints[0], tensors)
        if op == STATS:
            return rank_stats(self)
        if op == RESET:
            from lmrs_tpu_torch.kernels import reset_launches

            reset_launches()
            comm.calls, comm.seconds, comm.broadcasts = 0, 0.0, 0
            if comm.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(comm.device)
            return None
        raise ValueError(f"unknown mesh op {op}")


def _bits(x: float) -> int:
    """A float's IEEE double bits as an int64, for the int64 header."""
    return struct.unpack("<q", struct.pack("<d", float(x)))[0]


def _float(bits: int) -> float:
    return struct.unpack("<d", struct.pack("<q", int(bits)))[0]


def agree(comm: Comm, v: torch.Tensor) -> None:
    """Raise on every rank unless every rank holds the same integer
    buffer `v`: one all-reduce (MAX) of (v, -v) over the mesh; the
    largest and the smallest value of each entry are equal only when every
    rank's are."""
    if comm.size == 1:
        return
    v = v.long().reshape(-1)
    m = comm._all_reduce(torch.cat([v, -v]), "world", dist.ReduceOp.MAX)
    n = v.numel()
    if not (torch.equal(m[:n], v) and torch.equal(-m[n:], v)):
        raise RuntimeError(f"mesh rank {comm.rank}: the ranks' chunk "
                           f"tokens differ (this rank {v.tolist()}, the "
                           f"largest {m[:n].tolist()}, the smallest "
                           f"{(-m[n:]).tolist()})")


def _planes(cache: KVCache):
    """(name, tensor, head axis, sequence axis) of a single-stream cache's
    planes: values (L, S, KH*hd), scales (L, KH, S)."""
    out = [("k", cache.k, 2, 1), ("v", cache.v, 2, 1)]
    if cache.k_scale is not None:
        out += [("k_scale", cache.k_scale, 1, 2),
                ("v_scale", cache.v_scale, 1, 2)]
    return out


def _wire(t: torch.Tensor) -> torch.Tensor:
    """bf16 travels as its bytes (int8, the last axis doubled)."""
    return t.view(torch.int8) if t.dtype == torch.bfloat16 else t


def _piece(cp_rank: int, s_loc: int, n: int):
    """The local rows [lo, hi) of cp shard `cp_rank` (of s_loc rows) that
    hold global rows of the first n."""
    base = cp_rank * s_loc
    return min(n, base) - base, min(n, base + s_loc) - base


def gather_cache(shard: Shard, cid: int, n: int):
    """SAVE: the first n global rows of a single-stream cache, gathered on
    every rank in the global layout (each rank's block broadcast from it in
    rank order); None for a follower.  An int4 cache's blocks are unpacked
    to their values and packed again at the global head count, whose
    packing may differ (`quant.q4_cache_pair_mode`)."""
    from lmrs_tpu_torch.quant import pack_kv_q4, unpack_kv_q4

    comm, cfg_l = shard.comm, shard.cfg_l
    cache = shard.caches[cid]
    kh_l, hd = cfg_l.n_kv_heads, cfg_l.cache_head_dim
    packed4 = is_packed4(cfg_l, cache)
    out = {}
    for name, plane, head_ax, seq_ax in _planes(cache):
        cols = []        # per tp index, the rows of every cp index in turn
        for i in range(comm.tp):
            rows = []
            for j in range(comm.cp):
                r = i * comm.cp + j
                lo, hi = _piece(j, cache.k.shape[1], n)
                if r == comm.rank:
                    buf = plane.narrow(seq_ax, lo, hi - lo).contiguous()
                else:
                    shape = list(plane.shape)
                    shape[seq_ax] = hi - lo
                    buf = torch.empty(shape, dtype=plane.dtype,
                                      device=plane.device)
                if buf.numel():       # every rank skips an empty piece
                    comm.broadcast(_wire(buf), r)
                rows.append(buf)
            col = torch.cat(rows, dim=seq_ax)
            if packed4 and head_ax == 2:
                col = unpack_kv_q4(col, kh_l, hd)
            cols.append(col)
        full = torch.cat(cols, dim=head_ax)
        if packed4 and head_ax == 2:
            full = pack_kv_q4(full)
        out[name] = full
    return out if comm.rank == 0 else None


def scatter_cache(shard: Shard, cid: int, tensors: Sequence[torch.Tensor]):
    """LOAD: every rank takes its block of the global arrays (k, v and an
    int cache's scales, the first n rows of a session) broadcast by rank
    0; rows past n keep what they held (dead rows)."""
    from lmrs_tpu_torch.quant import pack_kv_q4, unpack_kv_q4

    comm, cfg_l = shard.comm, shard.cfg_l
    cache = shard.caches[cid]
    kh_l, hd = cfg_l.n_kv_heads, cfg_l.cache_head_dim
    packed4 = is_packed4(cfg_l, cache)
    n = tensors[0].shape[1]
    s_loc = cache.k.shape[1]
    lo, hi = _piece(comm.cp_rank, s_loc, n)
    base = comm.cp_rank * s_loc
    for (name, plane, head_ax, seq_ax), full in zip(_planes(cache), tensors):
        full = full.view(plane.dtype) if plane.dtype == torch.bfloat16 \
            else full
        if packed4 and head_ax == 2:
            vals = unpack_kv_q4(full, cfg_l.n_kv_heads * comm.tp, hd)
            block = pack_kv_q4(vals.narrow(2, comm.tp_rank * kh_l, kh_l))
        else:
            width = plane.shape[head_ax]
            block = full.narrow(head_ax, comm.tp_rank * width, width)
        plane.narrow(seq_ax, lo, hi - lo).copy_(
            block.narrow(seq_ax, base + lo, hi - lo))
    return None


def rank_stats(shard: Shard):
    """Every rank's launch counts, peak memory, collectives and their host
    time, and load seconds, gathered on every rank: (names of the counts,
    (world, n) float64)."""
    from lmrs_tpu_torch.kernels import launches

    comm = shard.comm
    counts = launches()
    peak = (torch.cuda.max_memory_allocated(comm.device)
            if comm.device.type == "cuda" else 0)
    calls, seconds = comm.calls, comm.seconds
    buf = torch.zeros((comm.size, len(counts) + 5), dtype=torch.float64,
                      device=comm.device)
    buf[comm.rank] = torch.tensor(
        list(counts.values()) + [peak, calls, seconds, shard.load_s,
                                 comm.broadcasts], dtype=torch.float64)
    out = comm._all_reduce(buf, "world", dist.ReduceOp.SUM)
    # the stats' own collective is not the forward's
    comm.calls, comm.seconds = calls, seconds
    return list(counts), out.cpu()


# ---------------------------------------------------------------------------
# rank 0's handle and the followers' loop
# ---------------------------------------------------------------------------

def _header(op: int, ints: Sequence[int],
            tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    h = [0] * HEADER
    h[0], h[1] = op, len(tensors)
    for i, t in enumerate(tensors):
        if t.dim() > 3:
            raise ValueError("a mesh call's tensors have at most 3 axes")
        h[2 + 5 * i] = DTYPES.index(t.dtype)
        h[3 + 5 * i] = t.dim()
        for a, n in enumerate(t.shape):
            h[4 + 5 * i + a] = n
    if len(ints) > MAX_INTS:
        raise ValueError(f"a mesh call takes at most {MAX_INTS} integers")
    for i, v in enumerate(ints):
        h[2 + 5 * MAX_TENSORS + i] = int(v)
    return torch.tensor(h, dtype=torch.int64)


class Mesh:
    """Rank 0's handle on a (tp, cp) mesh of ranks that hold one model's
    shards: its `params` and local config are rank 0's own.  Every method
    is one call of all ranks (module note), serialized by a lock."""

    def __init__(self, shard: Shard, procs: Sequence = (), store=None):
        self.shard = shard
        self.comm = shard.comm
        self.cfg = shard.cfg
        self.cfg_l = shard.cfg_l
        self.params = shard.params
        self.tp, self.cp = self.comm.tp, self.comm.cp
        self.device = self.comm.device
        self.procs = list(procs)
        # the rendezvous server of spawned ranks lives as long as the mesh
        self._store = store
        self._lock = threading.Lock()
        self._ids = 0
        self.error: Optional[BaseException] = None
        self.load_seconds: List[float] = []

    # -- starting ------------------------------------------------------
    @classmethod
    def start(cls, f, tp: int = 1, cp: int = 1, device=None,
              timeout: float = DEFAULT_TIMEOUT,
              first_device: int = 0) -> "Mesh":
        """A mesh over a parsed .lmrs file `f` (its `cfg` may carry
        overrides, as the CLI's --seq-len): inside a process group from
        `initialize_multihost` its ranks are the group's (a follower
        serves here and then leaves the program), else tp*cp - 1 follower
        processes are spawned on this host.  `device` "cpu" runs every rank
        on the CPU (gloo); by default rank r takes cuda:(first_device + r)
        % the count."""
        from lmrs_tpu_torch.config import resolve_device

        world = tp * cp
        device = resolve_device(device)
        local_config(f.cfg, tp, cp)         # raises for an indivisible tp
        if dist.is_initialized():
            dev = rank_device(device.type,
                              int(os.environ.get("LOCAL_RANK",
                                                 dist.get_rank())))
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            comm = comm_from_world(tp, cp, dev)
            t0 = time.perf_counter()
            params, cfg_l = load_shard(f, f.cfg, comm, dev)
            shard = Shard(comm, f.cfg, cfg_l, params)
            shard.load_s = time.perf_counter() - t0
            if comm.rank:
                Follower(shard).loop()
                raise SystemExit(0)
            mesh = cls(shard)
            mesh.load_seconds = mesh.stats()["load_s"]
            return mesh
        if device.type == "cuda":
            from lmrs_tpu_torch.kernels import cuda

            cuda.build_all()     # the ranks load what rank 0 built
        backend = choose_backend(device, world, first_device)
        print(f"mesh: tp={tp} cp={cp}, {world} ranks on this host, backend "
              f"{backend}", flush=True)
        # every rank is local: gloo talks over the loopback device
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        store = dist.TCPStore("127.0.0.1", 0, world, True,
                              timeout=datetime.timedelta(seconds=timeout),
                              wait_for_workers=False)
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(
            target=follower_main, daemon=True,
            args=(r, tp, cp, store.port, f.path, f.cfg, device.type,
                  backend, timeout, first_device))
            for r in range(1, world)]
        for p in procs:
            p.start()
        try:
            t0 = time.perf_counter()
            # a rank that dies while it starts fails the start at once
            ready = [f"ready{r}" for r in range(1, world)]
            while not store.check(ready):
                for r, p in enumerate(procs, start=1):
                    if not p.is_alive():
                        raise RuntimeError(f"mesh rank {r} exited with code "
                                           f"{p.exitcode} while it started")
                if time.perf_counter() - t0 > timeout:
                    raise TimeoutError("mesh ranks did not start within "
                                       f"{timeout} s")
                time.sleep(0.05)
            dev = rank_device(device.type, 0, first_device)
            comm = connect(store, 0, tp, cp, dev, backend, timeout)
            params, cfg_l = load_shard(f, f.cfg, comm, dev)
            shard = Shard(comm, f.cfg, cfg_l, params)
            shard.load_s = time.perf_counter() - t0
            mesh = cls(shard, procs, store)
            mesh.load_seconds = mesh.stats()["load_s"]
        except BaseException:
            for p in procs:
                p.kill()
            raise
        return mesh

    # -- the call ------------------------------------------------------
    def _check_followers(self):
        for r, p in enumerate(self.procs, start=1):
            if not p.is_alive():
                raise RuntimeError(f"mesh rank {r} exited with code "
                                   f"{p.exitcode}")

    def call(self, op: int, ints: Sequence[int] = (),
             tensors: Sequence[torch.Tensor] = (),
             carry: Optional[torch.Tensor] = None):
        """Broadcast one call to the followers, run it here, return rank
        0's result.  `carry`, a one-element integer device tensor, rides
        in the header's last slot (copied there on the device).  A failure
        (here, in a collective, or a follower's death) breaks the mesh and
        raises."""
        with self._lock:
            if self.error is not None:
                raise RuntimeError("the mesh failed earlier") from self.error
            try:
                self._check_followers()
                dev = self.comm.device
                tensors = [t.to(dev).contiguous() for t in tensors]
                # rank 0's kernels launch on its device, whatever device
                # is current on the calling thread
                with (torch.cuda.device(dev) if dev.type == "cuda"
                      else contextlib.nullcontext()):
                    head = _header(op, ints, tensors).to(dev)
                    if carry is not None:
                        head[-1:] = carry.reshape(1)
                    self.comm.broadcast(head)
                    for t in tensors:
                        self.comm.broadcast(t)
                    return self.shard.run(op, list(ints), tensors, carry)
            except BaseException as e:
                self.error = e
                time.sleep(0.2)      # let a dying follower's exit show
                try:
                    self._check_followers()
                except RuntimeError as dead:
                    raise dead from e
                raise

    def new_id(self) -> int:
        self._ids += 1
        return self._ids

    # -- ops -----------------------------------------------------------
    def forward(self, cid: int, x: torch.Tensor, pos: int, logit_idx,
                w8a8: bool = True, slot: int = -1):
        logit = (NO_LOGITS if logit_idx is None else
                 ALL_LOGITS if isinstance(logit_idx, str) else logit_idx)
        return self.call(FORWARD, [cid, slot, pos, logit, int(w8a8)], [x])

    def forward_batched(self, cid: int, x: torch.Tensor, pos: torch.Tensor,
                        t_q: int = 1, table: Optional[torch.Tensor] = None,
                        logit_idx: Optional[int] = None, w8a8: bool = True,
                        want_logits: bool = True):
        logit = NO_LOGITS if logit_idx is None else logit_idx
        tensors = [x, pos] + ([] if table is None else [table])
        return self.call(FORWARD_B, [cid, t_q, logit, int(want_logits),
                                     int(w8a8)], tensors)

    def decode_chunk(self, cid: int, token: torch.Tensor, pos: int, n: int,
                     temperature: float, top_p: float, seed: int,
                     w8a8: bool = True) -> torch.Tensor:
        """`n` decode steps on every rank from `token` ((1,) on the device)
        at `pos` (`runtime.engine.decode_chunk`), one call: the (n,)
        tokens on rank 0's device."""
        return self.call(DECODE_CHUNK, [cid, pos, n, _bits(temperature),
                                        _bits(top_p), seed, int(w8a8)],
                         carry=token)

    def spec_chunk(self, cid: int, h: torch.Tensor, pos: int, n_steps: int,
                   k: int, temperature: float, top_p: float, seed: int,
                   w8a8: bool = True):
        """`n_steps` speculative steps on every rank from `pos`
        (`runtime.speculative.spec_chunk`), one call that carries the
        history h: (out_buf, n_out, accs, new_pos, h) of rank 0, h updated
        in place."""
        return self.call(SPEC_CHUNK, [cid, pos, n_steps, k,
                                      _bits(temperature), _bits(top_p), seed,
                                      int(w8a8)], [h])

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The (n, D) embedding rows of n token ids (every rank gathers
        from its block of the table)."""
        return self.call(EMBED, [], [tokens.long()])

    def new_cache(self, kind: int, dtype, a: int, b: int = 0):
        """(cache id, rank 0's shard) of a new cache on every rank
        (`models.transformer.new_cache`'s kinds)."""
        from lmrs_tpu_torch.models.transformer import cache_dtype_of

        cid = self.new_id()
        code = CACHE_CODES.index(cache_dtype_of(dtype))
        return cid, self.call(NEW_CACHE, [cid, kind, code, a, b])

    def free_cache(self, cid: int) -> None:
        if self.error is None and self.alive():
            self.call(FREE, [cid])

    def copy_rows(self, cid: int, kind: int, src: int, dst: int, n: int):
        self.call(COPY, [cid, kind, src, dst, n])

    def gather_cache(self, cid: int, n: int) -> Dict[str, torch.Tensor]:
        return self.call(SAVE, [cid, n])

    def scatter_cache(self, cid: int, arrays: Sequence[torch.Tensor]):
        self.call(LOAD, [cid], [_wire(a) for a in arrays])

    def reset_stats(self) -> None:
        """Zero every rank's launch counts, collective counters and peak
        memory."""
        self.call(RESET)

    def stats(self) -> Dict[str, list]:
        """Per rank: launch counts (a dict each), peak memory bytes,
        collectives and their host seconds since the last reset, the
        load seconds the rank reported when the mesh started, and the
        broadcasts since the last reset (headers and call tensors; this
        call's own header among them)."""
        names, arr = self.call(STATS)
        n = len(names)
        return {"launches": [dict(zip(names, (int(v) for v in row[:n])))
                             for row in arr.tolist()],
                "peak_bytes": [int(v) for v in arr[:, n]],
                "collectives": [int(v) for v in arr[:, n + 1]],
                "collective_s": [float(v) for v in arr[:, n + 2]],
                "load_s": [float(v) for v in arr[:, n + 3]],
                "broadcasts": [int(v) for v in arr[:, n + 4]]}

    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop the followers (they leave their loop) and wait for their
        processes; kill any that does not end."""
        with self._lock:
            if self.error is None and self.alive():
                try:
                    self.comm.broadcast(_header(STOP, (), ()).to(
                        self.comm.device))
                except Exception:  # a broken group: the kill below ends it
                    pass
            for p in self.procs:
                p.join(timeout)
                if p.is_alive():
                    p.kill()
                    p.join(5)
            self.procs = []
            self.error = self.error or RuntimeError("the mesh was shut down")


class Follower:
    """A follower rank's loop: receive a call, run it on the shard."""

    def __init__(self, shard: Shard):
        self.shard = shard

    def receive(self):
        comm = self.shard.comm
        h = comm.broadcast(torch.zeros(HEADER, dtype=torch.int64,
                                       device=comm.device)).tolist()
        tensors = []
        for i in range(h[1]):
            dtype, ndim = DTYPES[h[2 + 5 * i]], h[3 + 5 * i]
            shape = h[4 + 5 * i:4 + 5 * i + ndim]
            tensors.append(comm.broadcast(torch.empty(
                shape, dtype=dtype, device=comm.device)))
        carry = torch.full((1,), h[-1], dtype=torch.int64,
                           device=comm.device)
        return h[0], h[2 + 5 * MAX_TENSORS:], tensors, carry

    def loop(self) -> None:
        while True:
            op, ints, tensors, carry = self.receive()
            if op == STOP:
                return
            self.shard.run(op, ints, tensors, carry)


def follower_main(rank: int, tp: int, cp: int, port: int, path: str,
                  cfg: ModelConfig, device_type: str, backend: str,
                  timeout: float, first_device: int = 0) -> None:
    """A spawned follower: connect, load its shard of the file at `path`
    under `cfg`, then serve until STOP.  On any error it prints the traceback and
    exits non-zero, so that rank 0's next collective fails."""
    try:
        # a follower's host work is a Python loop of launches: one thread,
        # so that ranks (and test workers) sharing a host do not contend
        torch.set_num_threads(1)
        from lmrs_tpu_torch.io.lmrs import read_lmrs

        t0 = time.perf_counter()
        dev = rank_device(device_type, rank, first_device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.TCPStore("127.0.0.1", port, tp * cp, False,
                              timeout=datetime.timedelta(seconds=timeout))
        store.set(f"ready{rank}", "1")
        comm = connect(store, rank, tp, cp, dev, backend, timeout)
        params, cfg_l = load_shard(read_lmrs(path), cfg, comm, dev)
        shard = Shard(comm, cfg, cfg_l, params)
        shard.load_s = time.perf_counter() - t0
        Follower(shard).loop()
    except BaseException:
        traceback.print_exc()
        os._exit(1)
    os._exit(0)
