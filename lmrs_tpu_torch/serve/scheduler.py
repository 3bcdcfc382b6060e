"""Continuous-batching scheduler: many requests served by ONE model.

A decode step streams the weights once for however many rows it runs, so a
batch of B requests costs about what one does.  The scheduler keeps a slot
per request in a batched KV cache, admits requests between decode chunks
(continuous batching), emits tokens per slot and frees finished slots.
Counterpart of `lmrs_tpu/serve/scheduler.py`, on one device.

- All matmuls run on the stacked (B, D) rows (`models.transformer.
  forward_batched`); the cache writes and attention are per slot (kernels I
  and J).
- The cache is contiguous, one (L, S + slack, row) block per slot
  (`init_batched_kv_cache`), or paged: a shared pool of `page_size`-row
  pages and a (B, maxp) page table (`init_kv_pool`), whose memory is the
  sum of the live contexts.  int4 is paged only.
- Prefill is per slot and advances one chunk per tick, so admission never
  stalls the streams that decode.  A contiguous chunk runs the single-
  stream `forward` on the slot's own (L, S, row) block (kernels C, G, H); a
  paged one runs `forward_batched` with one lane through the slot's table
  row (kernel J).
- A decode chunk is `decode_chunk` steps whose sampled tokens stay on the
  device; the host reads the chunk's (n, B) tokens once at its end.  On
  one CUDA device a step's forward is a CUDA graph replayed
  (`models.transformer.DecodeGraph`, captured at the first decode step);
  the sampling after it stays eager.
  Temperature and top-p are per request (`ops.sampling.sample_batched`);
  whether any slot samples is known on the host, so an all-greedy batch
  never sorts its logits.
- Conversation leases pin a slot across turns (its KV prefix stays
  resident); the admission prefix cache forks a resident slot's rows for a
  prompt that shares their tokens (a copy, or shared refcounted pages);
  with a sliding window, pages that fell wholly behind it return to the
  pool; prompt-lookup speculation verifies k drafts per slot per step
  (`runtime.speculative.spec_chunk_batched`).

The scheduler keeps a bounded ring of host spans (`spans`: admission,
prefix search, prefill chunks, first tokens, decode chunks with their
launch and read, emission; `tracing`) and stamps each request's
admission and first token on the clock of its submit and done times.

With `mesh` (a `parallel.distributed.Mesh`, as `parallel.tp.
make_mesh_scheduler` builds it) the same scheduler drives a (tp, cp) mesh
of ranks, the JAX scheduler's mesh mode: every forward is one mesh call
(token ids or rows, positions, the page table), the cache is sharded (kv
heads on tp: the page pool with J on the local heads, or the per-slot
cache with I; the per-slot cache's sequence on cp, its writes row-exact
and its attention B1 merged over cp), prefix forks are mesh calls, and the
host side (slots, pages, sampling, the history) stays here.  A page pool
does not shard over cp.

PyTorch runs eagerly, so the JAX scheduler's compile-avoidance (attention
buckets, one program per padded chunk, warm-up sweeps) has no counterpart
here beyond the decode step's one graph: every step runs all B lanes with
the positions and the page table on the device, so it has one shape per
scheduler.  Prefill chunks, image rows, speculative verify windows and
mesh forwards run eagerly; prefill chunks are padded to a power of two
only because the padding decides which rows are written (and, paged, that
the window fits a page).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
import traceback
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from lmrs_tpu_torch import tracing
from lmrs_tpu_torch.config import ModelConfig, resolve_device
from lmrs_tpu_torch.models.transformer import (CacheDtype, DecodeGraph,
                                               KVCache, TransformerParams,
                                               cache_dtype_of, copy_rows,
                                               forward, forward_batched,
                                               new_cache, slot_view)
from lmrs_tpu_torch.ops.sampling import (sample_argmax, sample_batched,
                                         sample_multinomial, sample_topp)
from lmrs_tpu_torch.quant import q4_cache_supported
from lmrs_tpu_torch.runtime.speculative import spec_chunk_batched


class PoolExhausted(RuntimeError):
    """The paged KV pool has no free pages for a required allocation."""


def paged_supported(cfg: ModelConfig, cache_dtype=torch.bfloat16,
                    cp: int = 1) -> bool:
    """Whether the paged pool can serve this config on a mesh of `cp`
    sequence shards: the backend's --batch pages by default when it holds
    and keeps the contiguous cache otherwise (always under cp)."""
    if cp > 1 or cfg.cache_head_dim % 128:
        return False
    if cache_dtype_of(cache_dtype) == "int4":
        return q4_cache_supported(cfg.n_kv_heads, cfg.cache_head_dim)
    return True


def auto_pool_tokens(max_batch: int, max_ctx: int, page_size: int = 512,
                     fill: float = 0.75) -> int:
    """Default pool size: `fill` x the contiguous cache's B x max_ctx rows
    (live contexts rarely all reach max_ctx; an under-filled pool turns
    into admission backpressure, not an out-of-memory error), rounded up
    to whole pages, never below one page per slot."""
    rows = int(fill * max_batch * max_ctx)
    rows = max(rows, max_batch * page_size)
    return -(-rows // page_size) * page_size


def _pad_rows(chunk: int) -> int:
    """The rows a prefill chunk of `chunk` tokens writes: the next power of
    two, at least 8 (the JAX scheduler's padding, kept because it decides
    which rows are written)."""
    return max(8, 1 << (chunk - 1).bit_length())


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 256
    stop_tokens: frozenset = frozenset()
    on_token: Optional[Callable[[int], None]] = None
    on_done: Optional[Callable[[List[int]], None]] = None
    # per-request sampling parameters (None: the scheduler's defaults)
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    # filled by the scheduler; times on `time.perf_counter()`'s clock:
    # submitted, staged into a slot, first token sampled and read, done
    id: int = -1
    out: List[int] = dataclasses.field(default_factory=list)
    submit_time: float = 0.0
    admit_time: Optional[float] = None
    first_time: Optional[float] = None
    ttft: Optional[float] = None          # first_time - submit_time
    done_time: Optional[float] = None
    lease: Optional["Lease"] = None
    error: Optional[str] = None


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0
    lease: Optional["Lease"] = None
    # a request whose prompt is being prefilled, one chunk per tick
    pending: Optional[Request] = None
    # the prompt's token ids (N,), or an image's embeddings (N, D)
    pending_x: Optional[torch.Tensor] = None
    pending_off: int = 0
    # the token at each cached row (feeds the admission prefix cache),
    # valid through min(len, pos)
    tokens: List[int] = dataclasses.field(default_factory=list)
    # paged: the physical pages behind this slot's virtual pages (leading
    # entries become 0 once window-freed), and how many were freed
    pages: List[int] = dataclasses.field(default_factory=list)
    win_freed: int = 0


@dataclasses.dataclass
class Lease:
    """Pins one cache slot to a conversation across turns: its KV prefix
    stays resident and each turn continues from the slot's `pos`."""

    slot_idx: int
    released: bool = False


class BatchScheduler:
    """Slot-based continuous batching over one parameter set on one
    device.  Arguments as `lmrs_tpu.serve.scheduler.BatchScheduler`'s,
    without the mesh; `cache_dtype` is torch.bfloat16, torch.float32,
    torch.int8 or "int4" (or their names), `pool_tokens` turns on the
    paged pool, `w8a8` picks the Q8_0 layer numerics as `Engine`'s, and
    `mesh` drives a mesh of ranks (module note)."""

    def __init__(self, cfg: ModelConfig, params: TransformerParams,
                 max_batch: int = 8, max_ctx: Optional[int] = None,
                 cache_dtype: CacheDtype = torch.bfloat16,
                 prefill_chunk: int = 64, decode_chunk: int = 8,
                 temperature: float = 0.0, top_p: float = 0.9,
                 seed: int = 0, prefix_cache_min: int = 32,
                 speculative_k: int = 0, page_size: int = 512,
                 pool_tokens: Optional[int] = None, device=None,
                 w8a8: bool = True, mesh=None):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        if params.final_norm.device.type != self.device.type:
            raise ValueError(f"params lie on {params.final_norm.device}, "
                             f"the scheduler runs on {self.device}")
        cache_dtype = cache_dtype_of(cache_dtype)
        if cache_dtype == "int4" and pool_tokens is None:
            raise ValueError("the batched int4 KV cache is paged-only "
                             "(pass pool_tokens=...); use int8 for the "
                             "contiguous batched cache")
        self.paged = pool_tokens is not None
        cp = 1 if mesh is None else mesh.cp
        if cp > 1 and self.paged:
            raise ValueError("--pool-tokens with --cp is not supported: "
                             "pages shard on kv-head lanes, not the "
                             "sequence (use a contiguous batched cache "
                             "with --cp)")
        if self.paged:
            if cfg.cache_head_dim % 128:
                raise ValueError("the paged cache needs the fast kernel "
                                 "path and cache_head_dim % 128 == 0 "
                                 f"(got {cfg.cache_head_dim})")
            if cache_dtype == "int4" and not q4_cache_supported(
                    cfg.n_kv_heads, cfg.cache_head_dim):
                raise ValueError(
                    "the int4 pool's in-kernel nibble unpack needs "
                    "cache_head_dim % 256 == 0 or (cache_head_dim % "
                    "128 == 0 with an even kv-head count); got "
                    f"hd={cfg.cache_head_dim}, kh={cfg.n_kv_heads}")
            # a query window must fit one page (kernel J's t_q <= psz):
            # the largest is the padded prefill chunk or the verify window
            min_page = max(_pad_rows(prefill_chunk), speculative_k + 1)
            if page_size < min_page or page_size % 8:
                raise ValueError(
                    f"page_size {page_size} too small: needs a multiple "
                    f"of 8 that is >= the padded prefill chunk / "
                    f"speculative window ({min_page})")
        self.cfg = cfg
        self.params = params
        self.w8a8 = w8a8
        self.B = max_batch
        self.S = min(max_ctx or cfg.seq_len, cfg.seq_len)
        self.prefill_chunk = prefill_chunk
        self.decode_chunk = decode_chunk
        self.temperature = temperature
        self.top_p = top_p
        self.spec_k = speculative_k
        self.spec_proposed = 0
        self.spec_accepted = 0
        # the (B, S + slack) token history of the speculative chunk stays
        # on the device; rows whose host history changed (admission, slot
        # reuse, a stop mid-chunk) are uploaded again before the next one
        self._h_dev: Optional[torch.Tensor] = None
        self._h_dirty = set()
        # Slack rows past S: lanes without a request still run through the
        # batched step and write rows at their own pos (an idle leased
        # conversation's dead region); near S those writes land here.
        # With speculation every step writes a (k+1)-row window.
        self._slack = max(decode_chunk * (speculative_k + 1), 8)
        # under cp the per-slot rows split evenly over the shards
        self._slack += -(self.S + self._slack) % cp
        if self.paged:
            self.psz = page_size
            # virtual pages cover S plus the in-chunk write overhang;
            # entries past a slot's pages stay 0, the trash page
            self.maxp = -(-(self.S + self._slack
                            + max(prefill_chunk, decode_chunk)) // page_size)
            self.n_pages = max(1, -(-pool_tokens // page_size)) + 1
            self.cache = self._new_cache(2, cache_dtype, self.n_pages,
                                         page_size)
            self._table = np.zeros((self.B, self.maxp), np.int32)
            self._table_dev = torch.zeros((self.B, self.maxp),
                                          dtype=torch.int32,
                                          device=self.device)
            self._table_dirty = False
            self._free_pages = list(range(self.n_pages - 1, 0, -1))  # pop()
            # prefix forks share full prefix pages read-only; a page
            # returns to the free list when its last holder releases it
            self._page_refs = np.zeros(self.n_pages, np.int32)
            self.pages_peak = 0
        else:
            self.cache = self._new_cache(1, cache_dtype, self.B,
                                         (self.S + self._slack) // cp)
        self.slots = [_Slot() for _ in range(self.B)]
        self.waiting: List[Request] = []
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.tokens_emitted = 0
        # the decode chunks' `sched.decode` spans, summed
        self.decode_seconds = 0.0
        self.decode_steps = 0
        # the host spans of the serving loop (`tracing`), newest last
        self.spans = tracing.ring()
        # admission prefix cache: a fresh request whose prompt shares at
        # least prefix_cache_min tokens with a resident slot's history
        # forks those rows instead of prefilling them; 0 turns it off
        self.prefix_cache_min = prefix_cache_min
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        # the decode step as a CUDA graph: one device, no mesh
        self._graph = (DecodeGraph(params, cfg, w8a8)
                       if self.device.type == "cuda" and mesh is None
                       else None)

    @property
    def decode_graph_captures(self) -> int:
        """Captures of the decode step's CUDA graph: 1 once the first
        decode step has run on one CUDA device without a mesh, else 0."""
        return 0 if self._graph is None else self._graph.captures

    @property
    def decode_graph_replays(self) -> int:
        """Decode steps that replayed the graph."""
        return 0 if self._graph is None else self._graph.replays

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _span(self, name: str, rid: int = -1, n: int = 0) -> tracing.Span:
        return tracing.Span(self.spans, name, rid, n)

    # -- the model: here, or one call of the mesh ----------------------
    def _new_cache(self, kind: int, dtype, a: int, b: int) -> KVCache:
        """The per-slot cache (kind 1: `a` slots of `b` rows) or the page
        pool (kind 2: `a` pages of `b` rows); on a mesh every rank's shard
        (rank 0's is returned)."""
        if self.mesh is not None:
            self._cid, cache = self.mesh.new_cache(kind, dtype, a, b)
            return cache
        return new_cache(self.cfg, self.device, kind, dtype, a, b)

    def close(self) -> None:
        """Give back a mesh scheduler's cache shards on every rank."""
        if self.mesh is not None and self._cid is not None:
            self.mesh.free_cache(self._cid)
            self._cid = None

    def _fwd_slot(self, slot_idx: int, xt: torch.Tensor, pos: int,
                  logit_idx: Optional[int]) -> Optional[torch.Tensor]:
        """The single-stream forward on slot i's block of the per-slot
        cache."""
        if self.mesh is not None:
            return self.mesh.forward(self._cid, xt, pos, logit_idx,
                                     self.w8a8, slot=slot_idx)
        return forward(self.params, self.cfg, self._slot_view(slot_idx), xt,
                       pos, logit_idx, w8a8=self.w8a8)

    def _fwd_b(self, x: torch.Tensor, p: torch.Tensor, t_q: int = 1,
               table: Optional[torch.Tensor] = None,
               logit_idx: Optional[int] = None,
               want_logits: bool = True) -> Optional[torch.Tensor]:
        """The batched forward over the scheduler's cache.  A decode step of
        every lane (t_q 1, the (B,) token ids, all logits) on one CUDA
        device replays the decode graph: its logits are the graph's static
        buffer, which the next such call overwrites, so the caller reads
        them (in stream order) before it calls again, as `_decode`'s
        sampling does."""
        if self.mesh is not None:
            return self.mesh.forward_batched(self._cid, x, p, t_q, table,
                                             logit_idx, self.w8a8,
                                             want_logits)
        if (self._graph is not None and t_q == 1 and logit_idx is None
                and want_logits and not x.dtype.is_floating_point
                and x.shape[0] == self.B):
            return self._graph(self.cache, x, p, table)
        return forward_batched(self.params, self.cfg, self.cache, x, p,
                               t_q=t_q, table=table, logit_idx=logit_idx,
                               w8a8=self.w8a8, want_logits=want_logits)

    def _copy(self, kind: int, src: int, dst: int, n: int) -> None:
        """A prefix fork's copy (`models.transformer.copy_rows`)."""
        if self.mesh is not None:
            self.mesh.copy_rows(self._cid, kind, src, dst, n)
        else:
            copy_rows(self.cache, kind, src, dst, n)

    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 256,
               stop_tokens: Sequence[int] = (),
               on_token: Optional[Callable[[int], None]] = None,
               on_done: Optional[Callable[[List[int]], None]] = None,
               lease: Optional[Lease] = None,
               temperature: Optional[float] = None,
               top_p: Optional[float] = None) -> Request:
        base = 0 if lease is None else self.slots[lease.slot_idx].pos
        if base + len(prompt) + 1 > self.S:
            raise ValueError(f"prompt of {len(prompt)} at pos {base} exceeds"
                             f" max context {self.S}")
        req = Request(prompt=list(prompt), max_new_tokens=max_new_tokens,
                      stop_tokens=frozenset(int(t) for t in stop_tokens),
                      on_token=on_token, on_done=on_done,
                      id=next(self._ids), submit_time=time.perf_counter(),
                      temperature=(self.temperature if temperature is None
                                   else temperature),
                      top_p=self.top_p if top_p is None else top_p)
        req.lease = lease
        with self._lock:
            self.waiting.append(req)
        return req

    # -- conversation leases (multi-turn KV residency) -------------------
    def new_conversation(self) -> Optional[Lease]:
        """Reserve a free slot for a conversation; None if none is free."""
        with self._lock:
            for i, s in enumerate(self.slots):
                if s.lease is None and s.req is None and s.pending is None:
                    lease = Lease(slot_idx=i)
                    s.lease = lease
                    s.pos = 0
                    s.tokens = []
                    return lease
        return None

    def end_conversation(self, lease: Lease):
        lease.released = True
        slot = self.slots[lease.slot_idx]
        with self._lock:
            if slot.lease is lease:
                slot.lease = None
                if slot.req is None:
                    slot.pos = 0
                    if self.paged:
                        self._free_slot_pages(lease.slot_idx)

    def prefill_embeds(self, lease: Lease, embeds: torch.Tensor) -> None:
        """Prefill precomputed (N, D) embeddings (an image's rows) into a
        leased conversation's slot at its `pos`, chunk by chunk, without
        sampling; call it on the scheduler's thread between steps
        (`SchedulerThread.call`).  Paged, the slot takes the pages for all
        N rows first (PoolExhausted if the pool cannot give them: the slot
        then keeps its pos and gives back the pages it took).  The rows run
        no classifier.  Their tokens are recorded as -1, which no prompt
        matches, so the admission prefix cache never forks them."""
        slot_idx = lease.slot_idx
        slot = self.slots[slot_idx]
        n = embeds.shape[0]
        if slot.req is not None or slot.pending is not None:
            raise ValueError(f"slot {slot_idx} is busy with a request")
        if slot.pos + n + 1 > self.S:
            raise ValueError(f"image prefix of {n} embeddings at pos "
                             f"{slot.pos} exceeds max context {self.S}")
        had = len(slot.pages)
        if self.paged and not self._ensure_pages(slot_idx, slot.pos + n):
            for i in range(had, len(slot.pages)):
                self._release_page(slot.pages[i])
                self._table[slot_idx, i] = 0
            del slot.pages[had:]
            self._table_dirty = True
            raise PoolExhausted(f"slot {slot_idx}: no free pages for "
                                f"{n} embedding rows at pos {slot.pos}")
        x = embeds.to(self.device, torch.float32)
        pos0 = slot.pos
        for off in range(0, n, self.prefill_chunk):
            slot.pos += self._prefill_chunk(slot_idx, x, off,
                                            want_logits=False)[1]
        # list index == row position: a previous turn's final (never
        # cached) token at pos0 is overwritten by the embeddings
        del slot.tokens[pos0:]
        slot.tokens.extend([-1] * n)
        self._h_dirty.add(slot_idx)
        self._release_window_pages()

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s.req is not None)

    def has_work(self) -> bool:
        return (self.active > 0 or bool(self.waiting)
                or any(s.pending is not None for s in self.slots))

    # -- paged-pool bookkeeping ----------------------------------------
    def _table_sync(self):
        if self._table_dirty:
            self._table_dev.copy_(torch.from_numpy(self._table))
            self._table_dirty = False

    def pages_used(self) -> int:
        return self.n_pages - 1 - len(self._free_pages)

    def _pending_reserve_pages(self, exclude: int = -1) -> int:
        """Pages the already-staged prefills will still claim: admission
        must not hand the same free pages to two prompts."""
        need = 0
        for j, s in enumerate(self.slots):
            if j == exclude or s.pending is None:
                continue
            rows = s.pos + (s.pending_x.shape[0] - s.pending_off) + 1
            need += max(0, min(-(-rows // self.psz) - len(s.pages),
                               self._max_live_pages(rows)))
        return need

    def _take_page(self) -> int:
        pg = self._free_pages.pop()
        self._page_refs[pg] = 1
        self.pages_peak = max(self.pages_peak, self.pages_used())
        return pg

    def _ensure_pages(self, slot_idx: int, rows: int) -> bool:
        """Grow the slot's pages to cover `rows` virtual rows; False if the
        pool ran out (pages taken so far stay)."""
        slot = self.slots[slot_idx]
        need = -(-rows // self.psz)
        while len(slot.pages) < need:
            if not self._free_pages:
                return False
            pg = self._take_page()
            self._table[slot_idx, len(slot.pages)] = pg
            slot.pages.append(pg)
            self._table_dirty = True
        return True

    def _release_page(self, pg: int):
        self._page_refs[pg] -= 1
        if self._page_refs[pg] == 0:
            self._free_pages.append(pg)

    def _free_slot_pages(self, slot_idx: int):
        slot = self.slots[slot_idx]
        if slot.pages:
            for pg in slot.pages:
                if pg:                    # 0: a window-freed placeholder
                    self._release_page(pg)
            slot.pages = []
            slot.win_freed = 0
            self._table[slot_idx, :] = 0
            self._table_dirty = True

    def _release_window_pages(self):
        """Free the pages every row of which fell behind the sliding
        window: kernel J starts each slot's walk at pos - window, and pos
        only grows, so they are never read again.  A shared prefix page
        returns to the pool when its last holder passes it."""
        w = self.cfg.sliding_window
        if w is None or not self.paged:
            return
        for i, s in enumerate(self.slots):
            dead = min(max(0, s.pos - w) // self.psz, len(s.pages))
            for j in range(s.win_freed, dead):
                pg = s.pages[j]
                if pg:
                    self._release_page(pg)
                    s.pages[j] = 0
                    self._table[i, j] = 0
                    self._table_dirty = True
            s.win_freed = max(s.win_freed, dead)

    def _max_live_pages(self, rows: int) -> int:
        """Most pages a slot holds at once while growing to `rows` virtual
        rows: with a sliding window, leading pages free as pos advances,
        so admission needs only the window's worth (plus a chunk)."""
        total = -(-rows // self.psz)
        w = self.cfg.sliding_window
        if w is None or not self.paged:
            return total
        live = -(-(w + max(self.prefill_chunk, self._slack)) // self.psz) + 1
        return min(total, live)

    def _fork_prefix_paged(self, donor_idx: int, dst_idx: int,
                           n_rows: int) -> bool:
        """Paged prefix fork: the new slot shares the donor's full prefix
        pages (read-only: both write only at rows >= their pos >= n_rows)
        and copies the partial boundary page.  False if that page cannot
        be had."""
        donor = self.slots[donor_idx]
        slot = self.slots[dst_idx]
        n_full, r = divmod(n_rows, self.psz)
        if r and not self._free_pages:
            return False
        assert not slot.pages, "prefix fork targets an empty slot"
        for j in range(n_full):
            pg = donor.pages[j]
            self._page_refs[pg] += 1
            self._table[dst_idx, j] = pg
            slot.pages.append(pg)
        if r:
            pg = self._take_page()
            self._table[dst_idx, n_full] = pg
            slot.pages.append(pg)
            self._copy(1, donor.pages[n_full], pg, r)
        self._table_dirty = True
        return True

    def _copy_prefix(self, src: int, dst: int, n_rows: int):
        """Contiguous prefix fork: copy rows [0, n_rows) of slot src."""
        self._copy(0, src, dst, n_rows)

    def _slot_view(self, i: int) -> KVCache:
        """Slot i's (L, S + slack, row) block of the contiguous cache: a
        single-stream cache whose writes land in the batched one."""
        return slot_view(self.cache, i)

    def _prefill_call(self, slot_idx: int, xt: torch.Tensor, pos: int,
                      logit_idx: Optional[int],
                      real_rows: int) -> Optional[torch.Tensor]:
        """One prefill chunk (xt padded: token ids or rows) into the slot at
        `pos`; returns the logits of row `logit_idx` (None: no classifier,
        no logits).
        Paged: raises PoolExhausted when
        the pool cannot cover the chunk's REAL rows; the pad overhang
        writes through unallocated table entries into the trash page, so
        padding never costs a page."""
        with torch.no_grad():
            if not self.paged:
                return self._fwd_slot(slot_idx, xt, pos, logit_idx)
            if not self._ensure_pages(slot_idx, pos + real_rows):
                raise PoolExhausted(f"slot {slot_idx}: no free pages for "
                                    f"prefill rows through "
                                    f"{pos + real_rows}")
            self._table_sync()
            p = torch.tensor([pos], dtype=torch.int32, device=self.device)
            logits = self._fwd_b(
                xt, p, t_q=xt.shape[0],
                table=self._table_dev[slot_idx:slot_idx + 1],
                logit_idx=logit_idx, want_logits=logit_idx is not None)
            return None if logits is None else logits[0]

    def _prefill_chunk(self, slot_idx: int, x: torch.Tensor, off: int,
                       want_logits: bool = True):
        """The next chunk of x, the N token ids or (N, D) rows, from row
        `off` into the slot at its pos, padded to `_pad_rows` (pad tokens
        are id 0, pad rows zero: rows past the chunk's, never read before
        they are written again); returns (the logits of the
        chunk's last row, or None without `want_logits`, the chunk's real
        rows)."""
        pos = self.slots[slot_idx].pos
        chunk = min(self.prefill_chunk, x.shape[0] - off)
        pad = min(_pad_rows(chunk), self.S + self._slack - pos)
        xt = x[off:off + chunk]
        if chunk < pad:
            xt = torch.nn.functional.pad(
                xt, (0, 0, 0, pad - chunk) if xt.ndim == 2
                else (0, pad - chunk))
        return self._prefill_call(slot_idx, xt, pos,
                                  chunk - 1 if want_logits else None,
                                  chunk), chunk

    # ------------------------------------------------------------------
    def _admit(self):
        with self._span("sched.admit") as sp:
            with self._lock:
                pending = list(self.waiting)
            for req in pending:
                if self._admit_one(req):
                    sp.n += 1

    def _admit_one(self, req: Request) -> bool:
        """Stage `req` into a slot (its lease's, or a free one), forking a
        resident prefix where one is shared; False if it waits or fails."""
        if req.lease is not None:
            slot_idx = req.lease.slot_idx
            slot = self.slots[slot_idx]
            if slot.req is not None or slot.pending is not None:
                return False  # the previous turn still runs
        else:
            free = [i for i, s in enumerate(self.slots)
                    if s.req is None and s.lease is None
                    and s.pending is None]
            if not free:
                return False
            slot_idx = free[0]
            slot = self.slots[slot_idx]
            slot.pos = 0
            slot.tokens = []
        if self.paged:
            need_rows = slot.pos + len(req.prompt) + 1
            # with a window, leading pages recycle mid-prefill: the
            # most pages held at once, not the whole prompt's
            need = self._max_live_pages(need_rows) * self.psz
            # free pages minus what staged prefills will still claim
            avail = (len(self._free_pages)
                     - self._pending_reserve_pages(exclude=slot_idx))
            have = len(slot.pages) * self.psz + avail * self.psz
            if need > have:
                # wait while something runs that will free pages;
                # otherwise nothing will free by itself: fail
                if (self.active > 0
                        or any(s.pending is not None for s in self.slots)):
                    return False
                with self._lock:
                    if req not in self.waiting:
                        return False
                    self.waiting.remove(req)
                held = sum(len(s.pages) for j, s in enumerate(self.slots)
                           if j != slot_idx)
                if held:
                    req.error = (
                        f"prompt needs {need} kv-pool rows but only "
                        f"{have} are available ({held} pages held by "
                        "idle conversations — end_conversation frees "
                        "them)")
                else:
                    req.error = ("prompt needs more kv-pool rows than "
                                 f"the whole pool has ({need} > {have})")
                if req.on_done is not None:
                    req.on_done(req.out)
                return False
        with self._lock:
            if req not in self.waiting:
                return False
            self.waiting.remove(req)
        # a leased slot's pos may have grown since submit()
        if slot.pos + len(req.prompt) + 1 > self.S:
            req.error = (f"context overflow at admission: pos={slot.pos}"
                         f" + prompt {len(req.prompt)} exceeds {self.S}")
            if req.on_done is not None:
                req.on_done(req.out)
            return False
        slot.pending = req
        req.admit_time = time.perf_counter()
        slot.pending_x = torch.as_tensor(req.prompt, dtype=torch.long,
                                         device=self.device)
        slot.pending_off = 0
        if slot.pos == 0 and self.prefix_cache_min:
            with self._span("sched.prefix", req.id) as sp:
                n_cp, donor = self._best_prefix(req.prompt, slot_idx)
                if n_cp < self.prefix_cache_min:
                    return True
                if self.paged:
                    if not self._fork_prefix_paged(donor, slot_idx, n_cp):
                        return True  # no boundary page: full prefill
                else:
                    self._copy_prefix(donor, slot_idx, n_cp)
                sp.n = n_cp
            slot.pos = n_cp
            slot.pending_off = n_cp
            slot.tokens = list(req.prompt[:n_cp])
            self.prefix_hits += 1
            self.prefix_tokens_saved += n_cp
        return True

    def _best_prefix(self, prompt: Sequence[int], exclude: int):
        """(longest shared token prefix, donor slot) over the resident
        slots, capped at len(prompt) - 1 so that the tail prefill still
        yields the first token's logits; slots mid-prefill, free slots and
        slots with window-freed pages are no donors, and a match ends at
        the first row with no token (-1: an image's row)."""
        best, donor = 0, -1
        for i, s in enumerate(self.slots):
            if i == exclude or s.pending is not None:
                continue
            if s.req is None and s.lease is None:
                continue
            if s.win_freed:
                continue
            limit = min(len(s.tokens), s.pos, len(prompt) - 1)
            n = 0
            while n < limit and s.tokens[n] == prompt[n] >= 0:
                n += 1
            if n > best:
                best, donor = n, i
        return best, donor

    def _advance_prefills(self):
        """At most one prefill chunk for every slot with a staged request;
        a request whose prompt is complete samples its first token with its
        own parameters and becomes active."""
        for slot_idx, slot in enumerate(self.slots):
            req = slot.pending
            if req is None:
                continue
            n = slot.pending_x.shape[0]
            off = slot.pending_off
            try:
                with self._span("sched.prefill", req.id,
                                min(self.prefill_chunk, n - off)):
                    logits, chunk = self._prefill_chunk(slot_idx,
                                                        slot.pending_x, off)
            except PoolExhausted:
                req.error = "kv page pool exhausted mid-prefill"
                slot.pending = None
                slot.pending_x = None
                if slot.lease is None:
                    self._free_slot_pages(slot_idx)
                    slot.pos = 0
                    slot.tokens = []
                if req.on_done is not None:
                    req.on_done(req.out)
                continue
            last = off + chunk >= n
            start_pos = slot.pos
            slot.pos += chunk
            # list index == row position: a lease's next turn overwrites
            # the previous turn's final (never cached) token
            del slot.tokens[start_pos:]
            slot.tokens.extend(req.prompt[off:off + chunk])
            slot.pending_off = off + chunk
            self._h_dirty.add(slot_idx)
            self._release_window_pages()
            if not last:
                continue
            with self._span("sched.first_token", req.id, 1) as sp, \
                    torch.no_grad():
                if req.temperature == 0.0:
                    first = sample_argmax(logits)
                elif req.top_p <= 0.0 or req.top_p >= 1.0:
                    first = sample_multinomial(logits, req.temperature,
                                               self.generator)
                else:
                    first = sample_topp(logits, req.temperature, req.top_p,
                                        self.generator)
                first = int(first)
            req.first_time = sp.t1 * 1e-9
            req.ttft = req.first_time - req.submit_time
            slot.pending = None
            slot.pending_x = None
            slot.req = req
            self._emit(slot_idx, slot, [first])

    def _emit(self, slot_idx: int, slot: _Slot, toks: List[int]) -> int:
        """Append tokens to the slot's request up to a stop token or the
        budget; returns how many were taken."""
        req = slot.req
        for i, t in enumerate(toks):
            req.out.append(t)
            slot.tokens.append(t)
            self.tokens_emitted += 1
            if req.on_token is not None:
                req.on_token(t)
            if t in req.stop_tokens or len(req.out) >= req.max_new_tokens:
                self._finish(slot_idx, slot)
                return i + 1
        return len(toks)

    def _finish(self, slot_idx: int, slot: _Slot):
        req = slot.req
        slot.req = None
        req.done_time = time.perf_counter()
        self._h_dirty.add(slot_idx)
        if slot.lease is None or slot.lease.released:
            slot.lease = None
            slot.pos = 0
            slot.tokens = []
            if self.paged:
                self._free_slot_pages(slot_idx)
        # a leased slot keeps pos: the conversation stays resident
        if req.on_done is not None:
            req.on_done(req.out)

    # ------------------------------------------------------------------
    def step(self):
        """One tick: admit waiting requests, advance each staged prefill
        by one chunk, then one decode chunk for all active slots."""
        with self._span("sched.tick") as sp:
            self._release_window_pages()
            self._admit()
            sp.n = sum(1 for s in self.slots
                       if s.req is not None or s.pending is not None)
            self._advance_prefills()
            self._decode()

    def _decode(self):
        """The tick's decode chunk over the active slots, if any."""
        active = [(i, s) for i, s in enumerate(self.slots)
                  if s.req is not None]
        if not active:
            return
        n = self.decode_chunk
        # slots at their context limit finish now (a speculative step may
        # write a (k+1)-row window)
        row_budget = n * (self.spec_k + 1) if self.spec_k else n
        for i, s in list(active):
            if s.pos + row_budget >= self.S:
                self._finish(i, s)
            elif self.paged and not self._ensure_pages(i,
                                                       s.pos + row_budget):
                # pool exhausted: finish this request (backpressure), its
                # pages free for the others
                s.req.error = "kv page pool exhausted"
                self._finish(i, s)
        active = [(i, s) for i, s in enumerate(self.slots)
                  if s.req is not None]
        if not active:
            return

        tokens = np.zeros((self.B,), np.int64)
        # lanes without a request write rows at their own pos, beyond
        # their history (pos 0 would overwrite an idle lease's prefix)
        pos = np.asarray([s.pos for s in self.slots], np.int32)
        temps = np.zeros((self.B,), np.float32)    # idle lanes: greedy
        top_ps = np.full((self.B,), 0.9, np.float32)
        for i, s in active:
            tokens[i] = s.req.out[-1]
            temps[i] = s.req.temperature
            top_ps[i] = s.req.top_p
        if self.paged:
            self._table_sync()
        if self.spec_k:
            self._step_speculative(active, tokens, pos, temps, top_ps, n)
            return
        dev = self.device
        table = self._table_dev if self.paged else None
        any_sampled = bool((temps > 0.0).any())
        with self._span("sched.decode", n=len(active)) as span, \
                torch.no_grad():
            with self._span("sched.decode.launch", n=n):
                toks = torch.from_numpy(tokens).to(dev)
                p = torch.from_numpy(pos).to(dev)
                temps_d = torch.from_numpy(temps).to(dev)
                top_ps_d = torch.from_numpy(top_ps).to(dev)
                staged = tracing.profiling()
                replays = self.decode_graph_replays
                graph_span = (contextlib.nullcontext() if self._graph is None
                              else self._span("sched.decode.graph"))
                outs = []
                with graph_span:
                    for _ in range(n):
                        logits = self._fwd_b(toks, p, table=table)
                        with tracing.stage("sample", staged):
                            toks = sample_batched(logits, temps_d, top_ps_d,
                                                  self.generator, any_sampled)
                        p = p + 1
                        outs.append(toks)
                    if self._graph is not None:
                        graph_span.n = self.decode_graph_replays - replays
                out = torch.stack(outs)
            with self._span("sched.decode.read", n=n):
                arr = out.cpu().numpy()        # (n, B): one host read
        self.decode_seconds += span.seconds
        self.decode_steps += n
        with self._span("sched.emit") as sp:
            for i, s in active:
                sp.n += self._emit_chunk(i, s, [int(t) for t in arr[:, i]])

    def _emit_chunk(self, i: int, s: _Slot, toks: List[int]) -> int:
        """Hand a decode chunk's tokens to slot i's request and advance the
        slot's pos past those it took (after a stop mid-chunk the
        overshoot rows sit beyond pos and stay masked); returns how many.
        A callback may free the slot and lease it to a new conversation:
        pos then stays that conversation's."""
        req, lease, pos_before = s.req, s.lease, s.pos
        used = self._emit(i, s, toks)
        with self._lock:
            if s.req is req or (lease is not None and s.lease is lease):
                s.pos = pos_before + used
        return used

    def _step_speculative(self, active, tokens, pos, temps, top_ps,
                          n: int):
        """One speculative decode chunk: each step a greedy slot emits
        1..k+1 tokens, a sampled one 1..k+1 by rejection sampling."""
        k = self.spec_k
        sh = self.S + self._slack
        dev = self.device
        table = self._table_dev if self.paged else None
        with self._span("sched.decode", n=len(active)) as span, \
                torch.no_grad():
            with self._span("sched.decode.launch", n=n):
                if self._h_dev is None:
                    self._h_dev = torch.full((self.B, sh), -1,
                                             dtype=torch.long, device=dev)
                    self._h_dirty = set(range(self.B))
                for i in sorted(self._h_dirty):
                    row = np.full((sh,), -1, np.int64)
                    t = self.slots[i].tokens[:sh]
                    row[:len(t)] = t
                    self._h_dev[i].copy_(torch.from_numpy(row))
                self._h_dirty.clear()
                out, n_out, accs = spec_chunk_batched(
                    lambda x, p, t_q: self._fwd_b(x, p, t_q, table),
                    self.cfg, self._h_dev, torch.from_numpy(tokens).to(dev),
                    torch.from_numpy(pos).to(dev), n, k, temps.tolist(),
                    top_ps.tolist(), self.generator)
                # one host read of the chunk: tokens, counts, accepted
                # drafts
                out = torch.cat([out.reshape(-1), n_out, accs.reshape(-1)])
            with self._span("sched.decode.read", n=n):
                flat = out.cpu().numpy()
        nb = self.B * n * (k + 1)
        arr = flat[:nb].reshape(self.B, n * (k + 1))
        counts = flat[nb:nb + self.B]
        accs_np = flat[nb + self.B:].reshape(n, self.B)
        self.decode_seconds += span.seconds
        self.decode_steps += n
        with self._span("sched.emit") as sp:
            for i, s in active:
                self.spec_proposed += n * k
                self.spec_accepted += int(accs_np[:, i].sum())
                used = self._emit_chunk(
                    i, s, [int(t) for t in arr[i, :counts[i]]])
                if used != int(counts[i]):
                    self._h_dirty.add(i)
                sp.n += used

    def abort(self, error: str):
        """End every waiting, staged and active request with `error` (the
        scheduler thread does this when a step raised)."""
        with self._lock:
            reqs, self.waiting = list(self.waiting), []
        for s in self.slots:
            reqs += [r for r in (s.pending, s.req) if r is not None]
            s.pending = s.pending_x = s.req = None
        for r in reqs:
            r.error = error
            if r.on_done is not None:
                r.on_done(r.out)

    def bind_thread(self):
        """Make the scheduler's GPU the current device of the calling
        thread (a thread that steps it: kernels launch on the current
        device)."""
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)

    def warmup(self):
        """Build and load the CUDA kernels before taking traffic (eager
        PyTorch has nothing else to prepare).  A no-op on the CPU."""
        if self.device.type == "cuda":
            from lmrs_tpu_torch.kernels import cuda

            for name in cuda.SOURCES:
                cuda.library(name)

    def run(self, poll: Optional[Callable[[], bool]] = None):
        """Step until no work remains (poll() False stops early)."""
        while self.has_work():
            self.step()
            if poll is not None and not poll():
                return


class SchedulerThread:
    """A daemon thread that steps a BatchScheduler.

    Every change of device state (prefill, decode, the cache) happens on
    this thread; other threads reach it through `submit` and `call` (a job
    queue drained between decode chunks).  If a step raises, the thread
    ends every request with the error, keeps the exception in `error` and
    stops; `submit` and `call` then raise it.
    """

    def __init__(self, sched: BatchScheduler):
        self.sched = sched
        self.error: Optional[BaseException] = None
        self._jobs: List[Callable[[], None]] = []
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _check(self):
        if self.error is not None:
            raise RuntimeError("the scheduler thread stopped") from self.error

    def submit(self, *args, **kw) -> Request:
        self._check()
        req = self.sched.submit(*args, **kw)
        with self._cv:
            self._cv.notify()
        return req

    def call(self, fn: Callable[[], object]):
        """Run fn on the scheduler thread between chunks and return its
        result (blocking); its exception is raised here."""
        self._check()
        done = threading.Event()
        box = {}

        def job():
            try:
                box["result"] = fn()
            except Exception as e:  # handed to the caller
                box["error"] = e
            done.set()

        with self._cv:
            self._jobs.append(job)
            self._cv.notify()
        done.wait()
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5)

    def _run(self):
        try:
            self.sched.bind_thread()
            self._loop()
        except Exception as e:  # ends the requests, kept for the callers
            traceback.print_exc()
            self.error = e
            self.sched.abort(f"scheduler step failed: {e!r}")
            with self._cv:
                jobs, self._jobs = self._jobs, []
            for j in jobs:          # their callers see the error
                j()

    def _loop(self):
        while True:
            with self._cv:
                while (not self._stop and not self._jobs
                       and not self.sched.has_work()):
                    self._cv.wait()
                if self._stop:
                    return
                jobs, self._jobs = self._jobs, []
            for j in jobs:
                j()
            if self.sched.has_work():
                self.sched.step()
