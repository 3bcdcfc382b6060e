"""Inference engine: chunked prefill, the chunked decode loop, speculative
decoding, sampling, sessions, metrics.

PyTorch runs eagerly, so the engine has no compiled programs and no static
shapes: a prompt prefills in chunks of at most `prefill_chunk` real rows.
Decoding runs in chunks of `decode_chunk` steps (`decode_chunk`, the JAX
`_compiled_fns._decode_chunk` with its scan written as a Python loop):
embed -> forward -> sample from a device token at a device position, the
forward taking its position from the device (`models.transformer.forward`
with `pos_range`), so that a chunk is one function of device tensors with
no host read inside.  `generate` is the JAX chunk loop: it stops before
dispatching a chunk that would reach the context end (pos + dispatched + n
>= seq_len) or that the budget does not need; without stop tokens or a
streaming callback it reads the device once, at the end; with them it
dispatches chunk i+1 before it drains chunk i, whose tokens come back
through a pinned buffer and an event.  Rows that a chunk wrote past a stop
token stay in the cache, masked until they are overwritten, and the
history is reset past the stop.  With `speculative_k` > 0 a chunk is
`runtime.speculative.spec_chunk` (n_steps = decode_chunk lookup -> verify
-> accept steps) and the host reads it once.  `decode_step` runs one token
at a host position.  TTFT and tok/s are taken after the device finished
(`torch.cuda.synchronize()`).

With `mesh` (a `parallel.distributed.Mesh`, as `parallel.tp.
make_mesh_engine` builds it) the engine drives a (tp, cp) mesh of ranks
with the same API: each prefill chunk or decode step is one mesh call, and
each decode or speculative chunk one mesh call in which every rank runs
the chunk on its shard and samples (`Mesh.decode_chunk`, `Mesh.
spec_chunk`); the KV cache is sharded over the ranks (kv heads on tp, the
sequence on cp), `params` and `cache` are rank 0's shards, and the
history and sessions stay here.  Under cp a prefill chunk must divide the
shard's S/cp rows, as in the JAX engine.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from lmrs_tpu_torch.config import ModelConfig, resolve_device
from lmrs_tpu_torch.io.params import kvcache_from_numpy
from lmrs_tpu_torch.models.transformer import (CacheDtype, TransformerParams,
                                               cache_dtype_of, forward,
                                               init_kv_cache)
from lmrs_tpu_torch.ops.sampling import sample
from lmrs_tpu_torch.runtime.speculative import spec_chunk


def decode_chunk(run: Callable, token: torch.Tensor, pos: int, n: int,
                 temperature: float, top_p: float,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """`n` decode steps, embed -> forward -> sample, from `token` (a (1,)
    integer device tensor: the token AT position `pos`, known, not cached
    yet): the JAX `_decode_chunk`.  `run(x, p, logit_idx, pos_range)` is
    the forward on one device or a rank (`models.transformer.forward` with
    a device position p, (1,) int32, and its host bounds).  Writes cache
    rows pos..pos+n-1 and returns the (n,) long sampled tokens on the
    device (token i stands at position pos + 1 + i); reads nothing on the
    host.  The caller needs pos + n <= seq_len."""
    dev = token.device
    p = torch.full((1,), pos, dtype=torch.int32, device=dev)
    bounds = (pos, pos + n - 1)
    tok = token.reshape(1).long()
    toks = []
    for _ in range(n):
        logits = run(tok, p, 0, bounds)
        tok = sample(logits, temperature, top_p, generator).reshape(1)
        toks.append(tok)
        p = p + 1
    return torch.cat(toks)


def chunk_seed(seed: int, i: int) -> int:
    """The seed of a mesh chunk's samplers: chunk i of a generation seeded
    `seed` (every rank seeds its generator with it)."""
    return (seed * 1_000_003 + i + 1) % (1 << 62)


@dataclasses.dataclass
class _Pending:
    """A dispatched decode chunk whose tokens the host has not read: its
    (n,) device tokens, the position of its input token and, on the card,
    a pinned copy and the event after it."""

    toks: torch.Tensor
    pos: int
    host: Optional[torch.Tensor] = None
    done: Optional[torch.cuda.Event] = None

    def read(self) -> List[int]:
        if self.done is None:
            return self.toks.tolist()
        self.done.synchronize()
        return self.host.tolist()


@dataclasses.dataclass
class GenerationConfig:
    """Sampling knobs (lm.rs chat CLI defaults)."""

    temperature: float = 0.7
    top_p: float = 0.9
    seed: Optional[int] = None
    max_new_tokens: int = 512
    # prompt-lookup speculative decoding: draft length per verify step
    # (0 = off).  A verify window of k + 1 <= 8 rows runs the T <= 8 matmul
    # kernels a plain decode step runs.
    speculative_k: int = 0


@dataclasses.dataclass
class StepMetrics:
    prefill_tokens: int = 0
    prefill_seconds: float = 0.0
    decode_tokens: int = 0
    decode_seconds: float = 0.0
    ttft_seconds: Optional[float] = None
    spec_proposed: int = 0      # draft tokens verified
    spec_accepted: int = 0      # draft tokens accepted

    @property
    def tokens_per_second(self) -> float:
        return (self.decode_tokens / self.decode_seconds
                if self.decode_seconds else 0.0)

    @property
    def prefill_tokens_per_second(self) -> float:
        return (self.prefill_tokens / self.prefill_seconds
                if self.prefill_seconds else 0.0)


class Engine:
    """Single-stream inference over one model instance.  The KV cache lives
    in the engine (`cache_dtype` torch.bfloat16, torch.float32, torch.int8
    or "int4"); `pos` only grows within a conversation, and `_hist` holds
    the conversation's tokens by position (-1 where unknown) for the
    prompt-lookup drafts.  `w8a8` picks the numerics of Q8_0 layer
    weights at T <= 8: int8 activations and integer dots (the default, as
    the JAX package's LMRS_W8A8=1), or f32 activations.  `mesh`: the
    engine drives a mesh of ranks (module note).  `decode_chunk` is the
    number of decode steps (or of speculative verify steps) a chunk runs,
    the JAX engine's default 8."""

    def __init__(self, cfg: ModelConfig, params: TransformerParams,
                 device=None, cache_dtype: CacheDtype = torch.bfloat16,
                 prefill_chunk: int = 256, decode_chunk: int = 8,
                 w8a8: bool = True, mesh=None):
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk {decode_chunk} must be >= 1")
        self.mesh = mesh
        self.device = mesh.device if mesh is not None \
            else resolve_device(device)
        self.cfg = cfg
        self.params = params
        if params.final_norm.device.type != self.device.type:
            raise ValueError(f"params lie on {params.final_norm.device}, "
                             f"the engine runs on {self.device}")
        # a chunk longer than the context would slice past the rope tables
        self.prefill_chunk = min(prefill_chunk, cfg.seq_len)
        self.decode_chunk = decode_chunk
        cache_dtype = cache_dtype_of(cache_dtype)
        if mesh is None:
            self.cache = init_kv_cache(cfg, self.device, cache_dtype)
        else:
            s_loc = cfg.seq_len // mesh.cp
            if mesh.cp > 1 and (self.prefill_chunk > s_loc
                                or s_loc % self.prefill_chunk):
                # the JAX engine's fixed chunk grid under cp
                raise ValueError(f"cp prefill_chunk {self.prefill_chunk} "
                                 f"must divide the local cache block "
                                 f"{s_loc}")
            self._cid, self.cache = mesh.new_cache(0, cache_dtype, s_loc)
        row = cfg.n_kv_heads * cfg.cache_head_dim
        self._cache_shape = (cfg.n_layers, cfg.seq_len,
                             row // 2 if cache_dtype == "int4" else row)
        self.w8a8 = w8a8
        self.pos = 0
        self._hist = torch.full((cfg.seq_len,), -1, dtype=torch.long,
                                device=self.device)
        self.metrics = StepMetrics()

    def reset(self):
        """New conversation: zero `pos` (cache contents become dead) and
        forget the token history."""
        self.pos = 0
        self._hist.fill_(-1)
        self.metrics = StepMetrics()

    def _note(self, tok: torch.Tensor):
        """Record the token AT `pos` (known, not cached yet) in the
        history."""
        if self.pos < self.cfg.seq_len:
            self._hist[self.pos:self.pos + 1] = tok

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        """Give back a mesh engine's cache shards on every rank (a one-
        device engine's cache goes with the engine)."""
        if self.mesh is not None and self._cid is not None:
            self.mesh.free_cache(self._cid)
            self._cid = None

    def _forward(self, x: torch.Tensor, pos: int, logit_idx):
        """The model over x (token ids or rows) at `pos`: here, or one
        call of the mesh."""
        if self.mesh is not None:
            return self.mesh.forward(self._cid, x, pos, logit_idx, self.w8a8)
        return forward(self.params, self.cfg, self.cache, x, pos, logit_idx,
                       w8a8=self.w8a8)

    def _run(self, x: torch.Tensor, p: torch.Tensor, logit_idx,
             pos_range) -> torch.Tensor:
        """The one-device forward at a device position p with its host
        bounds: the `run` of `decode_chunk` and `spec_chunk`."""
        return forward(self.params, self.cfg, self.cache, x, p, logit_idx,
                       w8a8=self.w8a8, pos_range=pos_range)

    def warmup(self) -> None:
        """Build and load the CUDA kernels before the first conversation
        (eager PyTorch has no programs to precompile, the JAX warm-up's
        work), and restore pos = 0.  On the CPU only the reset."""
        if self.device.type == "cuda":
            from lmrs_tpu_torch.kernels import cuda

            for name in cuda.SOURCES:
                cuda.library(name)
        self.reset()

    @contextlib.contextmanager
    def profile_trace(self, log_dir: str):
        """Context manager: profile what runs inside it with
        torch.profiler (the host, and the card's kernels on CUDA) and write
        a Chrome trace (`<log_dir>/trace_<pid>_<ns>.json`, for Perfetto or
        chrome://tracing) when it exits.  Yields the profiler."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
            self._sync()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))

    # ------------------------------------------------------------------
    def prefill(self, tokens: Sequence[int],
                want_logits: bool = True) -> Optional[torch.Tensor]:
        """Run prompt tokens through the model in chunks of at most
        `prefill_chunk` rows; returns the last token's logits (or None)."""
        n = len(tokens)
        self._check_fits(n)
        tok = torch.as_tensor(list(tokens), dtype=torch.long,
                              device=self.device)
        self._hist[self.pos:self.pos + n] = tok
        return self._prefill_rows(n, lambda off, m: tok[off:off + m],
                                  want_logits)

    def prefill_embeds(self, x: torch.Tensor,
                       want_logits: bool = True) -> Optional[torch.Tensor]:
        """Prefill precomputed (N, D) embeddings (an image's rows,
        `models.phi3v.encode_image_to_embeds`) as `prefill` prefills
        tokens; their history rows hold -1, so that no prompt-lookup draft
        is taken from them."""
        n = x.shape[0]
        self._check_fits(n)
        x = x.to(self.device, torch.float32)
        self._hist[self.pos:self.pos + n] = -1
        return self._prefill_rows(n, lambda off, m: x[off:off + m],
                                  want_logits)

    def _check_fits(self, n: int):
        if n == 0:
            raise ValueError("empty prompt")
        if self.pos + n > self.cfg.seq_len:
            raise ValueError(f"context overflow: pos={self.pos} + prompt {n}"
                             f" > seq_len {self.cfg.seq_len}")

    def _prefill_rows(self, n: int, rows, want_logits: bool
                      ) -> Optional[torch.Tensor]:
        """The chunked prefill of n rows, `rows(off, m)` giving the (m, D)
        embeddings (or the m token ids) of rows off..off+m-1."""
        t0 = time.perf_counter()
        logits = None
        with torch.no_grad():
            for off in range(0, n, self.prefill_chunk):
                m = min(self.prefill_chunk, n - off)
                last = off + m == n
                logits = self._forward(
                    rows(off, m), self.pos,
                    m - 1 if last and want_logits else None)
                self.pos += m
        self._sync()
        self.metrics.prefill_tokens += n
        self.metrics.prefill_seconds += time.perf_counter() - t0
        return logits

    def decode_step(self, token) -> torch.Tensor:
        """One autoregressive step on a token id (an int, or a (1,) integer
        tensor on the engine's device, which keeps the host out of the
        loop); returns logits (V,)."""
        if not isinstance(token, torch.Tensor):
            token = torch.tensor([token], dtype=torch.long, device=self.device)
        self._note(token)
        with torch.no_grad():
            logits = self._forward(token, self.pos, 0)
        self.pos += 1
        return logits

    # ------------------------------------------------------------------
    def generate(self, prompt_tokens: Sequence[int],
                 gen: GenerationConfig = GenerationConfig(),
                 stop_tokens: Iterable[int] = (),
                 on_token: Optional[Callable[[int], None]] = None
                 ) -> List[int]:
        """Prefill, then sample up to `gen.max_new_tokens` tokens; a stop
        token ends generation and is included in the result.  The tokens
        after the first come from decode chunks, or with
        `gen.speculative_k` > 0 from speculative chunks; generation ends
        where a whole chunk no longer fits the context (module note)."""
        stop = set(int(t) for t in stop_tokens)
        seed = gen.seed if gen.seed is not None else time.time_ns() % (1 << 31)
        rng = torch.Generator(device=self.device)
        rng.manual_seed(seed)

        t_start = time.perf_counter()
        logits = self.prefill(prompt_tokens)
        # the sampled token stays on the device: the first chunk embeds it
        # there, and the host reads it only when it must
        streaming = bool(stop) or on_token is not None
        with torch.no_grad():
            tok = sample(logits, gen.temperature, gen.top_p, rng).reshape(1)
        self._note(tok)
        out: List[int] = []
        stopped = False
        if streaming or gen.speculative_k > 0:
            stopped = self._drain([int(tok.item())], self.pos, gen, stop,
                                  out, on_token, advance=False)
        self._sync()
        self.metrics.ttft_seconds = time.perf_counter() - t_start
        t_decode0 = time.perf_counter()
        if gen.speculative_k > 0:
            self._generate_speculative(gen, rng, seed, stopped, stop, out,
                                       on_token)
        else:
            self._generate_chunks(gen, rng, seed, tok, stopped, stop, out,
                                  on_token, streaming)
        self._sync()
        self.metrics.decode_tokens += len(out) - 1
        self.metrics.decode_seconds += time.perf_counter() - t_decode0
        return out

    def _decode_chunk(self, tok: torch.Tensor, pos: int, n: int,
                      gen: GenerationConfig, rng: torch.Generator,
                      seed: int) -> torch.Tensor:
        """One decode chunk from the device token `tok` at `pos`, here or
        as one mesh call (whose ranks sample from generators seeded
        `seed`); writes the chunk's tokens into the history on the device
        and returns them, (n,) on the device."""
        with torch.no_grad():
            if self.mesh is not None:
                toks = self.mesh.decode_chunk(
                    self._cid, tok, pos, n, gen.temperature, gen.top_p, seed,
                    self.w8a8)
            else:
                toks = decode_chunk(self._run, tok, pos, n, gen.temperature,
                                    gen.top_p, rng)
            self._hist[pos + 1:pos + 1 + n] = toks
        return toks

    def _pending(self, toks: torch.Tensor, pos: int,
                 streaming: bool) -> _Pending:
        """A dispatched chunk; a streamed one on the card starts its copy
        to pinned host memory at once and records an event after it, so
        that draining it waits for this chunk only, not for the chunk
        dispatched after it."""
        if not streaming or self.device.type != "cuda":
            return _Pending(toks, pos)
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return _Pending(toks, pos, host, done)

    def _drain(self, toks: List[int], pos_before: int,
               gen: GenerationConfig, stop, out: List[int], on_token,
               advance: bool = True) -> bool:
        """Take a chunk's tokens that the host has read (the JAX
        `_drain_chunk`): append those the budget allows, up to and
        including a stop token, call `on_token` on each, and move `pos` to
        pos_before + the tokens taken (`advance`).  True when generation
        must stop (a stop token, or the budget spent)."""
        used = min(len(toks), gen.max_new_tokens - len(out))
        hit_stop = False
        for i, t in enumerate(toks[:used]):
            if t in stop:
                used, hit_stop = i + 1, True
                break
        if advance:
            self.pos = pos_before + used
        for t in toks[:used]:
            out.append(t)
            if on_token is not None:
                on_token(t)
        return hit_stop or len(out) >= gen.max_new_tokens

    def _forget_past(self, last_written: int) -> None:
        """Reset the history rows that chunks wrote past `pos` (the
        overshoot of a stop, a budget or a rejected draft) to unknown:
        the history holds the conversation's tokens only, as the JAX
        engine's host history does."""
        if last_written > self.pos:
            self._hist[self.pos + 1:last_written + 1] = -1

    def _generate_chunks(self, gen: GenerationConfig, rng: torch.Generator,
                         seed: int, tok: torch.Tensor, stopped: bool, stop,
                         out: List[int], on_token, streaming: bool) -> None:
        """The decode loop of the JAX engine's `generate`: chunks of
        `decode_chunk` steps, each from the last token of the one before
        (a device tensor).  A chunk is dispatched while it fits the context
        whole (pos + dispatched + n < seq_len) and the budget still needs a
        token, `dispatched` counting the tokens of chunks not drained yet.
        Streaming, chunk i is drained after chunk i+1 is dispatched, and a
        stop in chunk i discards chunk i+1 (its cache rows lie past `pos`,
        masked); otherwise every chunk is read in one transfer at the
        end."""
        n = self.decode_chunk
        first = tok
        pending: List[_Pending] = []
        last_written = self.pos
        i = 0
        while not stopped:
            dispatched = n * len(pending)
            if self.pos + dispatched + n >= self.cfg.seq_len:
                break
            taken = len(out) if streaming else 1
            if gen.max_new_tokens - taken - dispatched <= 0:
                break
            pos_before = self.pos + dispatched
            toks = self._decode_chunk(tok, pos_before, n, gen, rng,
                                      chunk_seed(seed, i))
            i += 1
            tok = toks[-1:]
            last_written = pos_before + n
            pending.append(self._pending(toks, pos_before, streaming))
            if streaming and len(pending) == 2:
                c = pending.pop(0)
                stopped = self._drain(c.read(), c.pos, gen, stop, out,
                                      on_token)
        if streaming:
            if pending and not stopped:
                c = pending.pop()
                self._drain(c.read(), c.pos, gen, stop, out, on_token)
        else:
            vals = torch.cat([first] + [c.toks for c in pending]).tolist()
            self._drain(vals[:1], self.pos, gen, stop, out, on_token,
                        advance=False)
            for j, c in enumerate(pending):
                if self._drain(vals[1 + j * n:1 + (j + 1) * n], c.pos, gen,
                               stop, out, on_token):
                    break
        self._forget_past(last_written)

    def _spec_chunk(self, pos: int, n_steps: int, k: int,
                    gen: GenerationConfig, rng: torch.Generator, seed: int):
        """One speculative chunk at `pos` (the history holds the token at
        pos), here or as one mesh call that carries the history; returns
        (out_buf, n_out, accs) on the device."""
        with torch.no_grad():
            if self.mesh is not None:
                out_buf, n_out, accs, _, h = self.mesh.spec_chunk(
                    self._cid, self._hist, pos, n_steps, k, gen.temperature,
                    gen.top_p, seed, self.w8a8)
                if h is not self._hist:
                    self._hist.copy_(h)
            else:
                out_buf, n_out, accs, _ = spec_chunk(
                    self._run, self.cfg, self._hist, pos, n_steps, k,
                    gen.temperature, gen.top_p, rng)
        return out_buf, n_out, accs

    def _generate_speculative(self, gen: GenerationConfig,
                              rng: torch.Generator, seed: int, stopped: bool,
                              stop, out: List[int], on_token) -> None:
        """The prompt-lookup speculative loop of the JAX engine
        (`runtime.speculative`): greedy-exact at temperature 0, rejection
        sampling otherwise.  The first sampled token is in `out` and
        stands in the history at index `pos`.  Each chunk runs n_steps =
        decode_chunk lookup -> verify (T = k+1) -> accept steps on the
        device and yields a variable number of tokens, which the host reads
        once per chunk with the chunk's accepted counts.  A chunk is
        dispatched only while its worst case, n_steps * (k+1) rows and the
        history row after them, fits the context: pos + n_steps * (k+1) +
        1 < seq_len.  A stop token, or the budget, truncates `pos` and the
        history inside a chunk."""
        k = gen.speculative_k
        n_steps = self.decode_chunk
        last_written = self.pos
        i = 0
        while not stopped and len(out) < gen.max_new_tokens:
            if self.pos + n_steps * (k + 1) + 1 >= self.cfg.seq_len:
                break
            pos_before = self.pos
            out_buf, n_out, accs = self._spec_chunk(
                pos_before, n_steps, k, gen, rng, chunk_seed(seed, i))
            i += 1
            last_written = max(last_written, pos_before + n_steps * (k + 1))
            # the chunk's one host read
            n_o, *vals = torch.cat([n_out.reshape(1), accs,
                                    out_buf]).tolist()
            self.metrics.spec_proposed += n_steps * k
            self.metrics.spec_accepted += sum(vals[:n_steps])
            stopped = self._drain(vals[n_steps:n_steps + n_o], pos_before,
                                  gen, stop, out, on_token)
        self._forget_past(last_written)

    # ------------------------------------------------------------------
    # Session persistence: a conversation (cache, position, history) can
    # be written to an .npz file and resumed in another process.  The keys
    # and the signature are the JAX package's, so an int8 or int4 session
    # of either package loads in the other.
    def save_session(self, path: str) -> None:
        """Write the conversation to `path` (numpy appends .npz).  A bf16
        cache is stored as its int16 bit pattern: numpy has no bfloat16.
        A mesh engine gathers the shards' live rows [0, pos) into the
        global layout (the rows past pos are written as zeros), so that
        the file loads on any mesh or one device."""
        def host(a: torch.Tensor) -> np.ndarray:
            if a.dtype == torch.bfloat16:
                a = a.view(torch.int16)
            return a.cpu().numpy()

        planes = dict(k=self.cache.k, v=self.cache.v)
        if self.cache.k_scale is not None:
            planes.update(k_scale=self.cache.k_scale,
                          v_scale=self.cache.v_scale)
        if self.mesh is None:
            arrays = {name: host(a) for name, a in planes.items()}
        else:
            arrays = {}
            for name, a in self.mesh.gather_cache(self._cid,
                                                  self.pos).items():
                live = host(a)
                full = np.zeros(
                    self._cache_shape if name in ("k", "v") else
                    (self.cfg.n_layers, self.cfg.n_kv_heads,
                     self.cfg.seq_len), live.dtype)
                full[(slice(None),) * (1 if name in ("k", "v") else 2)
                     + (slice(0, self.pos),)] = live
                arrays[name] = full
        np.savez(path, pos=self.pos, hist=host(self._hist).astype(np.int32),
                 sig=np.asarray(self._session_sig(), np.int64), **arrays)

    def load_session(self, path: str) -> None:
        """Resume the conversation of `path`.  Refuses a file of another
        model config, of another cache shape, and a float cache's file on
        a quantized engine or the reverse."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as f:
            data = {key: f[key] for key in f.files}
        if list(data["sig"]) != list(self._session_sig()):
            raise ValueError("session file does not match this model config")
        if data["k"].shape != self._cache_shape:
            raise ValueError(
                f"session cache shape {data['k'].shape} does not match this "
                f"engine's {self._cache_shape} (cache dtype mismatch?)")
        quantized = self.cache.k_scale is not None
        if "k_scale" in data and not quantized:
            raise ValueError("session was saved from an int8 KV cache; "
                             "this engine uses a float cache")
        if "k_scale" not in data and quantized:
            raise ValueError("session was saved from a float KV cache; "
                             "this engine uses an int8 cache")
        loaded = kvcache_from_numpy(data, self.cache.k.dtype, self.device)
        self.pos = int(data["pos"])
        if self.mesh is None:
            self.cache = loaded
        else:
            n = self.pos
            self.mesh.scatter_cache(self._cid, [
                a[:, :n] if i < 2 else a[:, :, :n]
                for i, a in enumerate((loaded.k, loaded.v, loaded.k_scale,
                                       loaded.v_scale)) if a is not None])
        # restore (or invalidate) the token history: the prompt lookup
        # drafts from it, and another conversation's tokens below the
        # loaded pos would make every draft a wrong one
        self._hist.fill_(-1)
        if "hist" in data:
            h = torch.from_numpy(data["hist"].astype(np.int64))
            n = min(h.shape[0], self._hist.shape[0])
            self._hist[:n] = h[:n].to(self.device)

    def _session_sig(self):
        c = self.cfg
        return (c.n_layers, c.seq_len, c.n_kv_heads, c.head_dim,
                int(c.model_type), int(c.quant))
