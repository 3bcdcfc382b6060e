"""Inference engine: chunked prefill, the decode loop, speculative
decoding, sampling, sessions, metrics.

PyTorch runs eagerly, so the engine has no compiled programs and no static
shapes: a prompt prefills in chunks of at most `prefill_chunk` real rows,
and decoding runs one `forward` per token in a Python loop.  The sampled
token stays on the device and feeds the next step's embedding gather; the
host reads tokens only when it must (stop tokens or a streaming callback),
else once at the end.  With `speculative_k` > 0 a step is one lookup ->
verify -> accept pass (`runtime.speculative.verify_step`) and the host
reads the accepted count once per step.  TTFT and tok/s are taken after the
device finished (`torch.cuda.synchronize()`).

With `mesh` (a `parallel.distributed.Mesh`, as `parallel.tp.
make_mesh_engine` builds it) the engine drives a (tp, cp) mesh of ranks
with the same API: each forward is one mesh call (token ids or embedding
rows, the position), the KV cache is sharded over the ranks (kv heads on
tp, the sequence on cp), `params` and `cache` are rank 0's shards, and
sampling, the history and sessions stay here.  Under cp a prefill chunk
must divide the shard's S/cp rows, as in the JAX engine.
"""

from __future__ import annotations

import dataclasses
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
from lmrs_tpu_torch.runtime.speculative import verify_step


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
    engine drives a mesh of ranks (module note)."""

    def __init__(self, cfg: ModelConfig, params: TransformerParams,
                 device=None, cache_dtype: CacheDtype = torch.bfloat16,
                 prefill_chunk: int = 256, w8a8: bool = True, mesh=None):
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
        token ends generation and is included in the result.  With
        `gen.speculative_k` > 0 the tokens after the first come from
        verify steps, and generation ends where a verify window no longer
        fits the context."""
        stop = set(int(t) for t in stop_tokens)
        seed = gen.seed if gen.seed is not None else time.time_ns() % (1 << 31)
        rng = torch.Generator(device=self.device)
        rng.manual_seed(seed)

        t_start = time.perf_counter()
        logits = self.prefill(prompt_tokens)
        # every sampled token stays on the device: the next step gathers its
        # embedding there, and the host reads it only when it must
        streaming = bool(stop) or on_token is not None
        with torch.no_grad():
            tok = sample(logits, gen.temperature, gen.top_p, rng).reshape(1)
        out: List[int] = []
        pending: List[torch.Tensor] = []

        def emit(t) -> bool:
            """Record one token (a device tensor, or an int the host has
            read already); True when generation must stop.  Without
            streaming `t` may hold several tokens."""
            if not streaming:
                pending.append(t)
                return False
            v = t if isinstance(t, int) else int(t.item())
            out.append(v)
            if on_token is not None:
                on_token(v)
            return v in stop

        stopped = emit(tok)
        self._note(tok)
        self._sync()
        self.metrics.ttft_seconds = time.perf_counter() - t_start
        t_decode0 = time.perf_counter()
        n_emitted = 1
        if gen.speculative_k > 0:
            n_emitted += self._generate_speculative(
                gen, rng, stopped, emit, streaming)
            stopped = True
        while (not stopped and n_emitted < gen.max_new_tokens
               and self.pos < self.cfg.seq_len):
            logits = self.decode_step(tok)
            with torch.no_grad():
                tok = sample(logits, gen.temperature, gen.top_p,
                             rng).reshape(1)
            stopped = emit(tok)
            n_emitted += 1
        if gen.speculative_k <= 0:
            self._note(tok)     # the last token is known, not cached
        if pending:
            out.extend(int(v) for v in torch.cat(pending).tolist())
        self._sync()
        self.metrics.decode_tokens += n_emitted - 1
        self.metrics.decode_seconds += time.perf_counter() - t_decode0
        return out

    def _generate_speculative(self, gen: GenerationConfig,
                              rng: torch.Generator, stopped: bool, emit,
                              streaming: bool) -> int:
        """The prompt-lookup speculative loop (`runtime.speculative`):
        greedy-exact at temperature 0, rejection sampling otherwise.  The
        first sampled token is emitted already and stands in the history
        at index `pos`.  Each step verifies k drafts in one T = k+1
        forward and yields 1..k+1 tokens; the host reads the accepted
        count (with the tokens, when streaming) once per step.  Rows
        written past the accepted prefix are garbage that the causal mask
        hides until they are overwritten.  The loop ends while the next
        verify window, history write included, still fits: pos + k + 2 <
        seq_len.  A stop token inside an accepted run truncates `pos` and
        the history at that token.  Returns the number of tokens
        emitted."""
        k = gen.speculative_k
        n_new = 0
        budget = gen.max_new_tokens - 1
        while (not stopped and n_new < budget
               and self.pos + k + 2 < self.cfg.seq_len):
            with torch.no_grad():
                n_acc_dev, emitted = verify_step(
                    self._forward, self.cfg, self._hist, self.pos, k,
                    gen.temperature, gen.top_p, rng)
                # all k + 1 may be written: the history past the new `pos`
                # is never read (the lookup masks idx < pos - 1)
                self._hist[self.pos + 1:self.pos + k + 2] = emitted
            if streaming:
                n_acc, *toks = torch.cat([n_acc_dev.reshape(1),
                                          emitted]).tolist()
            else:
                n_acc = int(n_acc_dev.item())
            self.metrics.spec_proposed += k
            self.metrics.spec_accepted += n_acc
            used = min(n_acc + 1, budget - n_new)
            if streaming:
                for i in range(used):
                    if emit(toks[i]):
                        used, stopped = i + 1, True
                        break
            else:
                emit(emitted[:used])
            self.pos += used
            n_new += used
        return n_new

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
