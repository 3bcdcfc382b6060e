"""Inference engine: chunked prefill, the decode loop, sampling, metrics.

PyTorch runs eagerly, so the engine has no compiled programs and no static
shapes: a prompt prefills in chunks of at most `prefill_chunk` real rows,
and decoding runs one `forward` per token in a Python loop.  The sampled
token stays on the device and feeds the next step's embedding gather; the
host reads tokens only when it must (stop tokens or a streaming callback),
else once at the end.  TTFT and tok/s are taken after the device finished
(`torch.cuda.synchronize()`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, List, Optional, Sequence

import torch

from lmrs_tpu_torch.config import ModelConfig, resolve_device, unsupported
from lmrs_tpu_torch.models.transformer import (TransformerParams,
                                               embed_tokens, forward,
                                               init_kv_cache)
from lmrs_tpu_torch.ops.sampling import sample


@dataclasses.dataclass
class GenerationConfig:
    """Sampling knobs (lm.rs chat CLI defaults)."""

    temperature: float = 0.7
    top_p: float = 0.9
    seed: Optional[int] = None
    max_new_tokens: int = 512
    # prompt-lookup speculative decoding: not ported yet, must stay 0
    speculative_k: int = 0


@dataclasses.dataclass
class StepMetrics:
    prefill_tokens: int = 0
    prefill_seconds: float = 0.0
    decode_tokens: int = 0
    decode_seconds: float = 0.0
    ttft_seconds: Optional[float] = None

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
    in the engine (`cache_dtype` torch.bfloat16 or torch.int8); `pos` only
    grows within a conversation.  `w8a8` picks the numerics of Q8_0 layer
    weights at T <= 8: int8 activations and integer dots (the default, as
    the JAX package's LMRS_W8A8=1), or f32 activations."""

    def __init__(self, cfg: ModelConfig, params: TransformerParams,
                 device=None, cache_dtype=torch.bfloat16,
                 prefill_chunk: int = 256, w8a8: bool = True):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        if params.final_norm.device.type != self.device.type:
            raise ValueError(f"params lie on {params.final_norm.device}, "
                             f"the engine runs on {self.device}")
        # a chunk longer than the context would slice past the rope tables
        self.prefill_chunk = min(prefill_chunk, cfg.seq_len)
        self.cache = init_kv_cache(cfg, self.device, cache_dtype)
        self.w8a8 = w8a8
        self.pos = 0
        self.metrics = StepMetrics()

    def reset(self):
        """New conversation: zero `pos` (cache contents become dead)."""
        self.pos = 0
        self.metrics = StepMetrics()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def prefill(self, tokens: Sequence[int],
                want_logits: bool = True) -> Optional[torch.Tensor]:
        """Run prompt tokens through the model in chunks of at most
        `prefill_chunk` rows; returns the last token's logits (or None)."""
        t0 = time.perf_counter()
        n = len(tokens)
        if n == 0:
            raise ValueError("empty prompt")
        if self.pos + n > self.cfg.seq_len:
            raise ValueError(f"context overflow: pos={self.pos} + prompt {n}"
                             f" > seq_len {self.cfg.seq_len}")
        tok = torch.as_tensor(list(tokens), dtype=torch.long,
                              device=self.device)
        logits = None
        with torch.no_grad():
            for off in range(0, n, self.prefill_chunk):
                chunk = tok[off:off + self.prefill_chunk]
                last = off + chunk.shape[0] == n
                x = embed_tokens(self.params, self.cfg, chunk)
                logits = forward(self.params, self.cfg, self.cache, x,
                                 self.pos,
                                 chunk.shape[0] - 1 if last and want_logits
                                 else None, w8a8=self.w8a8)
                self.pos += chunk.shape[0]
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
        with torch.no_grad():
            x = embed_tokens(self.params, self.cfg, token)
            logits = forward(self.params, self.cfg, self.cache, x, self.pos,
                             0, w8a8=self.w8a8)
        self.pos += 1
        return logits

    # ------------------------------------------------------------------
    def generate(self, prompt_tokens: Sequence[int],
                 gen: GenerationConfig = GenerationConfig(),
                 stop_tokens: Iterable[int] = (),
                 on_token: Optional[Callable[[int], None]] = None
                 ) -> List[int]:
        """Prefill, then sample up to `gen.max_new_tokens` tokens; a stop
        token ends generation and is included in the result."""
        if gen.speculative_k > 0:
            raise unsupported("speculative decoding", "A9 speculative "
                              "decoding")
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

        def emit(t: torch.Tensor) -> bool:
            """Record one token; True when generation must stop."""
            if not streaming:
                pending.append(t)
                return False
            v = int(t.item())
            out.append(v)
            if on_token is not None:
                on_token(v)
            return v in stop

        stopped = emit(tok)
        self._sync()
        self.metrics.ttft_seconds = time.perf_counter() - t_start
        t_decode0 = time.perf_counter()
        n_emitted = 1
        while (not stopped and n_emitted < gen.max_new_tokens
               and self.pos < self.cfg.seq_len):
            logits = self.decode_step(tok)
            with torch.no_grad():
                tok = sample(logits, gen.temperature, gen.top_p,
                             rng).reshape(1)
            stopped = emit(tok)
            n_emitted += 1
        if pending:
            out.extend(int(v) for v in torch.cat(pending).tolist())
        self._sync()
        self.metrics.decode_tokens += n_emitted - 1
        self.metrics.decode_seconds += time.perf_counter() - t_decode0
        return out
