"""WebSocket serving backend, text only (counterpart of
`lmrs_tpu/serve/backend.py`, which speaks lm.rs's backend protocol).

  client -> server: {"text": "..."}   (an "image" field is ignored)
  server -> client: {"category": "STATUS" | "OUTPUT", "text": "..."}
    STATUS  "Server at capacity — try again later" (batch mode, no slot)
    STATUS  "Context window full — start a new session"
    OUTPUT  token pieces, streamed during generation
    OUTPUT  "<eos>" at the end of each generation

One connection is one conversation.  Without --batch each connection gets
its own `Engine` (KV cache and position) over the shared weights, and
generations take turns through an asyncio lock.  With --batch N the
connections share one `BatchScheduler` on a `SchedulerThread`: each
conversation leases a slot and the turns of all connections decode
together.  --batch pages the KV cache by default (`auto_pool_tokens`
rows); --no-paged keeps the contiguous per-slot cache.

`BackendServer.handle` takes any connection object with an async `send()`
and async iteration over incoming messages, so the protocol runs without
a network; only `serve()` imports the `websockets` package.

Usage:
    python -m lmrs_tpu_torch.serve.backend --model m.lmrs --tokenizer
        tokenizer.bin [--ip 127.0.0.1] [--port 5000] [--batch N]
        [--cache-dtype int8] [--spec-k K] [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import datetime
import json
import os
from typing import List, Optional

from lmrs_tpu_torch.cli.chat import LLAMA_SYSTEM_PREFIX, LLAMA_SYSTEM_SUFFIX
from lmrs_tpu_torch.config import ModelType, resolve_device, unsupported

# prompt rows per prefill chunk, single-stream and batched: one chunk per
# scheduler tick, so a 1,024-token prompt is admitted in four ticks
PREFILL_CHUNK = 256
CAPACITY = "Server at capacity — try again later"
CONTEXT_FULL = "Context window full — start a new session"


def _response(category: str, text: str) -> str:
    return json.dumps({"category": category, "text": text})


class BackendServer:
    def __init__(self, model_path: str, tokenizer_path: str,
                 temperature: float = 0.7, top_p: float = 0.9,
                 seed: Optional[int] = None, multimodal: bool = False,
                 cache_dtype: str = "bfloat16",
                 max_new_tokens: Optional[int] = None, batch: int = 0,
                 max_ctx: Optional[int] = None, tp: int = 1, cp: int = 1,
                 spec_k: int = 0, pool_tokens: Optional[int] = None,
                 page_size: int = 512, dp: int = 1, no_paged: bool = False,
                 device=None):
        if multimodal:
            raise unsupported("--multimodal", "A13 multimodal")
        if tp > 1 or cp > 1 or dp > 1:
            raise unsupported("--tp / --cp / --dp",
                              "A15 torch.distributed tp/cp")
        if pool_tokens is not None and batch == 0:
            raise ValueError("--pool-tokens (paged KV cache) requires "
                             "--batch")
        from lmrs_tpu_torch.io.lmrs import read_lmrs
        from lmrs_tpu_torch.io.params import params_from_lmrs
        from lmrs_tpu_torch.models.transformer import cache_dtype_of
        from lmrs_tpu_torch.tokenizer import Tokenizer

        self.device = resolve_device(device)
        self.tokenizer = Tokenizer.from_file(tokenizer_path)
        self.file = read_lmrs(model_path)
        self.cfg = self.file.cfg
        self.params = params_from_lmrs(self.file, device=self.device)
        self.cache_dtype = cache_dtype_of(cache_dtype)
        self.temperature = temperature
        self.top_p = top_p
        self.seed = seed
        self.spec_k = spec_k
        # Q8_0 layer numerics: the JAX package's switch, as the chat CLI
        # reads it (LMRS_W8A8=0 sends the layers through W8A16)
        self.w8a8 = os.environ.get("LMRS_W8A8", "1") == "1"
        self.max_new_tokens = max_new_tokens or self.cfg.seq_len
        # one generation at a time in engine mode
        self.gpu_lock = asyncio.Lock()
        self.scheduler = None
        if batch > 0:
            from lmrs_tpu_torch.serve.scheduler import (BatchScheduler,
                                                        SchedulerThread,
                                                        auto_pool_tokens,
                                                        paged_supported)

            # paged by default where the pool can serve the config
            if (pool_tokens is None and not no_paged
                    and paged_supported(self.cfg, self.cache_dtype)):
                pool_tokens = auto_pool_tokens(
                    batch, min(max_ctx or self.cfg.seq_len,
                               self.cfg.seq_len), page_size)
            sched = BatchScheduler(
                self.cfg, self.params, max_batch=batch, max_ctx=max_ctx,
                cache_dtype=self.cache_dtype, temperature=temperature,
                top_p=top_p, seed=seed if seed is not None else 0,
                speculative_k=spec_k, pool_tokens=pool_tokens,
                page_size=page_size, device=self.device,
                prefill_chunk=min(PREFILL_CHUNK, page_size), w8a8=self.w8a8)
            self.scheduler = SchedulerThread(sched)

    def warmup(self):
        """Build and load the CUDA kernels before taking traffic: the only
        preparation eager PyTorch needs.  A no-op on the CPU."""
        if self.device.type == "cuda":
            from lmrs_tpu_torch.kernels import cuda

            for name in cuda.SOURCES:
                cuda.library(name)

    def shutdown(self):
        if self.scheduler is not None:
            self.scheduler.shutdown()

    def _prompt(self, text: str, first_turn: bool) -> List[int]:
        tokens: List[int] = []
        if self.cfg.model_type == ModelType.LLAMA and first_turn:
            tokens.extend(LLAMA_SYSTEM_PREFIX)
            today = datetime.date.today().strftime("%d %b %Y")
            tokens.extend(self.tokenizer.encode(today))
            tokens.extend(LLAMA_SYSTEM_SUFFIX)
        tokens.extend(self.tokenizer.encode(
            text.strip(), chat_format=True, model_type=self.cfg.model_type))
        return tokens

    def _stop_tokens(self):
        from lmrs_tpu_torch.tokenizer import EXTRA_STOP_TOKENS

        return {self.tokenizer.eos,
                *EXTRA_STOP_TOKENS.get(self.cfg.model_type, ())}

    @staticmethod
    def _text(raw):
        """The message's text, or None for a frame to skip (malformed JSON,
        a binary frame, no "text"), as lm.rs skips them.  An "image" field
        is dropped: the server is text-only (`multimodal=True` raises, A13),
        and the JAX backend reads the image only when it is multimodal."""
        try:
            msg = json.loads(raw)
            text = msg["text"]
        except (ValueError, KeyError, TypeError) as e:
            print(f"Error parsing message: {e}")
            return None
        return text

    async def _stream(self, ws, queue: asyncio.Queue, finished) -> None:
        """Send pieces from `queue` until the awaitable `finished` is done,
        then whatever is left."""
        while True:
            get = asyncio.ensure_future(queue.get())
            done, _ = await asyncio.wait(
                {get, finished}, return_when=asyncio.FIRST_COMPLETED)
            if get in done:
                await ws.send(_response("OUTPUT", get.result()))
            else:
                get.cancel()
                break
        while not queue.empty():
            await ws.send(_response("OUTPUT", queue.get_nowait()))

    # ------------------------------------------------------------------
    async def handle(self, ws):
        """One connection = one conversation."""
        from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
        from lmrs_tpu_torch.tokenizer import StreamDecoder

        if self.scheduler is not None:
            return await self.handle_batched(ws)
        engine = Engine(self.cfg, self.params, device=self.device,
                        cache_dtype=self.cache_dtype,
                        prefill_chunk=PREFILL_CHUNK, w8a8=self.w8a8)
        gen = GenerationConfig(temperature=self.temperature,
                               top_p=self.top_p, seed=self.seed,
                               max_new_tokens=self.max_new_tokens,
                               speculative_k=self.spec_k)
        stop_tokens = self._stop_tokens()
        async for raw in ws:
            text = self._text(raw)
            if text is None:
                continue
            prompt_tokens = self._prompt(text, engine.pos == 0)
            decoder = StreamDecoder(self.tokenizer)
            loop = asyncio.get_running_loop()
            queue: asyncio.Queue = asyncio.Queue()

            def on_token(tok: int):
                if tok not in stop_tokens:
                    piece = decoder.push(tok)
                    if piece:
                        loop.call_soon_threadsafe(queue.put_nowait, piece)

            if engine.pos + len(prompt_tokens) + 1 >= self.cfg.seq_len:
                await ws.send(_response("STATUS", CONTEXT_FULL))
                await ws.send(_response("OUTPUT", "<eos>"))
                continue
            async with self.gpu_lock:
                gen_task = loop.run_in_executor(
                    None, lambda: engine.generate(
                        prompt_tokens, gen, stop_tokens=stop_tokens,
                        on_token=on_token))
                await self._stream(ws, queue, gen_task)
                await gen_task
            tail = decoder.flush()
            if tail:
                await ws.send(_response("OUTPUT", tail))
            await ws.send(_response("OUTPUT", "<eos>"))

    async def handle_batched(self, ws):
        """Continuous-batching connection handler: the conversation leases
        one scheduler slot, and its turns decode together with the other
        connections'."""
        from lmrs_tpu_torch.tokenizer import StreamDecoder

        thread = self.scheduler
        sched = thread.sched
        lease = thread.call(sched.new_conversation)
        if lease is None:
            await ws.send(_response("STATUS", CAPACITY))
            return
        stop_tokens = self._stop_tokens()
        first_turn = True
        try:
            async for raw in ws:
                text = self._text(raw)
                if text is None:
                    continue
                prompt_tokens = self._prompt(text, first_turn)
                first_turn = False
                pos = sched.slots[lease.slot_idx].pos
                if pos + len(prompt_tokens) + 1 >= sched.S:
                    await ws.send(_response("STATUS", CONTEXT_FULL))
                    await ws.send(_response("OUTPUT", "<eos>"))
                    continue
                decoder = StreamDecoder(self.tokenizer)
                loop = asyncio.get_running_loop()
                queue: asyncio.Queue = asyncio.Queue()
                done_ev = asyncio.Event()

                def on_token(tok: int):
                    if tok not in stop_tokens:
                        piece = decoder.push(tok)
                        if piece:
                            loop.call_soon_threadsafe(queue.put_nowait,
                                                      piece)

                def on_done(out):
                    loop.call_soon_threadsafe(done_ev.set)

                thread.submit(prompt_tokens,
                              max_new_tokens=self.max_new_tokens,
                              stop_tokens=stop_tokens, on_token=on_token,
                              on_done=on_done, lease=lease)
                await self._stream(ws, queue,
                                   asyncio.ensure_future(done_ev.wait()))
                tail = decoder.flush()
                if tail:
                    await ws.send(_response("OUTPUT", tail))
                await ws.send(_response("OUTPUT", "<eos>"))
        finally:
            thread.call(lambda: sched.end_conversation(lease))

    async def serve(self, ip: str, port: int):
        import websockets

        async with websockets.serve(self.handle, ip, port,
                                    max_size=64 * 1024 * 1024):
            print(f"Listening on: {ip}:{port}")
            await asyncio.Future()


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lmrs_tpu_torch WebSocket "
                                            "backend")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--model", required=True)
    p.add_argument("--tokenizer", default="tokenizer.bin")
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top-p", dest="top_p", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--multimodal", action="store_true",
                   help="not ported yet (ROADMAP.md A13)")
    p.add_argument("--batch", type=int, default=0,
                   help="continuous-batching slots (0: one engine per "
                        "connection)")
    p.add_argument("--max-ctx", dest="max_ctx", type=int, default=None,
                   help="per-slot context length in batch mode")
    p.add_argument("--cache-dtype", dest="cache_dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "int8", "int4"])
    p.add_argument("--spec-k", dest="spec_k", type=int, default=0,
                   help="prompt-lookup speculative decoding, k drafts per "
                        "verify step")
    p.add_argument("--pool-tokens", dest="pool_tokens", type=int,
                   default=None,
                   help="batch mode: rows of the paged KV pool (default "
                        "0.75 x batch x max-ctx)")
    p.add_argument("--no-paged", dest="no_paged", action="store_true",
                   help="batch mode: the contiguous per-slot KV cache "
                        "instead of the paged pool")
    p.add_argument("--page-size", dest="page_size", type=int, default=512,
                   help="rows per page of the paged KV pool")
    p.add_argument("--tp", type=int, default=1,
                   help="not ported yet (ROADMAP.md A15)")
    p.add_argument("--cp", type=int, default=1,
                   help="not ported yet (ROADMAP.md A15)")
    p.add_argument("--dp", type=int, default=1,
                   help="not ported yet (ROADMAP.md A15)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    server = BackendServer(args.model, args.tokenizer, args.temperature,
                           args.top_p, args.seed, args.multimodal,
                           cache_dtype=args.cache_dtype, batch=args.batch,
                           max_ctx=args.max_ctx, tp=args.tp, cp=args.cp,
                           spec_k=args.spec_k, pool_tokens=args.pool_tokens,
                           page_size=args.page_size, dp=args.dp,
                           no_paged=args.no_paged, device=args.device)
    server.warmup()
    try:
        asyncio.run(server.serve(args.ip, args.port))
    except KeyboardInterrupt:
        print("\nShutting down.")
    finally:
        server.shutdown()


if __name__ == "__main__":
    main()
