"""WebSocket serving backend (counterpart of `lmrs_tpu/serve/backend.py`,
which speaks lm.rs's backend protocol).

  client -> server: {"text": "...", "image": "<base64>"?}
  server -> client: {"category": "STATUS" | "OUTPUT" | "FEATURE",
                     "text": "..."}
    FEATURE "multimodal" at connect, when the server runs --multimodal
    STATUS  "Preprocessing the image", "Encoding the image", "Filling KV
            cache" while an image is taken in
    STATUS  "Could not read the image" (its base64 or image bytes are bad)
    STATUS  "Server at capacity — try again later" (batch mode: no slot,
            or no pages of the KV pool for an image's rows)
    STATUS  "Context window full — start a new session"
    OUTPUT  token pieces, streamed during generation
    OUTPUT  "<eos>" at the end of each generation

A --multimodal server (Phi-3.5-vision) decodes an "image" field with PIL,
encodes it (`models.phi3v.encode_image_to_embeds`, --num-crops crops at
most) and prefills its rows into the conversation's cache before the
message's text, which then ends with PHI_TURN_SUFFIX instead of the chat
template.  lm.rs's backend counts the image's rows twice in its position
(it adds the new absolute position to the old one); the engine and the
scheduler keep the position themselves, so that fault has no counterpart
here.  A text-only server drops an "image" field.  An image that cannot
be read, or whose rows the KV pool cannot hold, ends that message with a
STATUS line and "<eos>" and leaves the conversation as it was.

One connection is one conversation.  Without --batch each connection gets
its own `Engine` (KV cache and position) over the shared weights, and
generations take turns through an asyncio lock.  With --batch N the
connections share one `BatchScheduler` on a `SchedulerThread`: each
conversation leases a slot and the turns of all connections decode
together.  --batch pages the KV cache by default (`auto_pool_tokens`
rows); --no-paged keeps the contiguous per-slot cache.

--tp N / --cp M run the model on a (tp, cp) mesh of ranks
(`parallel.distributed.Mesh`): each connection's Engine, or with --batch
the one scheduler, drives the mesh.  --dp R (with --batch) serves R
scheduler replicas behind the least-loaded router (`serve.replicas`), each
stepped by a SchedulerThread of its own; a conversation stays on the
replica that holds its KV.  The JAX backend's checks hold: --dp needs
--batch and refuses --cp, --pool-tokens needs --batch and refuses --cp,
and under --cp the automatic paged pool stays off.

`BackendServer.handle` takes any connection object with an async `send()`
and async iteration over incoming messages, so the protocol runs without
a network; only `serve()` imports the `websockets` package.

Usage:
    python -m lmrs_tpu_torch.serve.backend --model m.lmrs --tokenizer
        tokenizer.bin [--ip 127.0.0.1] [--port 5000] [--batch N]
        [--cache-dtype int8] [--spec-k K] [--device cpu]
        [--multimodal] [--num-crops N] [--tp N] [--cp M] [--dp R]
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import datetime
import io
import json
import os
from typing import List, Optional

from lmrs_tpu_torch.cli.chat import (LLAMA_SYSTEM_PREFIX, LLAMA_SYSTEM_SUFFIX,
                                     PHI_TURN_SUFFIX)
from lmrs_tpu_torch.config import ModelType, resolve_device

# prompt rows per prefill chunk, single-stream and batched: one chunk per
# scheduler tick, so a 1,024-token prompt is admitted in four ticks
PREFILL_CHUNK = 256
CAPACITY = "Server at capacity — try again later"
CONTEXT_FULL = "Context window full — start a new session"
IMAGE_STATUS = ("Preprocessing the image", "Encoding the image",
                "Filling KV cache")
IMAGE_UNREADABLE = "Could not read the image"


def _response(category: str, text: str) -> str:
    return json.dumps({"category": category, "text": text})


class BackendServer:
    def __init__(self, model_path: str, tokenizer_path: str,
                 temperature: float = 0.7, top_p: float = 0.9,
                 seed: Optional[int] = None, multimodal: bool = False,
                 num_crops: int = 1, cache_dtype: str = "bfloat16",
                 max_new_tokens: Optional[int] = None, batch: int = 0,
                 max_ctx: Optional[int] = None, tp: int = 1, cp: int = 1,
                 spec_k: int = 0, pool_tokens: Optional[int] = None,
                 page_size: int = 512, dp: int = 1, no_paged: bool = False,
                 device=None):
        if pool_tokens is not None and (batch == 0 or cp > 1):
            raise ValueError("--pool-tokens (paged KV cache) requires "
                             "--batch; --cp is not supported (pages are "
                             "head-sharded, not sequence-sharded)")
        if dp > 1 and batch <= 0:
            raise ValueError("--dp requires --batch (the router multiplies "
                             "the batched scheduler)")
        if dp > 1 and cp > 1:
            raise ValueError("--dp with --cp is not supported")
        from lmrs_tpu_torch.io.lmrs import read_lmrs
        from lmrs_tpu_torch.io.params import (params_from_lmrs,
                                              vision_params_from_lmrs)
        from lmrs_tpu_torch.models.transformer import cache_dtype_of
        from lmrs_tpu_torch.tokenizer import Tokenizer

        self.device = resolve_device(device)
        self.tokenizer = Tokenizer.from_file(tokenizer_path)
        self.file = read_lmrs(model_path)
        self.cfg = self.file.cfg
        if multimodal and not self.cfg.multimodal:
            raise ValueError("Current model doesn't support multimodality.")
        self.multimodal = multimodal
        self.num_crops = num_crops
        self.tp, self.cp = tp, cp
        # --tp/--cp: the mesh every engine or the scheduler drives
        self.mesh = None
        if dp == 1 and tp * cp > 1:
            from lmrs_tpu_torch.parallel.distributed import Mesh

            self.mesh = Mesh.start(self.file, tp=tp, cp=cp,
                                   device=self.device.type)
            self.params = self.mesh.params
        elif dp == 1:
            self.params = params_from_lmrs(self.file, device=self.device)
        # the vision encoder and projector, loaded once for all images
        self.vision = (vision_params_from_lmrs(self.file, device=self.device)
                       if multimodal else None)
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
        self.router = None
        # batch mode: one SchedulerThread, or one a replica under --dp
        self.threads = []
        if batch > 0:
            from lmrs_tpu_torch.serve.scheduler import (BatchScheduler,
                                                        SchedulerThread,
                                                        auto_pool_tokens,
                                                        paged_supported)

            # paged by default where the pool can serve the config
            if (pool_tokens is None and not no_paged
                    and paged_supported(self.cfg, self.cache_dtype, cp)):
                pool_tokens = auto_pool_tokens(
                    batch, min(max_ctx or self.cfg.seq_len,
                               self.cfg.seq_len), page_size)
            kw = dict(max_batch=batch, max_ctx=max_ctx,
                      cache_dtype=self.cache_dtype, temperature=temperature,
                      top_p=top_p, seed=seed if seed is not None else 0,
                      speculative_k=spec_k, pool_tokens=pool_tokens,
                      page_size=page_size,
                      prefill_chunk=min(PREFILL_CHUNK, page_size),
                      w8a8=self.w8a8)
            if dp > 1:
                import torch

                from lmrs_tpu_torch.serve.replicas import ReplicaRouter

                # replicas go round the visible GPUs (one GPU serves both
                # replicas of --dp 2)
                n_dev = (torch.cuda.device_count()
                         if self.device.type == "cuda" else 1)
                self.router = ReplicaRouter(
                    self.file, dp=dp, tp=tp,
                    devices=[torch.device(self.device.type, i % n_dev)
                             if self.device.type == "cuda" else self.device
                             for i in range(dp * tp)], **kw)
                self.params = self.router.replicas[0].params
                self.threads = self.router.start_threads()
            else:
                sched = BatchScheduler(self.cfg, self.params,
                                       device=self.device, mesh=self.mesh,
                                       **kw)
                self.threads = [SchedulerThread(sched)]
            self.scheduler = self.threads[0]

    def warmup(self):
        """Build and load the CUDA kernels before taking traffic: the only
        preparation eager PyTorch needs.  A no-op on the CPU."""
        if self.device.type == "cuda":
            from lmrs_tpu_torch.kernels import cuda

            for name in cuda.SOURCES:
                cuda.library(name)

    def shutdown(self):
        if self.router is not None:
            self.router.close()         # its threads, then its meshes
        else:
            for thread in self.threads:
                thread.shutdown()
                thread.sched.close()
        if self.mesh is not None:
            self.mesh.shutdown()

    def _prompt(self, text: str, first_turn: bool,
                image_turn: bool = False) -> List[int]:
        tokens: List[int] = []
        if self.cfg.model_type == ModelType.LLAMA and first_turn:
            tokens.extend(LLAMA_SYSTEM_PREFIX)
            today = datetime.date.today().strftime("%d %b %Y")
            tokens.extend(self.tokenizer.encode(today))
            tokens.extend(LLAMA_SYSTEM_SUFFIX)
        if image_turn:
            # the turn right after an image: no chat template, its own end
            tokens.extend(self.tokenizer.encode(text.strip()))
            tokens.extend(PHI_TURN_SUFFIX)
        else:
            tokens.extend(self.tokenizer.encode(
                text.strip(), chat_format=True,
                model_type=self.cfg.model_type))
        return tokens

    def _stop_tokens(self):
        from lmrs_tpu_torch.tokenizer import EXTRA_STOP_TOKENS

        return {self.tokenizer.eos,
                *EXTRA_STOP_TOKENS.get(self.cfg.model_type, ())}

    def _message(self, raw):
        """(text, base64 image or None) of a message, or None for a frame
        to skip (malformed JSON, a binary frame, no "text"), as lm.rs skips
        them.  A text-only server drops an "image" field, as the JAX
        backend does."""
        try:
            msg = json.loads(raw)
            text = msg["text"]
        except (ValueError, KeyError, TypeError) as e:
            print(f"Error parsing message: {e}")
            return None
        return text, (msg.get("image") or None) if self.multimodal else None

    async def _decode_image(self, ws, image_b64: str):
        """The image as (H, W, 3) uint8 (PIL decodes the base64 bytes), or
        None after the unreadable status when they are not an image."""
        from lmrs_tpu_torch.models.phi3v import load_image

        def decode():
            try:
                return load_image(io.BytesIO(base64.b64decode(image_b64)))
            except (ValueError, OSError):   # bad base64; not an image
                return None

        await ws.send(_response("STATUS", IMAGE_STATUS[0]))
        img = await asyncio.get_running_loop().run_in_executor(None, decode)
        if img is None:
            await ws.send(_response("STATUS", IMAGE_UNREADABLE))
        return img

    def _encode_image(self, img, sched=None):
        """The image's embedding rows, the wrapper tokens' rows from the
        text weights of `sched` (the scheduler that takes them) or of the
        server (a mesh embeds them on its ranks)."""
        from lmrs_tpu_torch.models.phi3v import encode_image_to_embeds

        params, mesh = ((self.params, self.mesh) if sched is None
                        else (sched.params, sched.mesh))
        return encode_image_to_embeds(
            self.vision, params, self.cfg, img, self.num_crops,
            embed=None if mesh is None else mesh.embed)

    async def _ingest_image(self, ws, engine, image_b64: str) -> bool:
        """Single stream: encode the image and prefill its rows into the
        connection's engine, under the GPU lock.  False (after its status)
        when the image cannot be read, or its rows and a turn after them
        do not fit."""
        img = await self._decode_image(ws, image_b64)
        if img is None:
            return False
        await ws.send(_response("STATUS", IMAGE_STATUS[1]))
        loop = asyncio.get_running_loop()
        async with self.gpu_lock:
            embeds = await loop.run_in_executor(
                None, lambda: self._encode_image(img))
            await ws.send(_response("STATUS", IMAGE_STATUS[2]))
            if engine.pos + embeds.shape[0] + 1 >= self.cfg.seq_len:
                await ws.send(_response("STATUS", CONTEXT_FULL))
                return False
            await loop.run_in_executor(
                None, lambda: engine.prefill_embeds(embeds,
                                                    want_logits=False))
        return True

    async def _ingest_image_batched(self, ws, thread, lease,
                                    image_b64: str) -> bool:
        """Batched: encode the image and prefill its rows into the leased
        slot, both on the scheduler's thread between decode chunks.  False
        (after its status) when the image cannot be read, its rows and a
        turn after them do not fit, or the KV pool has no pages for them
        (the slot keeps its rows and pages)."""
        from lmrs_tpu_torch.serve.scheduler import PoolExhausted

        sched = thread.sched
        img = await self._decode_image(ws, image_b64)
        if img is None:
            return False
        await ws.send(_response("STATUS", IMAGE_STATUS[1]))

        def encode_and_fill():
            """None, or the status that says why the rows did not go in."""
            embeds = self._encode_image(img, sched)
            if (sched.slots[lease.slot_idx].pos + embeds.shape[0] + 1
                    >= sched.S):
                return CONTEXT_FULL
            try:
                sched.prefill_embeds(lease, embeds)
            except PoolExhausted:
                return CAPACITY
            return None

        loop = asyncio.get_running_loop()
        failed = await loop.run_in_executor(
            None, lambda: thread.call(encode_and_fill))
        await ws.send(_response("STATUS", IMAGE_STATUS[2]))
        if failed:
            await ws.send(_response("STATUS", failed))
        return failed is None

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
        from lmrs_tpu_torch.runtime.engine import Engine

        if self.scheduler is not None:
            return await self.handle_batched(ws)
        # under cp a prefill chunk divides the shard's rows
        engine = Engine(self.cfg, self.params, device=self.device,
                        cache_dtype=self.cache_dtype,
                        prefill_chunk=min(PREFILL_CHUNK,
                                          self.cfg.seq_len // self.cp),
                        w8a8=self.w8a8, mesh=self.mesh)
        try:
            await self._converse(ws, engine)
        finally:
            async with self.gpu_lock:
                engine.close()

    async def _converse(self, ws, engine):
        """The turns of one connection on its own Engine."""
        from lmrs_tpu_torch.runtime.engine import GenerationConfig
        from lmrs_tpu_torch.tokenizer import StreamDecoder

        gen = GenerationConfig(temperature=self.temperature,
                               top_p=self.top_p, seed=self.seed,
                               max_new_tokens=self.max_new_tokens,
                               speculative_k=self.spec_k)
        stop_tokens = self._stop_tokens()
        if self.multimodal:
            await ws.send(_response("FEATURE", "multimodal"))
        async for raw in ws:
            msg = self._message(raw)
            if msg is None:
                continue
            text, image = msg
            image_turn = image is not None
            if image_turn and not await self._ingest_image(ws, engine,
                                                           image):
                await ws.send(_response("OUTPUT", "<eos>"))
                continue
            prompt_tokens = self._prompt(text, engine.pos == 0, image_turn)
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

    def lease(self):
        """(SchedulerThread, lease) of a new conversation in batch mode: a
        slot of the one scheduler, or under --dp of the replica the router
        places it on (`ReplicaRouter.new_conversation`); the lease is None
        when every slot is taken."""
        if self.router is not None:
            rlease = self.router.new_conversation()
            if rlease is None:
                return None, None
            return self.router.threads[rlease.replica], rlease.lease
        thread = self.scheduler
        return thread, thread.call(thread.sched.new_conversation)

    async def handle_batched(self, ws):
        """Continuous-batching connection handler: the conversation leases
        one scheduler slot, and its turns decode together with the other
        connections'."""
        from lmrs_tpu_torch.tokenizer import StreamDecoder

        thread, lease = self.lease()
        if lease is None:
            await ws.send(_response("STATUS", CAPACITY))
            return
        sched = thread.sched
        stop_tokens = self._stop_tokens()
        first_turn = True
        if self.multimodal:
            await ws.send(_response("FEATURE", "multimodal"))
        try:
            async for raw in ws:
                msg = self._message(raw)
                if msg is None:
                    continue
                text, image = msg
                image_turn = image is not None
                if image_turn and not await self._ingest_image_batched(
                        ws, thread, lease, image):
                    await ws.send(_response("OUTPUT", "<eos>"))
                    continue
                prompt_tokens = self._prompt(text, first_turn, image_turn)
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
                   help="take images (an \"image\" field, base64) for a "
                        "multimodal model; PIL decodes them")
    p.add_argument("--num-crops", dest="num_crops", type=int, default=1,
                   help="most HD crops of an image besides its global view")
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
                   help="tensor-parallel ranks (Megatron sharding; one "
                        "process a rank)")
    p.add_argument("--cp", type=int, default=1,
                   help="context-parallel ranks (the KV cache's sequence "
                        "sharded)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel scheduler replicas behind a least-"
                        "loaded router (requires --batch)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    server = BackendServer(args.model, args.tokenizer, args.temperature,
                           args.top_p, args.seed, args.multimodal,
                           num_crops=args.num_crops,
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
