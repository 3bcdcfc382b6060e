"""Interactive chat CLI.

Multi-turn conversations share the KV cache, `pos` only growing within a
session; Llama gets the system-prompt template with today's date.  A
multimodal model (Phi-3.5-vision) takes --image: the image is encoded
(`models.phi3v.encode_image_to_embeds`, --num-crops crops at most) and its
rows prefilled before the first turn, which then ends with
PHI_TURN_SUFFIX instead of the chat template.

Usage:
    python -m lmrs_tpu_torch.cli.chat --model model.lmrs
        [--tokenizer tokenizer.bin] [--temperature 0.7] [--top-p 0.9]
        [--seed N] [--max-new-tokens N] [--show-metrics] [--device cpu]
        [--cache-dtype bfloat16|float32|int8|int4] [--spec-k K]
        [--image img.png] [--num-crops 1] [--tp N] [--cp M]

Runs on the GPU unless --device names another device.  --show-metrics
prints, after each reply, its speed and the CUDA kernel launches since
the program started (0 on the CPU, where the plain versions run), and with
--spec-k the share of drafted tokens that were accepted.  --spec-k K turns
on prompt-lookup speculative decoding with K drafted tokens per step.  Q8_0
layer weights decode with int8 activations (W8A8) unless the environment
sets LMRS_W8A8=0, the JAX package's own switch.  --tp N / --cp M run the
model on a (tp, cp) mesh of ranks (`parallel.tp.make_mesh_engine`: N*M
processes, this one rank 0; the launch counts are then every rank's,
summed); --image with --cp is refused, as the JAX CLI refuses it.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time
from typing import List, Optional

LOGO = r"""
    L      M     M  RRRR    ssss
    L      MM   MM  R   R  s
    L      M M M M  RRRR    sss
    L      M  M  M  R  R       s
    LLLL   M     M  R   R  sssss
"""

# Llama-3 system prompt template with knowledge-cutoff header
LLAMA_SYSTEM_PREFIX = [128000, 128006, 9125, 128007, 271, 38766, 1303, 33025,
                       2696, 25, 6790, 220, 2366, 18, 198, 15724, 2696, 25,
                       220]
LLAMA_SYSTEM_SUFFIX = [271, 128009]

# Phi-3.5-vision: the end of the first turn after an image, which takes no
# chat template (the rows around the image itself are
# models.phi3v.PHI_IMAGE_PREFIX_IDS and PHI_IMAGE_SUFFIX_IDS)
PHI_TURN_SUFFIX = [32007, 29871, 13, 32001, 29871, 13]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lmrs_tpu_torch chat")
    p.add_argument("--model", required=True)
    p.add_argument("--tokenizer", default="tokenizer.bin")
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top-p", dest="top_p", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--show-metrics", action="store_true")
    p.add_argument("--max-new-tokens", type=int, default=4096)
    p.add_argument("--seq-len", dest="seq_len", type=int, default=None,
                   help="override the context length")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--spec-k", dest="spec_k", type=int, default=0,
                   help="prompt-lookup speculative decoding: drafted tokens "
                        "per verify step (0 = off)")
    p.add_argument("--cache-dtype", default="bfloat16",
                   choices=["bfloat16", "float32", "int8", "int4"])
    p.add_argument("--image", default=None,
                   help="an image file for a multimodal model, encoded and "
                        "prefilled before the first turn (needs PIL to "
                        "decode the file)")
    p.add_argument("--num-crops", dest="num_crops", type=int, default=1,
                   help="most HD crops of the image besides its global view")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks (Megatron sharding; one "
                        "process a rank)")
    p.add_argument("--cp", type=int, default=1,
                   help="context-parallel ranks (the KV cache's sequence "
                        "sharded)")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_argparser().parse_args(argv)
    from lmrs_tpu_torch.config import resolve_device

    device = resolve_device(args.device)
    print(LOGO)

    for path, what in ((args.tokenizer, "Tokenizer"), (args.model, "Model")):
        if not os.path.exists(path):
            sys.exit(f"{what} file not found: {path}")

    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import params_from_lmrs
    from lmrs_tpu_torch.runtime.engine import Engine
    from lmrs_tpu_torch.tokenizer import Tokenizer

    tokenizer = Tokenizer.from_file(args.tokenizer)
    f = read_lmrs(args.model)
    if args.seq_len:
        f.cfg = f.cfg.replace(seq_len=args.seq_len)
    cfg = f.cfg
    print(f"Model type: {cfg.model_type.name}")
    if cfg.quant.value:
        print(f"Using {cfg.quant.name} quantization.")
    print(f"Loading weights onto {device}...")
    w8a8 = os.environ.get("LMRS_W8A8", "1") == "1"
    mesh = None
    if args.tp > 1 or args.cp > 1:
        if args.image and args.cp > 1:
            sys.exit("--image with --cp is not supported yet (image-prefix "
                     "prefill under cp)")
        # the same Engine API over a (tp, cp) mesh of ranks
        from lmrs_tpu_torch.parallel.tp import make_mesh_engine

        # under cp a prefill chunk divides the shard's rows
        engine = make_mesh_engine(
            f, tp=args.tp, cp=args.cp, device=device,
            cache_dtype=args.cache_dtype, w8a8=w8a8,
            prefill_chunk=min(256, cfg.seq_len // args.cp))
        mesh, params = engine.mesh, engine.params
        print(f"Done (mesh: tp={args.tp} cp={args.cp}).\n")
    else:
        params = params_from_lmrs(f, device=device)
        engine = Engine(cfg, params, device=device,
                        cache_dtype=args.cache_dtype, w8a8=w8a8)
        print("Done.\n")
    try:
        _chat(args, tokenizer, f, cfg, params, engine, mesh, device)
    finally:
        if mesh is not None:
            mesh.shutdown()


def _chat(args, tokenizer, f, cfg, params, engine, mesh, device) -> None:
    """The conversation loop of `main`."""
    from lmrs_tpu_torch.config import ModelType
    from lmrs_tpu_torch.kernels import launches
    from lmrs_tpu_torch.runtime.engine import GenerationConfig
    from lmrs_tpu_torch.tokenizer import EXTRA_STOP_TOKENS, StreamDecoder

    image_turn = False
    if args.image:
        if not cfg.multimodal:
            sys.exit("Cannot use images in a non-multimodal model.")
        from lmrs_tpu_torch.io.params import vision_params_from_lmrs
        from lmrs_tpu_torch.models.phi3v import encode_image_to_embeds

        print("Preprocessing the image...")
        embeds = encode_image_to_embeds(
            vision_params_from_lmrs(f, device=device), params, cfg,
            args.image, args.num_crops,
            embed=None if mesh is None else mesh.embed)
        print("Filling KV Cache...\n")
        engine.prefill_embeds(embeds, want_logits=False)
        image_turn = True
    gen = GenerationConfig(temperature=args.temperature, top_p=args.top_p,
                           seed=args.seed, max_new_tokens=args.max_new_tokens,
                           speculative_k=args.spec_k)

    stop_tokens = {tokenizer.eos, *EXTRA_STOP_TOKENS.get(cfg.model_type, ())}
    while True:
        try:
            user_prompt = input("You: ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return
        if not user_prompt:
            continue

        prompt_tokens: List[int] = []
        if cfg.model_type == ModelType.LLAMA and engine.pos == 0:
            prompt_tokens.extend(LLAMA_SYSTEM_PREFIX)
            today = datetime.date.today().strftime("%d %b %Y")
            prompt_tokens.extend(tokenizer.encode(today))
            prompt_tokens.extend(LLAMA_SYSTEM_SUFFIX)
        if image_turn:
            # the first turn after an image: no chat template, its own end
            prompt_tokens.extend(tokenizer.encode(user_prompt))
            prompt_tokens.extend(PHI_TURN_SUFFIX)
            image_turn = False
        else:
            prompt_tokens.extend(tokenizer.encode(
                user_prompt, chat_format=True, model_type=cfg.model_type))

        print("Assistant:")
        decoder = StreamDecoder(tokenizer)
        t0 = time.perf_counter()
        n_tokens = 0

        def on_token(tok: int):
            nonlocal n_tokens
            n_tokens += 1
            if tok not in stop_tokens:
                sys.stdout.write(decoder.push(tok))
                sys.stdout.flush()

        engine.generate(prompt_tokens, gen, stop_tokens=stop_tokens,
                        on_token=on_token)
        sys.stdout.write(decoder.flush() + "\n")
        if args.show_metrics:
            dt = time.perf_counter() - t0
            m = engine.metrics
            print(f"Speed: {n_tokens / dt:.2f} tok/s  (decode "
                  f"{m.tokens_per_second:.2f} tok/s, TTFT "
                  f"{1e3 * (m.ttft_seconds or 0.0):.1f} ms, {device})")
            if m.spec_proposed:
                print(f"Speculative: {m.spec_accepted}/{m.spec_proposed} "
                      f"drafts accepted "
                      f"({m.spec_accepted / m.spec_proposed:.0%})")
            counts = launches()
            if mesh is not None:
                counts = {name: sum(r[name] for r in
                                    mesh.stats()["launches"])
                          for name in counts}
            print(f"Kernel launches since start: {json.dumps(counts)}")


if __name__ == "__main__":
    main()
