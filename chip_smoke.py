#!/usr/bin/env python3
"""On-card smoke run of lmrs_tpu_torch: the quickest proof that the port
builds and serves on an NVIDIA Hopper GPU.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases (any failure ends the run with a non-zero exit):
1. The card (`nvidia-smi` name and power limit), torch and CUDA versions;
   build the CUDA kernels from lmrs_tpu_torch/csrc.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   its main path gives it, with CUDA-event timings (median of 50 launches
   after warm-up, L2 flushed before each, as a decode step finds the
   weights): kernel, plain version, one PyTorch library call computing the
   same function (timed only, never used by the port), and the bound (the
   larger of bytes / memory rate and operations / peak rate).  A (q4_gemv),
   B (q4_gemm), C (flash_attention, bf16 cache) and H (flash_attention_i4,
   half packing) at the Gemma-2-9B shapes; D (q8_gemv_i8, one launch with
   its quantizer inside; the quantizer's arithmetic bit for bit first, on
   its own launch; library yardsticks bf16 torch.matmul and
   torch._int_mm), E (q8_gemv), F (q8_gemm), C on a bf16 and
   on an f32 cache, G (flash_attention_i8) and H (pair packing) at the
   Llama-3.2-3B shapes.  The T <= 8 matmul kernels run at T 1, 4 and 5 (A
   also at 8, a batched step of 8 slots) and the flash kernels at T 1, 5
   and 256: T = 5 is a speculative verify window of k = 4.  B and F run at T 9, 16, 64, 256 and 512, and are held
   bit for bit on rows of x that are unit vectors (W_deq's columns) and
   across two calls on the same inputs.  I (flash_attention_batched,
   per-slot cache: bf16, f32, int8) and J (flash_attention_paged, pools of
   512- and 56-row pages: bf16, f32, int8, int4) at both models' geometry,
   8 slots at positions 0..6,000 (some past Gemma's window), T 1 and 5:
   within the plain version's bound, each slot bit for bit C / G / H on its
   own rows, J bit for bit I, and a slot unchanged when every other slot,
   page and the trash page hold NaN; timed at the per-slot cache and
   512-row pages (library yardstick: SDPA over each slot's live rows,
   padded, with a mask).  K (ffn_fused_xe, T 1, 2, 5, 8; its device time
   and span from the profiler beside the timer) and L (ffn_fused, T 9, 12,
   16), the fused FFN of one layer, at Gemma-2-9B's FFN (Q4_0,
   tanh-GELU) and Llama-3.2-3B's (Q8_0, silu); library yardstick: the
   unfused chain in PyTorch calls (two torch.matmul on pre-dequantized bf16
   W13 and W2, the GLU between them).  A decode call of C, G, H, I or J
   (one query block per kv head) is flash-decoding: the template's split
   pass and kernel M (flash_merge), both in the timings; C, G and H are
   also held at positions on split boundaries and at Gemma's window edge.
   B1 (the cp partials, flash_attention_batched(..., seq_base=,
   return_lse=True)) on 4 sequence shards of the Gemma per-slot cache: each
   shard against the plain version, rows with no live key at m ==
   _MASK_NEG, the shards merged by M against I and the plain version.  M
   against its plain version on the split pass's workspaces of C and I.
   B1 also on 2 shards of 3,072 rows, Gemma's window edge inside shard 0
   (held, not timed).  A, B and K at Gemma-2-9B's tp = 2 local shapes, D,
   E, F and L at Llama-3.2-3B's tp = 2 and tp = 4 ones (heads, kv heads,
   hidden dim and vocabulary divided by tp: wo 3,072 x 1,536, w2 3,072 x
   4,096 at tp = 2), each against its plain version (held, not timed).
   Then, per kernel, whether a row of a T = 5 call equals the same row
   computed alone (what makes speculative greedy decoding exact; A and D
   also at T = 8): a "no" fails the run for A, D, K and the flash kernels,
   whose designs promise it.
3. The Q4_0 main path at full width, cut to GEMMA_DEPTH (5) of its 42
   layers to make room for phase 7: a synthetic Gemma-2-9B Q4_0
   .lmrs (seed 0) written with the port's own writer, loaded with
   params_from_lmrs onto the card, Engine.generate greedy on a 1,024-token
   prompt (256-token chunks) for 64 new tokens twice across reset()
   (identical tokens), then one top-p generation; A, B, C and M, and no
   other kernel, must have launched.  The same with fuse_ffn on (K
   besides; the launches of one decode step exactly K 5, A 11, C 5, M 5
   at 5 layers; greedy tokens
   equal the unfused path's up to a near-tie), then speculative greedy
   decoding (k = 4, K at T = 5) on that engine and one BatchScheduler wave
   of 8 requests on the paged bf16 pool (K), all on the loaded params.
   Then the int4 KV cache (A, B and
   H), then speculative greedy decoding (k = 4) on that engine against its
   plain greedy tokens.  Then the chat CLI in a subprocess on the same
   file with a synthetic tokenizer; the launch counts it prints
   (--show-metrics) must show the same kernels.
   3b. Batched serving of the same file through BackendServer(batch=8):
   8 requests of 256-1,024 random tokens at once (6 greedy, 2 top-p 0.9
   at T 0.7), 64 tokens each, then 4 more on the freed slots, then a
   two-turn conversation through `handle` on an in-process connection; on
   the default paged pool (bf16; J), the contiguous cache (I, and C for
   prefill) and the int4 pool (J, half packing).  Every greedy stream
   equals the single-stream Engine's greedy tokens up to a near-tie.
4. The Q8_0 main path at full width, cut to LLAMA_DEPTH (5) of its 28
   layers (phase 7 runs it whole): a synthetic Llama-3.2-3B
   Q8_0 .lmrs (seed 0), the same three generations with the bf16 KV cache
   (D, E, F and C must have launched), with the int8 KV cache (D, E, F and
   G) and with the int4 KV cache (D, E, F and H), the launch counts set to
   0 just before each and read just after.  On the int4 engine then:
   speculative greedy (k = 4, equal to the plain greedy tokens up to a
   near-tie, drafts both accepted and rejected), speculative top-p, and a
   session saved after the prompt and 16 tokens, loaded into a fresh
   Engine and continued for 16 tokens as the uninterrupted engine
   continues.  One greedy run on an f32 cache, whose tokens are the bf16
   path's.  The int8 path with fuse_ffn on (the launches of one decode
   step exactly K 5, D 10, E 1, G 5, M 5 at 5 layers; greedy tokens
   equal the unfused path's up to a near-tie) and one BatchScheduler wave
   of 16 requests on the int8 pool (L, a launch a layer a step of 9..16
   rows).  Then the chat
   CLI with --cache-dtype int8, and with --cache-dtype int4 --spec-k 4.
   4b. Batched serving through BackendServer(batch=16): one request with
   a 512-token system prefix first, then 15 at once (8 sharing that
   prefix, whose pages they fork: 8 prefix-cache hits; 12 greedy, 3 top-p)
   on the int8 pool (F carries the layers and the classifier at 16 rows),
   then on the int4 pool (pair packing) with speculation, k = 4 (80 rows a
   step).  Each batched path prints aggregate and per-request tok/s,
   TTFT, pool pages used and their peak, peak memory, prefix-cache hits
   and the speculative acceptance; its launch counts are set to 0 just
   before and read just after.  Every batched path without speculation
   (3b, 4b, the fused waves) decodes through the scheduler's CUDA graph,
   whose replays add the launches read from the graph's own kernel nodes:
   after its counts are read, the same decode step is captured anew into
   a graph that never runs, and the two graphs' kernel nodes must be the
   same functions the same number of times, and the launches the serving
   graph's nodes count the wrappers' counts of the step's calls; a
   speculative path must never replay it.
5. The multimodal path at full width and depth: a synthetic
   Phi-3.5-vision Q8_0 .lmrs (seed 0; CLIP ViT-L/14-336 encoder, 24
   layers, and the 4,096 -> 3,072 projector) written with the port's own
   writer.  A seeded (756, 1008, 3) image (no PIL) at 4 crops: 5 crops of
   577 rows through 23 encoder layers, 757 image rows + 7 wrapper rows.
   The exact (integer) matmul at a vision shape on the card against the
   CPU (integer part bit for bit), and the encoder cut to 2 layers (f32
   weights within 1e-4 of the output scale; Q8_0 weights within 1e-2,
   the activation quantizer's rounding steps).  Host preprocessing ms,
   the tower's and the projector's device ms (CUDA events).  The Engine:
   encode, prefill_embeds of the 764 rows, a 22-row turn ending in
   PHI_TURN_SUFFIX, 32 greedy tokens twice across reset() and a fresh
   encode (identical), then top-p: F, C, M, D, E and no other kernel.
   Then a BatchScheduler (2 slots, paged bf16 pool): a leased
   conversation takes the same rows and turn while a text request decodes
   beside it: F, J, M, D, E, and both greedy streams equal to the
   Engine's up to a near-tie.  Image turn TTFT, prefill of the rows,
   decode tok/s, peak memory, the phase's seconds.
6. The offline path at full width and depth: a seeded BF16 Llama-3.2-1B
   checkpoint in the Hugging Face layout (written here: the machine has no
   `safetensors`), exported by `python -m lmrs_tpu_torch.io.export` to
   Q8_0 and to Q4_0 (seconds, group errors).  2,048 seeded tokens scored
   teacher-forced in 128-row chunks on an f32 cache
   (`scripts/torch_perplexity.score_tokens`): the checkpoint's f32
   weights (C only; its logits must spread by 1 or more across the
   vocabulary), Q8_0 (F, C) and Q4_0 (B, C), each |NLL delta| < 0.05
   against f32; Q8_0 on the bf16, int8 and int4 caches (C, G, H), each
   within 0.05 of the f32 cache; Q8_0 at chunk 256 within 1e-3 of chunk
   128; the CLI on the Q8_0 file equal to the in-process NLL; the f32
   weights and both files cut to 2 layers (full width) scored on the card
   and on the CPU's plain versions within 1e-3.  The native tokenizer attached on a 128,256-token
   vocabulary and equal to the Python merge loop (both timed); the
   desktop page served, and one turn through BackendServer.handle on the
   Q8_0 file (D, E, F, C, M).  Each run's launch counts are set to 0 just
   before and read just after, and its kernel set must be exact.
7. Tensor, context and data parallelism (`parallel/`): a synthetic
   Llama-3.2-3B Q8_0 .lmrs (seed 0, full width and depth) on meshes of
   rank processes that share this one card over gloo (the compute mode
   printed first: Exclusive_Process fails the phase), each rank loading
   its own shard.  tp = 2: the Engine on a 1,024-token prompt, 32 greedy
   tokens twice across reset(), with the bf16 cache (D, E, F, C, M summed
   over both ranks), speculative greedy (k = 4) and the int8 cache (D, E,
   F, G, M); a session saved on tp = 2 after 16 tokens and continued on
   one device as tp = 2 continues it; then BackendServer(batch=8, tp=2)
   on a mesh of its own, one wave of 8 requests (6 greedy, 2 top-p) on the
   paged bf16 pool (D, E, F, J, M).  cp = 2: a 5,000-token prompt across
   the 4,096-row shard edge and 32 greedy tokens (D, E, F, I, B1 on both
   ranks, M, and no C), then BackendServer(batch=4, cp=2), a 4-request
   wave on the per-slot cache (no paged pool under cp).  tp 2 x cp 2: four
   ranks, a 1,024-token prompt, 16 tokens.  dp = 2: BackendServer(batch=8,
   dp=2), both replicas on this card, each request leased through the
   backend's own lease path (the router), 4 placed on each.  The chat CLI
   with --tp 2.  The mesh Engines decode in mesh chunks of 8 steps (one
   call a chunk; every rank samples, and the ranks' tokens are held
   against each other once a chunk).  Every greedy stream equals the
   one-device Engine's up to a near-tie (1e-2 of the logit scale); per
   mesh shape: load s per rank, TTFT, decode tok/s, peak memory per rank,
   a decode step's collectives and their host ms, and a decode chunk's
   collectives and broadcasts a token (ranks time-sharing one card: not a
   scaling figure).
8. The decode chunk at full depth: phase 7's Llama-3.2-3B Q8_0 (28 layers)
   on one device, bf16 cache, 65 tokens after a 1,024-token prompt with
   decode_chunk 1 and 8, each read at the end and streamed, in two turns:
   decode tok/s and host ms a token in the chunks' dispatch, all eight
   runs' tokens equal; speculative k = 4 in chunks of 8 verify steps:
   tokens a verify step and decode tok/s.
9. One JSON line of per-kernel results (launches over every path above,
   summed over a mesh's ranks), the card's name and power limit, and the
   last line {"ok": true, "decode_graph_replays": <decode steps that
   replayed the graph over the batched serving paths of 3b, 4b and the
   fused waves>, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

GS = 128
# the two models' geometry: dim, hidden, layers, heads, kv heads, head_dim,
# vocabulary, sliding window, attention softcap
GEMMA = dict(name="gemma2-9b", D=3584, HID=14336, L=42, H=16, KH=8, HD=256,
             V=256000, WINDOW=4096, SOFTCAP=50.0)
LLAMA = dict(name="llama3.2-3b", D=3072, HID=8192, L=28, H=24, KH=8, HD=128,
             V=128256, WINDOW=None, SOFTCAP=None)
# Phi-3.5-mini (phase 5's text model): head_dim 96, zero-padded to a
# 128-lane cache head (CHD) for the attention kernels; 32,064 classifier
# rows, 64 past a multiple of 128
PHI = dict(name="phi3.5-mini", D=3072, HID=8192, L=32, H=32, KH=32, HD=96,
           CHD=128, V=32064, WINDOW=None, SOFTCAP=None)
LAYER_SHAPES = ("wqkv", "wo", "w13", "w2")


def local_model(m, tp):
    """`m`'s shapes on one rank of tp: heads, kv heads, hidden dim and
    vocabulary divided by tp (`config.local_config`; wo and w2 take the
    rank's input columns, the classifier its vocabulary rows)."""
    return dict(m, name=f"{m['name']} tp={tp}", H=m["H"] // tp,
                KH=m["KH"] // tp, HID=m["HID"] // tp, V=m["V"] // tp)


def fmt_ms(v):
    return "untimed" if v is None else f"{v:.4f}"


def matmul_shapes(m):
    """name -> (out_features, in_features) of a model's five matmuls."""
    return {"wqkv": ((m["H"] + 2 * m["KH"]) * m["HD"], m["D"]),
            "wo": (m["D"], m["H"] * m["HD"]),
            "w13": (2 * m["HID"], m["D"]),
            "w2": (m["D"], m["HID"]),
            "classifier": (m["V"], m["D"])}


# Data-sheet peaks (dense) by torch.cuda.get_device_name: memory bytes/s and
# operations/s by operand type.  Add a card when a run uses it.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(mem=3.35e12, bf16=989e12, f32=67e12,
                                  int8=1979e12),            # H100 SXM
}

REPLACES = {
    "q4_gemv": "lmrs_tpu/kernels/vpu_matvec.py:238 _vm_q4_kernel; "
               "lmrs_tpu/kernels/vpu_matvec.py:284 _xe_q4_km_kernel; "
               "lmrs_tpu/kernels/dequant_matmul.py:478 _q4_xe_stacked_kernel; "
               "lmrs_tpu/kernels/dequant_matmul.py:279 _q4_xe_kernel",
    "q4_gemv_t8": "lmrs_tpu/kernels/vpu_matvec.py:284 _xe_q4_km_kernel; "
                  "lmrs_tpu/kernels/dequant_matmul.py:478 "
                  "_q4_xe_stacked_kernel (at T = 8)",
    "q4_gemm": "lmrs_tpu/kernels/dequant_matmul.py:542 _q4_se_stacked_kernel; "
               "lmrs_tpu/kernels/vpu_matvec.py:318 _se_q4_km_kernel",
    "flash_attention": "lmrs_tpu/kernels/flash_attention.py:140 "
                       "_flash_kernel (bf16 cache)",
    "q8_gemv_i8": "lmrs_tpu/kernels/dequant_matmul.py:507 "
                  "_q8_xei8_stacked_kernel; "
                  "lmrs_tpu/kernels/vpu_matvec.py:266 _xe_i8_km_kernel",
    "q8_gemv": "lmrs_tpu/kernels/vpu_matvec.py:218 _vm_q8_kernel; "
               "lmrs_tpu/kernels/dequant_matmul.py:459 _q8_xe_stacked_kernel; "
               "lmrs_tpu/kernels/dequant_matmul.py:243 _q8_xe_kernel",
    "q8_gemm": "lmrs_tpu/kernels/dequant_matmul.py:531 _q8_se_stacked_kernel; "
               "lmrs_tpu/kernels/vpu_matvec.py:306 _se_q8_km_kernel",
    "flash_attention_i8": "lmrs_tpu/kernels/flash_attention.py:140 "
                          "_flash_kernel (int8 cache, quantized=True; "
                          "_head_block_update :76)",
    "flash_attention_i4": "lmrs_tpu/kernels/flash_attention.py:140 "
                          "_flash_kernel (int4 cache, packed4=True, half "
                          "and pair; _head_block_update :76)",
    "flash_attention_f32": "lmrs_tpu/kernels/flash_attention.py:140 "
                           "_flash_kernel (f32 cache, rounded to bf16 on "
                           "load; _head_block_update :110)",
    "flash_attention_batched": "lmrs_tpu/kernels/flash_attention.py:503 "
                               "_flash_kernel_batched via "
                               "flash_decode_batched",
    "flash_attention_paged": "lmrs_tpu/kernels/flash_attention.py:650 "
                             "_flash_kernel_batched via flash_decode_paged",
    "ffn_fused_xe": "lmrs_tpu/kernels/fused_ffn.py:526 _ffn_xe_kernel via "
                    "ffn_fused_xe_stacked",
    "ffn_fused": "lmrs_tpu/kernels/fused_ffn.py:242 _ffn_kernel via "
                 "ffn_fused_pallas",
    "flash_merge": "lmrs_tpu/kernels/flash_attention.py:140 _flash_kernel "
                   "and :322 _flash_kernel_batched: the online-softmax carry "
                   "across their sequential sequence-block grid steps; "
                   "lmrs_tpu/models/transformer.py:1033 the cp merge of "
                   "flash_decode_batched's partials",
    "flash_attention_batched_lse": "lmrs_tpu/kernels/flash_attention.py:503 "
                                   "_flash_kernel_batched with lse=True and "
                                   "seq_base, via flash_decode_batched("
                                   "seq_base=, return_lse=True)",
}
# B and F also compute the unstacked _q4_kernel / _q8_kernel that the JAX
# package reaches through qmatmul_pallas (a batched step's classifier); E
# and F the experimental group-loop _q8_kernel_gl (scripts/kbench.py)
REPLACES["q4_gemm"] += "; lmrs_tpu/kernels/dequant_matmul.py:837 _q4_kernel"
REPLACES["q8_gemm"] += "; lmrs_tpu/kernels/dequant_matmul.py:806 _q8_kernel"
REPLACES["q8_gemv"] += ("; lmrs_tpu/kernels/dequant_matmul.py:220 "
                        "_q8_kernel_gl (T <= 8)")
REPLACES["q8_gemm"] += ("; lmrs_tpu/kernels/dequant_matmul.py:220 "
                        "_q8_kernel_gl (T > 8)")
SOURCES = {name: f"lmrs_tpu_torch/csrc/{name}.cu" for name in REPLACES}
SOURCES["ffn_fused_xe"] = SOURCES["ffn_fused"]              # one source
SOURCES["q4_gemv_t8"] = SOURCES["q4_gemv"]
for _name in ("flash_attention_i8", "flash_attention_i4",
              "flash_attention_f32", "flash_attention_batched",
              "flash_attention_paged", "flash_merge",
              "flash_attention_batched_lse"):
    SOURCES[_name] = SOURCES["flash_attention"]             # one template
# kernel C's f32 instantiation shares C's wrapper and launch count: its
# launches are those of the path that runs an f32 cache.  No main path
# calls the cp partials form (B1: seq_base, return_lse), which runs only in
# phase 2's checks; its row in the kernels line reports kernel I's
# launches on the main path, every one a decode call through the same
# split pass, and says so (`launches_are`)
# kernel A at T = 8 (a batched step of 8 slots) is a row of its own in the
# kernels line, sharing A's source and launch count
COUNTER = {"flash_attention_f32": "flash_attention",
           "q4_gemv_t8": "q4_gemv"}
LAUNCHES_ARE = {"flash_attention_batched_lse": (
    "B1's own launches on the main paths, summed over the ranks: phase 7's "
    "cp decode steps (kernel I's split pass with the shard's row base, "
    "also counted in I's, then M's raw merge, counted in M's)"),
    "q4_gemv_t8": "kernel A's launches on the main paths, at every T"}
# every path decodes: a decode call of C, G, H, I or J is the split pass
# and kernel M's merge (flash_merge), one launch each
Q4_PATH = {"q4_gemv", "q4_gemm", "flash_attention", "flash_merge"}
Q4_I4_PATH = {"q4_gemv", "q4_gemm", "flash_attention_i4", "flash_merge"}
Q8_PATH = {"q8_gemv_i8", "q8_gemv", "q8_gemm", "flash_attention",
           "flash_merge"}
Q8_I8_PATH = {"q8_gemv_i8", "q8_gemv", "q8_gemm", "flash_attention_i8",
              "flash_merge"}
Q8_I4_PATH = {"q8_gemv_i8", "q8_gemv", "q8_gemm", "flash_attention_i4",
              "flash_merge"}
GEMV_T = (1, 4, 5)      # 5: a speculative verify window of k = 4
GEMV_T_A = GEMV_T + (8,)   # A also at a batched step of 8 slots
# B and F: a batched step of 9-16 rows, a scheduler prefill chunk (64), a
# single-stream prefill chunk (256) and the kernels' widest call (512)
GEMM_T = (9, 16, 64, 256, 512)
# batched serving paths: (kernels that must launch, kernels that may).  A
# prefill chunk's classifier runs on its one logits row (A or E); a prompt
# tail of up to 8 rows takes the T <= 8 kernels
GEMMA_PAGED = ({"q4_gemv", "q4_gemm", "flash_attention_paged",
                "flash_merge"}, set())
GEMMA_CONTIG = ({"q4_gemv", "q4_gemm", "flash_attention",
                 "flash_attention_batched", "flash_merge"}, set())
LLAMA_PAGED = ({"q8_gemm", "q8_gemv", "flash_attention_paged",
                "flash_merge"}, {"q8_gemv_i8"})
# the fused-FFN paths: the main path's kernels and K; the launches of one
# decode step after the prompt, exactly
GEMMA_FUSED = Q4_PATH | {"ffn_fused_xe"}
# the depth phases 3 and 4 run their models at (of 42 and 28 layers),
# cut to make room for phase 7 within the run's time (PERF.md §4); phase
# 2 holds every kernel at the full models' shapes and phase 7 runs
# Llama-3.2-3B at full depth
GEMMA_DEPTH = 5
LLAMA_DEPTH = 5
GEMMA_FUSED_TOKEN = {"q4_gemv": 2 * GEMMA_DEPTH + 1,
                     "flash_attention": GEMMA_DEPTH,
                     "flash_merge": GEMMA_DEPTH,
                     "ffn_fused_xe": GEMMA_DEPTH}
LLAMA_I8_FUSED = Q8_I8_PATH | {"ffn_fused_xe"}
LLAMA_I8_FUSED_TOKEN = {"q8_gemv_i8": 2 * LLAMA_DEPTH, "q8_gemv": 1,
                        "flash_attention_i8": LLAMA_DEPTH,
                        "flash_merge": LLAMA_DEPTH,
                        "ffn_fused_xe": LLAMA_DEPTH}
# batched: a prefill tail of 9..16 rows takes L, of up to 8 rows K; a step
# with fewer than 9 rows left takes K
GEMMA_PAGED_FUSED = ({"q4_gemv", "q4_gemm", "flash_attention_paged",
                      "flash_merge", "ffn_fused_xe"}, {"ffn_fused"})
LLAMA_PAGED_FUSED = ({"q8_gemm", "q8_gemv", "flash_attention_paged",
                      "flash_merge", "ffn_fused"},
                     {"q8_gemv_i8", "ffn_fused_xe"})
FFN_T = {"ffn_fused_xe": (1, 2, 5, 8), "ffn_fused": (9, 12, 16)}
# the slots' positions of the batched kernel checks: 0 to 6,000, some past
# Gemma's 4,096-row window; pages of 512 rows and of 56 (a 64-row tile then
# spans two or three pages)
BATCH_POS = (0, 300, 1100, 2500, 4100, 4600, 5200, 6000)
SMALL_PAGE = 56


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A progress line, stamped with the seconds since the run began."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


class Timer:
    """CUDA-event timing: median over `iters` launches after `warmup`, the
    L2 cache flushed before each launch (a 128 MB write)."""

    def __init__(self, torch, iters=50, warmup=5):
        self.torch = torch
        self.iters, self.warmup = iters, warmup
        self.flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        pairs = []
        for _ in range(self.iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)


def profile_calls(torch, fn, keys, flush, calls=20, settle=False):
    """Device time of one call of `fn` and its span, from torch.profiler's
    trace of `calls` calls, each after `flush` (the timer's L2 flush): the
    kernels whose names hold one of `keys`, a call's kernels those between
    two other kernels (the flushes).  A call's device time is the sum of
    its kernels' times, its span from the first one's start to the last
    one's end.  Returns (mean device ms, median span ms) of the calls the
    trace kept; a trace that lost kernels is taken again.  `settle`: wait
    for the flush to end before each call, so that a programmatic
    dependent launch (M) cannot start early and wait inside its kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    groups = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush()
                if settle:
                    torch.cuda.synchronize()
                fn()
            torch.cuda.synchronize()
        evs = sorted((ev for ev in prof.events()
                      if ev.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda ev: ev.time_range.start)
        groups, open_ = [], False
        for ev in evs:
            if not any(key in ev.name for key in keys):
                open_ = False
            elif open_:
                groups[-1].append(ev)
            else:
                groups.append([ev])
                open_ = True
        if len(groups) >= calls:
            break
    if not groups:
        return None, None
    busy = [sum(ev.time_range.elapsed_us() for ev in g) for g in groups]
    span = [max(ev.time_range.end for ev in g) - g[0].time_range.start
            for g in groups]
    return statistics.mean(busy) / 1e3, statistics.median(span) / 1e3


def bound_ms(nbytes: float, flops: float, flop_rate: float, mem: float):
    t_bytes, t_ops = nbytes / mem, flops / flop_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def random_q4(torch, gen, o, k):
    """Random runtime-layout Q4 bytes and negative f32 scales of the
    synthetic writer's magnitude."""
    q = torch.randint(0, 256, (o, k // 2), dtype=torch.uint8, device="cuda",
                      generator=gen)
    s = -(0.02 / 7.5) * (0.5 + torch.rand((o, k // GS), device="cuda",
                                          generator=gen))
    return q, s


def random_q8(torch, gen, o, k):
    """Random int8 values in [-127, 127] and f32 scales of the synthetic
    writer's magnitude."""
    q = torch.randint(-127, 128, (o, k), dtype=torch.int8, device="cuda",
                      generator=gen)
    s = (0.02 / 127.0) * (0.5 + torch.rand((o, k // GS), device="cuda",
                                           generator=gen))
    return q, s


def check_act_quant(torch, gen):
    """Kernel D's quantizer pre-pass, bit for bit against
    quant.quantize_q8_act on the card and on the CPU, on inputs that hold
    the rounding traps: a group of scale exactly 1 with quotients on and
    next to .5 (0.49999997 + 0.5 rounds up to 1.0 in f32: trunc gives 1,
    roundf would give 0), an all-zero group, and a group whose
    largest-magnitude value is negative."""
    from lmrs_tpu_torch.kernels.q8_gemv_i8 import q8_act_quant
    from lmrs_tpu_torch.quant import quantize_q8_act

    for t in (1, 4):
        for k in (LLAMA["D"], LLAMA["HID"]):
            x = torch.randn(t, k, device="cuda", generator=gen)
            x[0, :GS] = 0.0
            x[0, :8] = torch.tensor([127.0, 2.5, -2.5, 0.5, -0.5, 63.5,
                                     0.49999997, -0.49999997], device="cuda")
            x[0, GS:2 * GS] = 0.0
            x[-1, 2 * GS:3 * GS].clamp_(-1, 1)
            x[-1, 2 * GS + 3] = -5.0
            xq, xs = q8_act_quant(x, GS)
            wq, ws = quantize_q8_act(x, GS)
            cq, cs = quantize_q8_act(x.cpu(), GS)
            torch.cuda.synchronize()
            same = (torch.equal(xq, wq) and torch.equal(xs, ws)
                    and torch.equal(xq.cpu(), cq)
                    and torch.equal(xs.cpu(), cs))
            traps = (xq[0, :8].tolist() == [127, 3, -3, 1, -1, 64, 1, -1]
                     and not xq[0, GS:2 * GS].any().item()
                     and xs[0, 1].item() == 0.0
                     and xq[-1, 2 * GS + 3].item() == -127)
            log(f"  q8_act_quant T={t} K={k}: bit-exact {same}, traps "
                f"{traps}")
            if not (same and traps):
                raise RuntimeError(f"q8_act_quant T={t} K={k} differs from "
                                   f"quant.quantize_q8_act")


def check_gemm_exact(torch, kern, fn, q, s, shape, t, gen):
    """Kernel B or F bit for bit where the 1e-3 output tolerance cannot
    look: rows of x that are unit vectors e_k give W_deq[:, k] exactly
    (the packed dequant is dequant_bf16's rounding element for element),
    and a second call on the same inputs gives the same bits (split-K sums
    in a fixed order; greedy decoding across reset() relies on it).  Raises
    if either fails."""
    from lmrs_tpu_torch.kernels.q4_gemm import dequant_bf16 as dequant_q4
    from lmrs_tpu_torch.kernels.q8_gemm import dequant_bf16 as dequant_q8

    dequant = dequant_q4 if kern == "q4_gemm" else dequant_q8
    o, k = q.shape[0], s.shape[1] * GS
    cols = torch.randint(0, k, (t,), device="cuda", generator=gen)
    x = torch.zeros(t, k, device="cuda")
    x[torch.arange(t, device="cuda"), cols] = 1.0
    got = fn(x, q, s, GS)
    want = dequant(q, s, GS)[:, cols].t().float()
    xr = torch.randn(t, k, device="cuda", generator=gen)
    first, second = fn(xr, q, s, GS), fn(xr, q, s, GS)
    torch.cuda.synchronize()
    one_hot, same = torch.equal(got, want), torch.equal(first, second)
    if not (one_hot and same):
        raise RuntimeError(f"{kern} {shape} T={t}: one-hot rows give W_deq "
                           f"bit for bit {one_hot}, two calls equal {same}")


def check_matmul_kernels(torch, timer, peak, model, quant, timed=True):
    """The matmul kernels of one weight type against their plain versions
    at every shape of `model`'s main path; returns per-case results
    (`timed` False: held, not timed: a rank's local shapes).
    "q4": A (all five shapes, T 1, 4, 5 and 8) and B (layer shapes,
    GEMM_T).
    "q8": D (layer shapes, T 1, 4 and 5), E (all five, the same T) and F
    (layer shapes, GEMM_T).  B and F are also held bit for bit on one-hot
    rows and across two calls (`check_gemm_exact`)."""
    from lmrs_tpu_torch.kernels import q4_gemm, q4_gemv, q8_gemm, q8_gemv
    from lmrs_tpu_torch.kernels import q8_gemv_i8
    from lmrs_tpu_torch.kernels.q4_gemm import dequant_bf16 as dequant_q4
    from lmrs_tpu_torch.kernels.q4_gemm import q4_gemm_plain
    from lmrs_tpu_torch.kernels.q4_gemv import q4_gemv_plain
    from lmrs_tpu_torch.kernels.q8_gemm import dequant_bf16 as dequant_q8
    from lmrs_tpu_torch.kernels.q8_gemm import q8_gemm_plain
    from lmrs_tpu_torch.kernels.q8_gemv import q8_gemv_plain
    from lmrs_tpu_torch.kernels.q8_gemv_i8 import q8_gemv_i8_plain

    # kernel -> (wrapper, plain version, tolerance relative to the output
    # scale, bytes per activation value, peak rate of its operations,
    # products it does per multiply-add of the function).  GEMVs: f32 both
    # sides (A's three bf16 slices of x and D's integer dots are exact),
    # sums in another order: 1e-4.  GEMMs: the same bf16 operands,
    # tensor-core f32 accumulation in another order over K up to 14336:
    # 1e-3.  A multiplies each weight by the three slices of x on the
    # tensor cores.
    kernels = {
        "q4_gemv": (q4_gemv, q4_gemv_plain, 1e-4, 4, "bf16", 3),
        "q4_gemm": (q4_gemm, q4_gemm_plain, 1e-3, 2, "bf16", 1),
        "q8_gemv_i8": (q8_gemv_i8, q8_gemv_i8_plain, 1e-4, 4, "int8", 1),
        "q8_gemv": (q8_gemv, q8_gemv_plain, 1e-4, 4, "f32", 1),
        "q8_gemm": (q8_gemm, q8_gemm_plain, 1e-3, 2, "bf16", 1),
    }
    wbytes = 0.5 if quant == "q4" else 1.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for name, (o, k) in matmul_shapes(model).items():
        layer = name in LAYER_SHAPES
        if quant == "q4":
            q, s = random_q4(torch, gen, o, k)
            w_lib = dequant_q4(q, s, GS)        # library yardstick only
            plan = [("q4_gemv", t) for t in GEMV_T_A]
            plan += [("q4_gemm", t) for t in GEMM_T] if layer else []
        else:
            q, s = random_q8(torch, gen, o, k)
            w_lib = dequant_q8(q, s, GS)
            plan = [("q8_gemv_i8", t) for t in GEMV_T] if layer else []
            plan += [("q8_gemv", t) for t in GEMV_T]
            plan += [("q8_gemm", t) for t in GEMM_T] if layer else []
        clock = timer if timed else (lambda fn: None)
        for kern, t in plan:
            fn, plain_fn, tol_rel, xbytes, rate, per_mac = kernels[kern]
            x = torch.randn(t, k, device="cuda", generator=gen)
            if xbytes == 2:
                x = x.to(torch.bfloat16)
            run = lambda: fn(x, q, s, GS)                 # noqa: E731
            plain = lambda: plain_fn(x, q, s, GS)         # noqa: E731
            got, want = run(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{kern} {name} T={t}: non-finite output")
            err = (got - want).abs().max().item()
            tol = tol_rel * want.abs().max().item()
            xl = x.to(torch.bfloat16)
            lib = lambda: torch.matmul(xl, w_lib.t())   # noqa: E731
            nbytes = (wbytes * o * k + 4 * o * k / GS + xbytes * t * k
                      + 4 * t * o)
            b_ms, b_by = bound_ms(nbytes, 2.0 * per_mac * t * o * k,
                                  peak[rate], peak["mem"])
            # A at T = 8 is a row of its own in the kernels line
            row = "q4_gemv_t8" if kern == "q4_gemv" and t == 8 else kern
            case = dict(kernel=row, model=model["name"], shape=name, T=t,
                        O=o, K=k, max_abs_err=err, tol=tol,
                        err_over_tol=err / tol, ms=clock(run),
                        plain_ms=clock(plain), library_ms=clock(lib),
                        bound_ms=b_ms, bound_by=b_by)
            extra = ""
            if kern == "q8_gemv_i8" and timed:
                # second yardstick: the library's int8 product, x padded to
                # the 17 rows it takes at least (timed only)
                xi = torch.randint(-127, 128, (max(t, 17), k),
                                   dtype=torch.int8, device="cuda",
                                   generator=gen)
                qt = q.t()
                try:
                    torch._int_mm(xi, qt)
                    case["int_mm_ms"] = timer(lambda: torch._int_mm(xi, qt))
                    extra = f"  _int_mm {case['int_mm_ms']:.4f}"
                except RuntimeError:
                    case["int_mm_ms"] = None
                    extra = "  _int_mm n/a"
            if kern in ("q4_gemm", "q8_gemm"):
                check_gemm_exact(torch, kern, fn, q, s, name, t, gen)
            log(f"  {kern:10s} {name:10s} T={t:3d}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e})  kernel {fmt_ms(case['ms'])} ms  plain "
                f"{fmt_ms(case['plain_ms'])}  library "
                f"{fmt_ms(case['library_ms'])}{extra}  bound {b_ms:.4f} "
                f"({b_by})")
            if not err <= tol:
                raise RuntimeError(f"{kern} {name} T={t}: error {err} > {tol}")
            cases.append(case)
            del got, want
        del q, s, w_lib
        torch.cuda.empty_cache()
    return cases


def check_ffn_kernels(torch, timer, peak, model, quant, timed=True,
                      only=("ffn_fused_xe", "ffn_fused")):
    """K (T 1, 5, 8) and L (T 9, 12, 16) against their plain versions at one
    layer's FFN of `model` ("q4": Gemma-2-9B, tanh-GELU; "q8":
    Llama-3.2-3B, silu); returns per-case results.  Tolerance 1e-3 of the
    output scale: the same bf16 operands and exact products, f32 sums in
    another order, and a last-bit difference of the f32 gate or up flips a
    g value's bf16 rounding by one step (~2e-4 of the outputs at most).
    Library yardstick: the unfused chain in PyTorch calls, bf16 x through
    torch.matmul on pre-dequantized bf16 W13, the GLU, torch.matmul on
    bf16 W2.  Bound: the weight and scale bytes, f32 x in and y out, or
    the 2 T (2H D + D H) operations at the bf16 rate."""
    import torch.nn.functional as F

    from lmrs_tpu_torch.kernels import ffn_fused, ffn_fused_xe
    from lmrs_tpu_torch.kernels.ffn_fused import (ffn_fused_plain,
                                                  ffn_fused_xe_plain)
    from lmrs_tpu_torch.kernels.q4_gemm import dequant_bf16 as dequant_q4
    from lmrs_tpu_torch.kernels.q8_gemm import dequant_bf16 as dequant_q8

    d, h = model["D"], model["HID"]
    act = "gelu" if model["name"].startswith("gemma") else "silu"
    clock = timer if timed else (lambda fn: None)
    gen = torch.Generator(device="cuda").manual_seed(8)
    make = random_q4 if quant == "q4" else random_q8
    dequant = dequant_q4 if quant == "q4" else dequant_q8
    w = [*make(torch, gen, 2 * h, d), *make(torch, gen, d, h)]
    w13d, w2d = dequant(w[0], w[1], GS), dequant(w[2], w[3], GS)
    wbytes = (0.5 if quant == "q4" else 1.0) * 3 * h * d + 4 * 3 * h * d / GS

    def lib_chain(xb):
        gu = torch.matmul(xb, w13d.t())
        gate, up = gu[:, :h], gu[:, h:]
        a = F.gelu(gate, approximate="tanh") if act == "gelu" else F.silu(
            gate)
        return torch.matmul(a * up, w2d.t())

    cases = []
    for kern, (fn, plain_fn) in (("ffn_fused_xe", (ffn_fused_xe,
                                                   ffn_fused_xe_plain)),
                                 ("ffn_fused", (ffn_fused, ffn_fused_plain))):
        if kern not in only:
            continue
        for t in FFN_T[kern]:
            x = torch.randn(t, d, device="cuda", generator=gen)
            xb = x.to(torch.bfloat16)
            run = lambda: fn(x, *w, GS, act)              # noqa: E731
            plain = lambda: plain_fn(x, *w, GS, act)      # noqa: E731
            got, want = run(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{kern} {model['name']} T={t}: "
                                   f"non-finite output")
            err = (got - want).abs().max().item()
            tol = 1e-3 * want.abs().max().item()
            nbytes = wbytes + 4 * t * d + 4 * t * d
            b_ms, b_by = bound_ms(nbytes, 2.0 * t * 3 * h * d, peak["bf16"],
                                  peak["mem"])
            case = dict(kernel=kern, model=model["name"], shape="ffn", T=t,
                        D=d, H=h, act=act, max_abs_err=err, tol=tol,
                        err_over_tol=err / tol, ms=clock(run),
                        plain_ms=clock(plain),
                        library_ms=clock(lambda: lib_chain(xb)),
                        bound_ms=b_ms, bound_by=b_by)
            if kern == "ffn_fused_xe" and timed:
                # the timer's window holds host time for short calls: K's
                # two launches on the profiler's clock too, as the span from
                # the first one's start to the second one's end (device_ms;
                # the second is a programmatic dependent launch whose blocks
                # wait inside it, so the sum of the two, busy_ms, overstates
                # the call)
                case["busy_ms"], case["device_ms"] = profile_calls(
                    torch, run, ("ffn_xe_kernel",), timer.flush.zero_)
            log(f"  {kern:12s} {model['name']} ffn T={t:2d}: max_abs_err "
                f"{err:.3e} (tol {tol:.3e})  kernel {fmt_ms(case['ms'])} ms"
                + (f" (device span {case['device_ms']:.4f}, busy "
                   f"{case['busy_ms']:.4f})" if "device_ms" in case else "")
                + f"  plain {fmt_ms(case['plain_ms'])}  library "
                f"{fmt_ms(case['library_ms'])}  bound {b_ms:.4f} ({b_by})")
            if not err <= tol:
                raise RuntimeError(f"{kern} {model['name']} T={t}: error "
                                   f"{err} > {tol}")
            cases.append(case)
            del got, want
    del w, w13d, w2d
    torch.cuda.empty_cache()
    return cases


def cache_hd(model):
    """The head dim of `model`'s KV cache and attention kernels."""
    return model.get("CHD", model["HD"])


def head_rows(torch, model, lead, gen):
    """Random (*lead, head_dim) rows zero-padded to the cache head dim, as
    the model pads q, k and v (Phi)."""
    a = torch.randn(*lead, model["HD"], device="cuda", generator=gen)
    return torch.nn.functional.pad(a, (0, cache_hd(model) - model["HD"]))


def attention_work(t_q, pos, window):
    """(live key rows read, live (query, key) pairs per head) of one call:
    what this call's data needs under the causal mask and the window."""
    if window is None:
        window = pos + t_q
    first = max(pos - window, 0)
    rows = pos + t_q - first
    pairs = sum(min(pos + t, window) + 1 for t in range(t_q))
    return rows, pairs


def flash_cache(torch, model, cache, S=8192):
    """Random K/V rows of `model`'s attention geometry as one layer of a
    `cache`-type KV cache ("bf16", "f32", "int8" or "int4"; seed 1).
    Returns (kernel name, (wrapper, plain version, bound function), cache
    tensors as the wrapper takes them, bf16 (S, KH, HD) K and V for the
    library yardstick, bytes per cached row of K and V together)."""
    from lmrs_tpu_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_plain,
                                                        flash_attention_tol)
    from lmrs_tpu_torch.kernels.flash_attention_i4 import (
        flash_attention_i4, flash_attention_i4_plain, flash_attention_i4_tol)
    from lmrs_tpu_torch.kernels.flash_attention_i8 import (
        flash_attention_i8, flash_attention_i8_plain, flash_attention_i8_tol)
    from lmrs_tpu_torch.quant import (quantize_kv_rows, quantize_kv_rows_q4,
                                      unpack_kv_q4)

    KH, HD = model["KH"], cache_hd(model)
    gen = torch.Generator(device="cuda").manual_seed(1)
    kf = head_rows(torch, model, (S, KH), gen)
    vf = head_rows(torch, model, (S, KH), gen)
    if cache in ("int8", "int4"):
        quantize = quantize_kv_rows if cache == "int8" else quantize_kv_rows_q4
        rows, scales = quantize(torch.stack([kf, vf]))
        k, v = rows[0][None].contiguous(), rows[1][None].contiguous()
        ks, vs = (scales[i].t().contiguous()[None] for i in (0, 1))
        tensors = (k, v, ks, vs)
        # library yardstick reads the dequantized rows as bf16
        ints = ((k[0].reshape(S, KH, HD), v[0].reshape(S, KH, HD))
                if cache == "int8" else
                (unpack_kv_q4(k[0], KH, HD), unpack_kv_q4(v[0], KH, HD)))
        k_lib = (ints[0] * ks[0].t()[..., None]).to(torch.bfloat16)
        v_lib = (ints[1] * vs[0].t()[..., None]).to(torch.bfloat16)
        # K and V values (one or half a byte each) + scales
        row_bytes = 2 * (KH * HD // (1 if cache == "int8" else 2) + 4 * KH)
        if cache == "int8":
            return ("flash_attention_i8",
                    (flash_attention_i8, flash_attention_i8_plain,
                     flash_attention_i8_tol), tensors, k_lib, v_lib,
                    row_bytes)
        return ("flash_attention_i4",
                (flash_attention_i4, flash_attention_i4_plain,
                 flash_attention_i4_tol), tensors, k_lib, v_lib, row_bytes)
    dtype = torch.bfloat16 if cache == "bf16" else torch.float32
    k = kf.reshape(1, S, KH * HD).to(dtype)
    v = vf.reshape(1, S, KH * HD).to(dtype)
    return ("flash_attention" if cache == "bf16" else "flash_attention_f32",
            (flash_attention, flash_attention_plain, flash_attention_tol),
            (k, v), k[0].reshape(S, KH, HD).to(torch.bfloat16),
            v[0].reshape(S, KH, HD).to(torch.bfloat16),
            2 * KH * HD * (2 if cache == "bf16" else 4))


def flash_split():
    """(rows per split, the flash_merge module: the package's `flash_merge`
    name is kernel M's wrapper)."""
    import importlib

    fm = importlib.import_module("lmrs_tpu_torch.kernels.flash_merge")
    return fm.SPLIT, fm


def check_flash_kernel(torch, timer, peak, model, cache):
    """Kernel C (bf16 or f32 cache), G (int8 cache) or H (int4 cache) at
    `model`'s attention geometry, S = 8,192, T 1, 5 and 256 at pos 1,100
    and 6,000, against its plain version with the per-element bound of its
    bound function (flash_attention_tol and its int8 / int4 forms); then,
    untimed, T 1 and 5 with the last live row on and next to a split
    boundary (pos = 3*SPLIT - 1, 3*SPLIT) and, under a window, with the
    window's first row there (pos = window + 2*SPLIT - 1, + 2*SPLIT), each
    also with its position on the device (a (1,) int32 tensor) and host
    bounds up to 4 splits above it: bit for bit the host-position call."""
    import torch.nn.functional as F

    H, KH, HD, CHD = model["H"], model["KH"], model["HD"], cache_hd(model)
    window, softcap = model["WINDOW"], model["SOFTCAP"]
    name, fns, tensors, k_lib, v_lib, row_bytes = flash_cache(torch, model,
                                                              cache)
    kernel_fn, plain_fn, tol_fn = fns
    split, fm = flash_split()
    S = tensors[0].shape[1]
    gen = torch.Generator(device="cuda").manual_seed(2)
    kw = dict(n_kv=KH, scale=HD ** -0.5, softcap=softcap, window=window)
    cases = []
    edges = [3 * split - 1, 3 * split]
    if window is not None:
        edges += [window + 2 * split - 1, window + 2 * split]
    for pos in edges:
        for t_q in (1, 5):
            q = head_rows(torch, model, (t_q, H), gen)
            got = kernel_fn(q, *tensors, 0, pos, **kw)
            diff = (got - plain_fn(q, *tensors, 0, pos, **kw)).abs()
            tol = tol_fn(q, *tensors, 0, pos, **kw)
            ratio = torch.where(diff == 0, 0.0, diff / tol).max().item()
            log(f"  {name:19s} pos={pos:5d} T={t_q}: split boundary "
                f"({split} rows a split), worst err/tol {ratio:.3f}")
            if not ratio <= 1.0:
                raise RuntimeError(f"{name} T={t_q} pos={pos} (split "
                                   f"boundary): error {ratio} of the "
                                   f"tolerance")
            # the decode chunk's form: the position on the device, the
            # split axis sized from host bounds around it
            p_dev = torch.tensor([pos], dtype=torch.int32, device="cuda")
            for bounds in ((pos, pos), (pos, pos + 4 * split),
                           (pos - split, pos + 2 * split)):
                dev = kernel_fn(q, *tensors, 0, p_dev, pos_range=bounds,
                                **kw)
                if not torch.equal(dev, got):
                    raise RuntimeError(
                        f"{name} T={t_q} pos={pos}: the device position "
                        f"with bounds {bounds} differs from the host "
                        f"position by {(dev - got).abs().max().item()}")
            log(f"  {name:19s} pos={pos:5d} T={t_q}: device position "
                f"(bounds up to pos + {4 * split}) bit for bit the host's")
            cases.append(dict(kernel=name, model=model["name"],
                              shape=f"split edge pos{pos}", T=t_q,
                              max_abs_err=diff.max().item(),
                              err_over_tol=ratio,
                              device_position_bit_for_bit=True))
    for t_q in (1, 5, 256):
        for pos in (1100, 6000):
            q = head_rows(torch, model, (t_q, H), gen)
            run = lambda: kernel_fn(q, *tensors, 0, pos, **kw)    # noqa: E731
            plain = lambda: plain_fn(q, *tensors, 0, pos, **kw)   # noqa: E731
            got, want = run(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{name} T={t_q} pos={pos}: non-finite")
            # per-element bound that follows the softmax weights (2^-7 +
            # 2^-9 of the plain version on |v|; see flash_attention_tol)
            tol = tol_fn(q, *tensors, 0, pos, **kw)
            diff = (got - want).abs()
            # Phi's zero-padded head lanes: a bound of 0 met exactly
            # counts as 0
            err = diff.max().item()
            ratio = torch.where(diff == 0, 0.0, diff / tol).max().item()
            # library yardstick: SDPA over the same live rows, no softcap
            n = pos + t_q
            first = 0 if window is None else max(pos - window, 0)
            qs = q.to(torch.bfloat16).transpose(0, 1)[None]
            ksd = k_lib[first:n].transpose(0, 1)[None]
            vsd = v_lib[first:n].transpose(0, 1)[None]
            qp = pos + torch.arange(t_q, device="cuda")[:, None]
            kp = first + torch.arange(n - first, device="cuda")[None, :]
            mask = kp <= qp
            if window is not None:
                mask = mask & (qp - kp <= window)
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                qs, ksd, vsd, attn_mask=mask, enable_gqa=True)
            rows_read, pairs = attention_work(t_q, pos, window)
            nbytes = rows_read * row_bytes + 2 * t_q * H * CHD * 4
            flops = 4.0 * pairs * H * CHD
            b_ms, b_by = bound_ms(nbytes, flops, peak["bf16"], peak["mem"])
            # the grid: query blocks x kv heads x splits (1: unsplit)
            splits = (fm.n_splits_host(pos, t_q, S, window, split)
                      if split and H // KH * t_q <= fm.BQ else 1)
            case = dict(kernel=name, model=model["name"], shape=f"pos{pos}",
                        T=t_q, max_abs_err=err, tol_min=tol.min().item(),
                        err_over_tol=ratio, ms=timer(run),
                        plain_ms=timer(plain), library_ms=timer(lib),
                        bound_ms=b_ms, bound_by=b_by,
                        blocks=((H // KH * t_q + 63) // 64) * KH * splits,
                        splits=splits)
            log(f"  {name:19s} pos={pos:5d} T={t_q:3d}: max_abs_err "
                f"{err:.3e} (worst err/tol {ratio:.3f}, tol >= "
                f"{case['tol_min']:.3e})  kernel {case['ms']:.4f} ms  "
                f"plain {case['plain_ms']:.4f}  library "
                f"{case['library_ms']:.4f}  bound {b_ms:.4f} ({b_by})  "
                f"blocks {case['blocks']}, splits {splits}")
            if not ratio <= 1.0:
                raise RuntimeError(f"{name} T={t_q} pos={pos}: error {ratio} "
                                   f"of the tolerance")
            cases.append(case)
    return cases


def check_row_independence(torch):
    """Does a row of a T = 5 call equal, bit for bit, the same row computed
    alone (T = 1)?  Speculative greedy decoding is exact where every
    kernel of the verify forward says yes.  K at both models' FFN, the
    T <= 8 matmul kernels on Llama-3.2-3B's wqkv shape (A on Gemma-2-9B's
    wqkv and w2, at T = 5 and 8), the flash kernels at their models'
    geometry, pos 1,100.  Returns kernel -> bool; a "no" is a finding to
    record, not a failure, but for A and K, whose designs promise it
    (main() fails on it)."""
    from lmrs_tpu_torch.kernels import ffn_fused_xe, q4_gemv, q8_gemv
    from lmrs_tpu_torch.kernels import q8_gemv_i8

    gen = torch.Generator(device="cuda").manual_seed(3)
    same = {}
    for model, make, act in ((GEMMA, random_q4, "gelu"),
                             (LLAMA, random_q8, "silu")):
        d, h = model["D"], model["HID"]
        w = [*make(torch, gen, 2 * h, d), *make(torch, gen, d, h)]
        x = torch.randn(5, d, device="cuda", generator=gen)
        whole = ffn_fused_xe(x, *w, GS, act)
        rows = torch.cat([ffn_fused_xe(x[i:i + 1].contiguous(), *w, GS, act)
                          for i in range(5)])
        same[f"ffn_fused_xe ({model['name']})"] = torch.equal(whole, rows)
        del w
    for name, fn, make, model, shape, t in (
            ("q4_gemv", q4_gemv, random_q4, GEMMA, "wqkv", 5),
            ("q4_gemv", q4_gemv, random_q4, GEMMA, "wqkv", 8),
            ("q4_gemv", q4_gemv, random_q4, GEMMA, "w2", 5),
            ("q4_gemv", q4_gemv, random_q4, GEMMA, "w2", 8),
            ("q8_gemv_i8", q8_gemv_i8, random_q8, LLAMA, "wqkv", 5),
            ("q8_gemv_i8", q8_gemv_i8, random_q8, LLAMA, "wqkv", 8),
            ("q8_gemv_i8", q8_gemv_i8, random_q8, LLAMA, "wo", 5),
            ("q8_gemv_i8", q8_gemv_i8, random_q8, LLAMA, "wo", 8),
            ("q8_gemv", q8_gemv, random_q8, LLAMA, "wqkv", 5)):
        o, k = matmul_shapes(model)[shape]
        q, s = make(torch, gen, o, k)
        x = torch.randn(t, k, device="cuda", generator=gen)
        whole = fn(x, q, s, GS)
        rows = torch.cat([fn(x[i:i + 1].contiguous(), q, s, GS)
                          for i in range(t)])
        key = (f"{name} ({shape}, T={t})"
               if name in ("q4_gemv", "q8_gemv_i8") else name)
        same[key] = torch.equal(whole, rows)
    pos = 1100
    for model, cache in ((GEMMA, "bf16"), (LLAMA, "f32"), (LLAMA, "int8"),
                         (GEMMA, "int4"), (LLAMA, "int4")):
        name, (fn, _, _), tensors, _, _, _ = flash_cache(torch, model, cache,
                                                         S=2048)
        kw = dict(n_kv=model["KH"], scale=model["HD"] ** -0.5,
                  softcap=model["SOFTCAP"], window=model["WINDOW"])
        q = torch.randn(5, model["H"], model["HD"], device="cuda",
                        generator=gen)
        whole = fn(q, *tensors, 0, pos, **kw)
        rows = torch.cat([fn(q[i:i + 1].contiguous(), *tensors, 0, pos + i,
                             **kw) for i in range(5)])
        same[f"{name} ({model['name']})"] = torch.equal(whole, rows)
    torch.cuda.synchronize()
    for name, ok in same.items():
        log(f"  {name}: a row of the call "
            f"{'equals' if ok else 'DIFFERS from'} the row alone")
    return same


def batched_cache(torch, model, cache, pos, S=6144, seed=4):
    """Random K/V rows of `model`'s geometry for len(pos) slots as one layer
    of a per-slot cache (B, 1, S, row) of `cache` type ("bf16", "f32",
    "int8" or "int4"; int4 only feeds a pool); scales (B, 1, KH, S) for
    the integer caches.  Returns (k, v, ks, vs), the bf16 dequantized rows
    (B, S, KH, HD) of K and V for the library yardstick, bytes per cached
    row of K and V together."""
    from lmrs_tpu_torch.quant import (quantize_kv_rows, quantize_kv_rows_q4,
                                      unpack_kv_q4)

    KH, HD = model["KH"], cache_hd(model)
    b = len(pos)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kv = head_rows(torch, model, (2, b, S, KH), gen)
    if cache in ("int8", "int4"):
        quantize = quantize_kv_rows if cache == "int8" else quantize_kv_rows_q4
        rows, sc = quantize(kv)                   # (2,B,S,row), (2,B,S,KH)
        k, v = (rows[i][:, None].contiguous() for i in (0, 1))
        ks, vs = (sc[i].permute(0, 2, 1)[:, None].contiguous()
                  for i in (0, 1))
        ints = [r.reshape(b, S, KH, HD).float() if cache == "int8"
                else unpack_kv_q4(r, KH, HD) for r in rows]
        lib = [(ints[i] * sc[i][..., None]).to(torch.bfloat16)
               for i in (0, 1)]
        row_bytes = 2 * (KH * HD // (1 if cache == "int8" else 2) + 4 * KH)
        return (k, v, ks, vs), lib, row_bytes
    dtype = torch.bfloat16 if cache == "bf16" else torch.float32
    k, v = (kv[i].reshape(b, 1, S, KH * HD).to(dtype) for i in (0, 1))
    lib = [kv[i].to(dtype).to(torch.bfloat16) for i in (0, 1)]
    return ((k, v, None, None), lib,
            2 * KH * HD * (2 if cache == "bf16" else 4))


def to_pool(torch, contig, psz, live, seed=5):
    """The per-slot cache's rows in a pool of psz-row pages behind a
    shuffled (B, maxp) page table; page 0, the trash page, holds NaN (the
    byte 0x77 and NaN scales for an integer pool), and table entries past
    the page of slot b's last live row (live[b] - 1) point at it, as the
    scheduler's do.  Returns (k_pool, v_pool, table, ks_pool, vs_pool)."""
    k, v, ks, vs = contig
    b, _, S, row = k.shape
    maxp = -(-S // psz)
    n_pages = 1 + b * maxp
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
             + 1).reshape(b, maxp).to(torch.int32)
    flat = table.reshape(-1).long()

    def pool(a):
        padded = torch.zeros((b, maxp * psz, row), dtype=a.dtype,
                             device="cuda")
        padded[:, :S] = a[:, 0]
        bad = 0x77 if a.dtype == torch.int8 else float("nan")
        out = torch.full((1, n_pages, psz, row), bad, dtype=a.dtype,
                         device="cuda")
        out[0, flat] = padded.reshape(b * maxp, psz, row)
        return out

    def planes(s):
        if s is None:
            return None
        kh = s.shape[2]
        padded = torch.zeros((b, kh, maxp * psz), device="cuda")
        padded[..., :S] = s[:, 0]
        out = torch.full((1, n_pages, kh, psz), float("nan"), device="cuda")
        out[0, flat] = padded.reshape(b, kh, maxp, psz).permute(
            0, 2, 1, 3).reshape(b * maxp, kh, psz)
        return out

    out = pool(k), pool(v), table, planes(ks), planes(vs)
    for i, n in enumerate(live):
        table[i, -(-n // psz):] = 0
    return out


def single_flash(q, k, v, ks, vs, pos, kw):
    """Kernel C, G or H on one slot's (1, S, row) layer."""
    from lmrs_tpu_torch.kernels.flash_attention import flash_attention
    from lmrs_tpu_torch.kernels.flash_attention_i4 import flash_attention_i4
    from lmrs_tpu_torch.kernels.flash_attention_i8 import flash_attention_i8

    if ks is None:
        return flash_attention(q, k, v, 0, pos, **kw)
    packed4 = 2 * k.shape[-1] == kw["n_kv"] * q.shape[-1]
    fn = flash_attention_i4 if packed4 else flash_attention_i8
    return fn(q, k, v, ks, vs, 0, pos, **kw)


def check_batched_kernels(torch, timer, peak, model, cache):
    """Kernels I (per-slot cache; not int4) and J (pool; pages of 512 and
    of 56 rows) at `model`'s attention geometry, B = 8 slots at BATCH_POS,
    T 1 and 5, against their plain versions with the per-element bound of
    flash_attention_batched_tol / flash_attention_paged_tol.  Bit for bit:
    each slot equals C / G / H on its own rows (the same walk), J equals I
    on a pool holding I's rows, and slot 3 is unchanged when every other
    slot, its pages and the trash page hold NaN.  Timed (kernel, plain,
    library) at the 512-row pages and the per-slot cache."""
    import torch.nn.functional as F

    from lmrs_tpu_torch.kernels.flash_attention_batched import (
        flash_attention_batched, flash_attention_batched_plain,
        flash_attention_batched_tol)
    from lmrs_tpu_torch.kernels.flash_attention_paged import (
        flash_attention_paged, flash_attention_paged_plain,
        flash_attention_paged_tol)

    H, KH, HD, CHD = model["H"], model["KH"], model["HD"], cache_hd(model)
    window, softcap = model["WINDOW"], model["SOFTCAP"]
    kw = dict(n_kv=KH, scale=HD ** -0.5, softcap=softcap, window=window)
    b = len(BATCH_POS)
    contig, lib_rows, row_bytes = batched_cache(torch, model, cache,
                                                BATCH_POS)
    k, v, ks, vs = contig
    sc = dict(k_scale=ks, v_scale=vs)
    live = [p + 5 for p in BATCH_POS]           # rows of a T = 5 call
    pools = {psz: to_pool(torch, contig, psz, live)
             for psz in (512, SMALL_PAGE)}
    split, fm = flash_split()
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = []
    for t_q in (1, 5):
        # the split axis of each layout (sized from S: no host position)
        splits = {"per-slot": fm.n_splits_device(k.shape[2], t_q, window,
                                                 split)}
        for psz, pool in pools.items():
            splits[f"page{psz}"] = fm.n_splits_device(
                pool[2].shape[1] * psz, t_q, window, split)
        q = head_rows(torch, model, (b, t_q, H), gen)
        pos = torch.tensor(BATCH_POS, dtype=torch.int32, device="cuda")
        runs = []
        if cache != "int4":
            runs.append(("flash_attention_batched", "per-slot",
                         lambda: flash_attention_batched(q, k, v, 0, pos,
                                                         **kw, **sc),
                         lambda: flash_attention_batched_plain(
                             q, k, v, 0, pos, **kw, **sc),
                         lambda: flash_attention_batched_tol(
                             q, k, v, 0, pos, **kw, **sc)))
        for psz, (kp, vp, table, pks, pvs) in pools.items():
            psc = dict(k_scale=pks, v_scale=pvs)
            runs.append((
                "flash_attention_paged", f"page{psz}",
                lambda kp=kp, vp=vp, table=table, psc=psc:
                    flash_attention_paged(q, kp, vp, table, 0, pos, **kw,
                                          **psc),
                lambda kp=kp, vp=vp, table=table, psc=psc:
                    flash_attention_paged_plain(q, kp, vp, table, 0, pos,
                                                **kw, **psc),
                lambda kp=kp, vp=vp, table=table, psc=psc:
                    flash_attention_paged_tol(q, kp, vp, table, 0, pos,
                                              **kw, **psc)))
        # work: live rows and (query, key) pairs of each slot
        rows_read = pairs = 0
        for p in BATCH_POS:
            r, pr = attention_work(t_q, p, window)
            rows_read, pairs = rows_read + r, pairs + pr
        nbytes = rows_read * row_bytes + 2 * b * t_q * H * CHD * 4
        b_ms, b_by = bound_ms(nbytes, 4.0 * pairs * H * CHD, peak["bf16"],
                              peak["mem"])
        # library yardstick: SDPA over each slot's live rows, gathered into
        # a padded (B, KH, S_max, HD) bf16 tensor with a boolean mask
        first = torch.tensor([0 if window is None else max(p - window, 0)
                              for p in BATCH_POS], device="cuda")
        n_live = pos.long() + t_q - first
        s_max = int(n_live.max())
        j = torch.arange(s_max, device="cuda")
        idx = (first[:, None] + j).clamp(max=lib_rows[0].shape[1] - 1)
        ar = torch.arange(b, device="cuda")[:, None]
        kl, vl = (r[ar, idx].transpose(1, 2).contiguous() for r in lib_rows)
        qp = pos.long()[:, None] + torch.arange(t_q, device="cuda")
        kpos = first[:, None] + j
        mask = (kpos[:, None] <= qp[..., None]) & \
            (j[None, None] < n_live[:, None, None])
        if window is not None:
            mask = mask & (qp[..., None] - kpos[:, None] <= window)
        qs = q.to(torch.bfloat16).transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
            qs, kl, vl, attn_mask=mask[:, None], enable_gqa=True)
        got_i = None
        for name, shape, run, plain, tol_fn in runs:
            got, want = run(), plain()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{name} {shape} T={t_q}: non-finite")
            tol = tol_fn()
            diff = (got - want).abs()
            # a slot with one live row (pos 0) has output channels whose
            # values quantize to 0: a bound of 0 met exactly counts as 0
            err = diff.max().item()
            ratio = torch.where(diff == 0, 0.0, diff / tol).max().item()
            same_single = all(torch.equal(
                got[i], single_flash(q[i], k[i], v[i],
                                     None if ks is None else ks[i],
                                     None if vs is None else vs[i],
                                     BATCH_POS[i], kw)) for i in range(b))
            if name == "flash_attention_batched":
                got_i = got
            same_i = got_i is None or torch.equal(got, got_i)
            # slot independence: NaN in every other slot and page
            if name == "flash_attention_batched":
                k2, v2 = k.clone(), v.clone()
                others = [i for i in range(b) if i != 3]
                k2[others] = float("nan") if k.dtype != torch.int8 else 0x77
                v2[others] = float("nan") if v.dtype != torch.int8 else 0x77
                extra = {}
                if ks is not None:
                    ks2, vs2 = ks.clone(), vs.clone()
                    ks2[others] = vs2[others] = float("nan")
                    extra = dict(k_scale=ks2, v_scale=vs2)
                bad = flash_attention_batched(q, k2, v2, 0, pos, **kw,
                                              **(extra or sc))
            else:
                psz = int(shape[len("page"):])
                kp, vp, table, pks, pvs = pools[psz]
                mine = table[3].long()
                keep = torch.zeros(kp.shape[1], dtype=torch.bool,
                                   device="cuda")
                keep[mine] = True
                kp2, vp2 = kp.clone(), vp.clone()
                fill = float("nan") if kp.dtype != torch.int8 else 0x77
                kp2[:, ~keep] = fill
                vp2[:, ~keep] = fill
                psc2 = dict(k_scale=pks, v_scale=pvs)
                if pks is not None:
                    pks2, pvs2 = pks.clone(), pvs.clone()
                    pks2[:, ~keep] = pvs2[:, ~keep] = float("nan")
                    psc2 = dict(k_scale=pks2, v_scale=pvs2)
                bad = flash_attention_paged(q, kp2, vp2, table, 0, pos, **kw,
                                            **psc2)
            independent = torch.equal(bad[3], got[3])
            case = dict(kernel=name, model=model["name"], cache=cache,
                        shape=f"{cache} {shape}", T=t_q, B=b,
                        max_abs_err=err,
                        tol_min=tol.min().item(), err_over_tol=ratio,
                        same_as_single=same_single, same_as_i=same_i,
                        slot_independent=independent, bound_ms=b_ms,
                        bound_by=b_by, blocks=((H // KH * t_q + 63) // 64)
                        * KH * b * splits[shape], splits=splits[shape])
            if shape != f"page{SMALL_PAGE}":
                case.update(ms=timer(run), plain_ms=timer(plain),
                            library_ms=timer(lib))
                times = (f"kernel {case['ms']:.4f} ms  plain "
                         f"{case['plain_ms']:.4f}  library "
                         f"{case['library_ms']:.4f}  ")
            else:
                times = ""
            log(f"  {name:23s} {model['name']} {cache:4s} {shape:8s} "
                f"T={t_q}: err/tol {ratio:.3f}  same as C/G/H "
                f"{same_single}  same as I {same_i}  slot-independent "
                f"{independent}  {times}bound {b_ms:.4f} ({b_by})  "
                f"blocks {case['blocks']}, splits {splits[shape]}")
            if not (ratio <= 1.0 and same_single and same_i and independent):
                raise RuntimeError(f"{name} {model['name']} {cache} {shape} "
                                   f"T={t_q} failed its checks: {case}")
            cases.append(case)
            del got, want, tol, diff, bad
        del kl, vl
    del contig, pools
    torch.cuda.empty_cache()
    return cases


def check_batched_row_independence(torch):
    """Row independence for I and J: a slot's row t of a T = 5 call equals
    the row computed alone at pos + t (Gemma bf16 per-slot and paged,
    Llama int4 paged)."""
    from lmrs_tpu_torch.kernels.flash_attention_batched import \
        flash_attention_batched
    from lmrs_tpu_torch.kernels.flash_attention_paged import \
        flash_attention_paged

    gen = torch.Generator(device="cuda").manual_seed(7)
    same = {}
    pos_l = [0, 700, 1500, 2000]
    for model, cache in ((GEMMA, "bf16"), (LLAMA, "int4")):
        contig, _, _ = batched_cache(torch, model, cache, pos_l, S=2048)
        kw = dict(n_kv=model["KH"], scale=model["HD"] ** -0.5,
                  softcap=model["SOFTCAP"], window=model["WINDOW"])
        q = torch.randn(len(pos_l), 5, model["H"], model["HD"],
                        device="cuda", generator=gen)
        kp, vp, table, pks, pvs = to_pool(torch, contig, 512,
                                          [p + 5 for p in pos_l])
        fns = {"flash_attention_paged": lambda q, p: flash_attention_paged(
            q, kp, vp, table, 0, p, k_scale=pks, v_scale=pvs, **kw)}
        if cache != "int4":
            k, v, _, _ = contig
            fns["flash_attention_batched"] = \
                lambda q, p: flash_attention_batched(q, k, v, 0, p, **kw)
        for name, fn in fns.items():
            p = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
            whole = fn(q, p)
            rows = torch.cat([fn(q[:, i:i + 1].contiguous(), p + i)
                              for i in range(5)], dim=1)
            same[f"{name} ({model['name']}, {cache})"] = torch.equal(whole,
                                                                     rows)
    torch.cuda.synchronize()
    for name, ok in same.items():
        log(f"  {name}: rows of a T=5 call {'equal' if ok else 'DIFFER from'}"
            f" the rows alone")
    return same


MASK_NEG = -3.4028234663852886e38     # float32 min: the JAX _MASK_NEG
N_SHARDS = 4


def cut_shards(k, v, ks=None, vs=None, n_shards=N_SHARDS):
    """The `n_shards` sequence shards of a per-slot cache (B, L, S, row),
    scales (B, L, KH, S): (seq_base, k, v, k_scale, v_scale) of each, cut
    once into contiguous tensors."""
    shard = k.shape[2] // n_shards

    def cut(a, axis, i):        # rows on axis 2, scales on 3
        return None if a is None else \
            a.narrow(axis, i * shard, shard).contiguous()
    return [(i * shard, cut(k, 2, i), cut(v, 2, i), cut(ks, 3, i),
             cut(vs, 3, i)) for i in range(n_shards)]


def shard_calls(q, shards, pos, kw, plain=False):
    """B1 on each shard of `cut_shards`: flash_attention_batched(...,
    seq_base=, return_lse=True), or its plain version -> [(acc, m, l)]."""
    from lmrs_tpu_torch.kernels.flash_attention_batched import (
        flash_attention_batched, flash_attention_batched_plain)

    fn = flash_attention_batched_plain if plain else flash_attention_batched
    return [fn(q, k, v, 0, pos, k_scale=ks, v_scale=vs, seq_base=base,
               return_lse=True, **kw) for base, k, v, ks, vs in shards]


def sharded_lse(torch, q, shards, pos, kw, plain=False):
    """The shards' (acc, m, l), stacked along a new axis 1 as kernel M
    takes them."""
    parts = shard_calls(q, shards, pos, kw, plain)
    return tuple(torch.stack([p[j] for p in parts], dim=1) for j in range(3))


def check_cp_partials(torch, timer, peak, model, n_shards=N_SHARDS,
                      timed=True):
    """B1, the cp partials form of kernel I, at `model`'s geometry: phase
    2's per-slot bf16 cache (8 slots at BATCH_POS, S = 6,144) cut into
    `n_shards` shards (4 of 1,536 rows; 2 of 3,072 put Gemma's window edge
    inside shard 0 for the slots past 4,096), T 1 and 5.  Each shard's raw pieces against the
    plain version (acc within `flash_attention_batched_tol(...,
    return_lse=True)` on rows with a live key, m within 1e-5, l within
    1e-4 relative; m == _MASK_NEG exactly where the shard holds no live
    key, which must happen: slot 0 at pos 0 never reaches shards 1-3), then
    the shards merged by kernel M against kernel I on the whole cache and
    against the plain version, within I's bound (two levels of merge round
    differently: not bit for bit).  Timed at T = 1: the four shard calls,
    on shards cut once before the timer."""
    from lmrs_tpu_torch.kernels.flash_attention_batched import (
        flash_attention_batched, flash_attention_batched_plain,
        flash_attention_batched_tol)
    from lmrs_tpu_torch.kernels.flash_merge import flash_merge

    H, KH, HD = model["H"], model["KH"], model["HD"]
    window = model["WINDOW"]
    kw = dict(n_kv=KH, scale=HD ** -0.5, softcap=model["SOFTCAP"],
              window=window)
    b = len(BATCH_POS)
    (k, v, _, _), _, row_bytes = batched_cache(torch, model, "bf16",
                                               BATCH_POS)
    pos = torch.tensor(BATCH_POS, dtype=torch.int32, device="cuda")
    shards = cut_shards(k, v, n_shards=n_shards)
    gen = torch.Generator(device="cuda").manual_seed(9)
    cases = []
    for t_q in (1, 5):
        q = torch.randn(b, t_q, H, HD, device="cuda", generator=gen)
        acc, m, l = sharded_lse(torch, q, shards, pos, kw)
        pacc, pm, pl = sharded_lse(torch, q, shards, pos, kw, plain=True)
        tol = torch.stack([flash_attention_batched_tol(
            q, ks, vs, 0, pos, seq_base=base, return_lse=True, **kw)
            for base, ks, vs, _, _ in shards], dim=1)
        torch.cuda.synchronize()
        live = pm != MASK_NEG
        ratio = ((acc - pacc).abs() / tol)[live].max().item()
        ok = (torch.equal(m == MASK_NEG, ~live) and ratio <= 1.0
              and ((m - pm).abs() <= 1e-5)[live].all().item()
              and ((l - pl).abs() <= 1e-4 * pl)[live].all().item()
              and (acc[~live] == 0).all().item()
              and (l[~live] == 0).all().item()
              and (m[0, 1:] == MASK_NEG).all().item())
        merged = flash_merge(acc, m, l)
        got_i = flash_attention_batched(q, k, v, 0, pos, **kw)
        want = flash_attention_batched_plain(q, k, v, 0, pos, **kw)
        tol_i = flash_attention_batched_tol(q, k, v, 0, pos, **kw)
        torch.cuda.synchronize()
        r_i = ((merged - got_i).abs() / tol_i).max().item()
        r_plain = ((merged - want).abs() / tol_i).max().item()
        dead = int((~live).sum())
        log(f"  flash_attention_batched_lse {model['name']} bf16 "
            f"{n_shards} shards T={t_q}: shards vs plain: acc err/tol "
            f"{ratio:.3f}, {dead} rows with no live key at m == _MASK_NEG "
            f"{ok}; merged by M vs I err/tol {r_i:.3f}, vs plain "
            f"{r_plain:.3f}")
        if not (ok and r_i <= 1.0 and r_plain <= 1.0):
            raise RuntimeError(f"B1 {model['name']} T={t_q}: shards ok "
                               f"{ok}, merged vs I {r_i}, vs plain "
                               f"{r_plain}")
        case = dict(kernel="flash_attention_batched_lse",
                    model=model["name"], shape=f"bf16 {n_shards} shards",
                    T=t_q, B=b, max_abs_err=(acc - pacc).abs()[live].max()
                    .item(), err_over_tol=ratio,
                    merged_vs_i_err_over_tol=r_i,
                    merged_vs_plain_err_over_tol=r_plain,
                    rows_without_live_key=dead)
        if t_q == 1 and timed:
            rows_read = pairs = 0
            for p in BATCH_POS:
                r, pr = attention_work(t_q, p, window)
                rows_read, pairs = rows_read + r, pairs + pr
            # live rows once, q once per shard, the shards' acc, m and l
            nbytes = (rows_read * row_bytes
                      + N_SHARDS * b * t_q * H * (2 * HD + 2) * 4)
            b_ms, b_by = bound_ms(nbytes, 4.0 * pairs * H * HD,
                                  peak["bf16"], peak["mem"])
            case.update(
                ms=timer(lambda: shard_calls(q, shards, pos, kw)),
                plain_ms=timer(lambda: shard_calls(q, shards, pos, kw,
                                                   plain=True)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)
            log(f"    timed: kernel {case['ms']:.4f} ms (4 shard calls)  "
                f"plain {case['plain_ms']:.4f}  bound {b_ms:.4f} ({b_by})")
        cases.append(case)
    del k, v, shards
    torch.cuda.empty_cache()
    return cases


def check_merge(torch, timer, peak, model):
    """Kernel M against its plain version on the workspaces the main path
    gives it: the split pass of C at `model`'s geometry (bf16 cache, S =
    8,192, T = 1 at pos 6,000) and of I (8 slots at BATCH_POS), within
    `flash_merge_tol`, raw and normalized.  Timed on C's workspace."""
    from lmrs_tpu_torch.kernels.flash_merge import (flash_merge,
                                                    flash_merge_plain,
                                                    flash_merge_tol)

    H, KH, HD = model["H"], model["KH"], model["HD"]
    window, softcap = model["WINDOW"], model["SOFTCAP"]
    split, fm = flash_split()
    kw = dict(n_kv=KH, scale=HD ** -0.5, softcap=softcap, window=window)
    gen = torch.Generator(device="cuda").manual_seed(10)
    _, _, tensors, _, _, _ = flash_cache(torch, model, "bf16")
    S = tensors[0].shape[1]
    (k, v, _, _), _, _ = batched_cache(torch, model, "bf16", BATCH_POS)
    b = len(BATCH_POS)
    pos_b = torch.tensor(BATCH_POS, dtype=torch.int32, device="cuda")
    common = dict(n_kv=KH, row=KH * HD, seq_base=0, table=None, maxp=0,
                  psz=0, split=split, scale=kw["scale"], softcap=softcap,
                  window=window, ctype=fm.BF16, what="split pass")
    work = {
        "pos6000": fm.split_pass(
            torch.randn(1, 1, H, HD, device="cuda", generator=gen),
            tensors[0][0], tensors[1][0], None, None, s_len=S, pos=6000,
            slot_stride=0, scale_slot_stride=0,
            n_split=fm.n_splits_host(6000, 1, S, window, split),
            **common),
        "8 slots": fm.split_pass(
            torch.randn(b, 1, H, HD, device="cuda", generator=gen),
            k[0, 0], v[0, 0], None, None, s_len=k.shape[2], pos=pos_b,
            slot_stride=k.shape[2] * KH * HD, scale_slot_stride=0,
            n_split=fm.n_splits_device(k.shape[2], 1, window, split),
            **common)}
    cases = []
    for shape, (acc, m, l) in work.items():
        ratios = []
        for raw in (False, True):
            got = flash_merge(acc, m, l, raw=raw)
            want = flash_merge_plain(acc, m, l, raw=raw)
            tol = flash_merge_tol(acc, m, l, raw=raw)
            g0, w0 = (got[0], want[0]) if raw else (got, want)
            torch.cuda.synchronize()
            diff = (g0 - w0).abs()
            ratios.append(torch.where(diff == 0, 0.0, diff / tol).max()
                          .item())
            if raw and not torch.equal(got[1], want[1]):
                ratios.append(float("inf"))
        ratio = max(ratios)
        live = int((m != float("-inf")).sum())
        n = m.shape[1]
        case = dict(kernel="flash_merge", model=model["name"], shape=shape,
                    T=1, splits=n, live_split_rows=live,
                    max_abs_err=(flash_merge(acc, m, l)
                                 - flash_merge_plain(acc, m, l)).abs().max()
                    .item(), err_over_tol=ratio)
        # live splits' acc and l, every split's m, the output
        nbytes = 4 * (live * (HD + 1) + m.numel() + acc.shape[0] * H * HD)
        b_ms, b_by = bound_ms(nbytes, 2.0 * live * HD, peak["f32"],
                              peak["mem"])
        case.update(ms=timer(lambda: flash_merge(acc, m, l)),
                    plain_ms=timer(lambda: flash_merge_plain(acc, m, l)),
                    library_ms=None, bound_ms=b_ms, bound_by=b_by)
        case["device_ms"], _ = profile_calls(
            torch, lambda: flash_merge(acc, m, l), ("flash_merge_kernel",),
            timer.flush.zero_, settle=True)
        log(f"  flash_merge {model['name']} {shape} ({n} splits, {live} "
            f"live split rows): worst err/tol {ratio:.3f}  kernel "
            f"{case['ms']:.4f} ms (device {case['device_ms']:.4f})  plain "
            f"{case['plain_ms']:.4f}  bound {b_ms:.4f} ({b_by})")
        if not ratio <= 1.0:
            raise RuntimeError(f"flash_merge {shape}: {ratio} of the "
                               f"tolerance")
        cases.append(case)
    del work, k, v, tensors
    torch.cuda.empty_cache()
    return cases


SMOKE_WORDS = ("hello", " from", " the", " smoke", " run", " card")


def synthetic_tokenizer(path: Path, vocab_size: int, merges: bool = False):
    """A tokenizer.bin of `vocab_size` tokens: specials, byte tokens, the
    smoke words (score 1) and fillers.  With `merges`, the words' single
    characters and every shorter prefix of each word come before the
    fillers, scored by length, so that encoding a text of the words merges
    character by character up to whole words."""
    from lmrs_tpu_torch.tokenizer import Tokenizer

    vocab = ["<pad>", "<eos>", "<bos>"] + [f"<0x{b:02X}>" for b in range(256)]
    vocab += SMOKE_WORDS
    scores = [0.0] * len(vocab)
    scores[259:] = [1.0] * len(SMOKE_WORDS)
    if merges:
        pieces = dict.fromkeys([c for w in SMOKE_WORDS for c in w]
                               + [w[:n] for w in SMOKE_WORDS
                                  for n in range(2, len(w))])
        vocab += pieces
        scores += [len(p) / 10 for p in pieces]
    vocab += [f"<tok{i}>" for i in range(vocab_size - len(vocab))]
    scores += [0.0] * (vocab_size - len(scores))
    Tokenizer(vocab, scores, bos=2, eos=1, native=False).save(str(path))


def drive_main_path(torch, label, cfg, params, cache_dtype, expect):
    """One main path: Engine.generate greedy on a 1,024-token prompt for 64
    new tokens twice across reset() (identical tokens), then one top-p
    generation, with the launch counts set to 0 just before and read just
    after: the decode runs in chunks of 8 steps (the Engine's default).
    Exactly the kernels of `expect` must have launched.  Then
    `chunk_checks`.  Returns (the launch counts and the runs' metrics, the
    engine, the prompt, the greedy tokens)."""
    from lmrs_tpu_torch.kernels import launches, reset_launches
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

    vocab = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(cfg, params, cache_dtype=cache_dtype)
    rng = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, vocab, (1024,), generator=rng).tolist()
    greedy = GenerationConfig(temperature=0.0, max_new_tokens=64)
    reset_launches()
    runs = []
    toks_a = engine.generate(prompt, greedy)
    runs.append(("greedy", engine.metrics))
    engine.reset()
    toks_b = engine.generate(prompt, greedy)
    runs.append(("greedy again", engine.metrics))
    engine.reset()
    toks_p = engine.generate(prompt, GenerationConfig(
        temperature=0.7, top_p=0.9, seed=0, max_new_tokens=64))
    runs.append(("top-p", engine.metrics))
    torch.cuda.synchronize()
    counts = launches()
    if toks_a != toks_b:
        raise RuntimeError(f"{label}: greedy generation differs across "
                           f"reset()")
    if len(toks_a) != 64 or len(toks_p) != 64 or not all(
            0 <= t < vocab for t in toks_a + toks_p):
        raise RuntimeError(f"{label}: invalid generated tokens")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {label}: peak memory {peak_gb:.2f} GB, launches {counts}")
    for name, m in runs:
        log(f"    {name}: TTFT {1e3 * m.ttft_seconds:.1f} ms, prefill "
            f"{m.prefill_tokens_per_second:.1f} tok/s, decode "
            f"{m.tokens_per_second:.2f} tok/s ({m.decode_tokens} tokens)")
    log(f"    greedy tokens {toks_a[:12]}... top-p {toks_p[:12]}...")
    launched = {k for k, n in counts.items() if n > 0}
    if launched != expect:
        raise RuntimeError(f"{label}: kernels launched {sorted(launched)}, "
                           f"expected {sorted(expect)}")
    result = dict(peak_memory_gb=peak_gb, launches=counts,
                  runs={name: dict(ttft_ms=1e3 * m.ttft_seconds,
                                   prefill_tok_s=m.prefill_tokens_per_second,
                                   decode_tok_s=m.tokens_per_second)
                        for name, m in runs})
    result.update(chunk_checks(torch, label, engine, prompt, toks_a))
    return result, engine, prompt, toks_a


def chunk_checks(torch, label, engine, prompt, toks):
    """The decode chunk on `engine`, after its path's run (these launches
    are not the path's): the path's greedy tokens `toks`, decoded in
    chunks of engine.decode_chunk steps with the position on the device,
    bit for bit a decode_step + argmax loop's (host positions); and the
    launches of one chunk of n steps exactly n times those of one
    decode_step."""
    from lmrs_tpu_torch.kernels import launches, reset_launches
    from lmrs_tpu_torch.runtime.engine import decode_chunk

    engine.reset()
    loop = [int(torch.argmax(engine.prefill(prompt)))]
    for _ in range(len(toks) - 1):
        loop.append(int(torch.argmax(engine.decode_step(loop[-1]))))
    if loop != toks:
        raise RuntimeError(f"{label}: the chunk path's greedy tokens {toks} "
                           f"differ from the decode_step loop's {loop}")
    per_token = per_token_launches(torch, engine, prompt)
    n = engine.decode_chunk
    engine.reset()
    tok = torch.argmax(engine.prefill(prompt)).reshape(1)
    torch.cuda.synchronize()
    reset_launches()
    with torch.no_grad():
        decode_chunk(engine._run, tok, engine.pos, n, 0.0, 1.0)
    torch.cuda.synchronize()
    chunk = {k: c for k, c in launches().items() if c}
    log(f"  {label}: greedy chunks of {n} = the decode_step loop bit for "
        f"bit ({len(loop)} tokens); launches of one decode step "
        f"{per_token}, of one chunk {chunk}")
    if chunk != {k: n * c for k, c in per_token.items()}:
        raise RuntimeError(f"{label}: a chunk of {n} steps launched "
                           f"{chunk}, not {n} x {per_token}")
    engine.reset()
    return dict(chunk_tokens_equal_step_loop=len(loop),
                launches_per_decode_token=per_token,
                launches_per_chunk=chunk)


def greedy_margins(torch, engine, prompt, n, embeds=None):
    """Plain greedy decoding step by step: (tokens, top-2 logit margin of
    every step over the largest |logit| of that step).  `embeds`: rows
    prefilled before the prompt (an image's)."""
    engine.reset()
    if embeds is not None:
        engine.prefill_embeds(embeds, want_logits=False)
    logits = engine.prefill(prompt)
    toks, margins = [], []
    for _ in range(n):
        top = torch.topk(logits, 2)
        toks.append(int(top.indices[0]))
        margins.append(float(top.values[0] - top.values[1])
                       / float(logits.abs().max()))
        logits = engine.decode_step(toks[-1])
    return toks, margins


NEAR_TIE = 1e-3     # of the logit scale
# A batched Llama-3.2-3B step of 16 rows runs its layers through F (bf16
# activations) where the single-stream Engine runs W8A8 (D): the logits
# differ by the W8A8 noise, up to ~1e-2 of the logit scale
# (tests/test_torch_q8_model.py), so a near-tie is wider there
NEAR_TIE_W8A8 = 1e-2
# fuse_ffn on against off: the FFN takes bf16 activations (K) where the
# unfused path takes f32 (A) or W8A8 (D); the tests measure up to 2.2e-3
# of the logit scale on a tiny model (tests/test_torch_ffn_fused.py)
NEAR_TIE_FUSED = 1e-2


def drive_speculative(torch, label, engine, prompt, plain, expect, k=4):
    """Speculative decoding on `engine` (its own path: the launch counts
    are set to 0 just before and read just after), in chunks of
    engine.decode_chunk verify steps (`runtime.speculative.spec_chunk`).
    Greedy, k drafts per verify step, as many tokens as `plain`, the
    engine's plain greedy tokens, reading the device at most once a chunk
    besides the first token (Tensor.item, .tolist and .cpu counted):
    equal, or equal up to the first step whose top-2 margin in a
    plain run is below NEAR_TIE of the logit scale (a verify window runs
    the kernels at T = k+1, which may sum in another order than T = 1).
    Drafts must have been both accepted and rejected.  Then two sampled
    runs through the rejection sampler.  Top-p (temperature 0.7, top-p
    0.9, seed 0): random weights give it a nearly flat distribution, so
    its drafts are rejected (at least one must be) and every token is a
    resample.  A nucleus of one token (temperature 1.5, top-p 1e-6), whose
    distribution is one-hot on the argmax: the sampler then accepts what
    greedy verification accepts, resamples the argmax where it rejects,
    and must emit the speculative greedy tokens, with drafts both accepted
    and rejected.  Returns launch counts and metrics."""
    from lmrs_tpu_torch.kernels import launches, reset_launches
    from lmrs_tpu_torch.runtime.engine import GenerationConfig

    n = len(plain)
    reset_launches()
    engine.reset()
    with host_reads(torch) as reads:
        toks = engine.generate(prompt, GenerationConfig(
            temperature=0.0, max_new_tokens=n, speculative_k=k))
    mg = engine.metrics
    chunks = mg.spec_proposed // (engine.decode_chunk * k)
    log(f"  {label}: speculative greedy read the device {len(reads)} times "
        f"({sorted(set(reads))}) in {chunks} chunks of "
        f"{engine.decode_chunk} verify steps")
    if len(reads) > chunks + 1:
        raise RuntimeError(f"{label}: {len(reads)} host reads in {chunks} "
                           f"speculative chunks: one a chunk and the "
                           f"first token's expected")
    engine.reset()
    toks_p = engine.generate(prompt, GenerationConfig(
        temperature=0.7, top_p=0.9, seed=0, max_new_tokens=n,
        speculative_k=k))
    mp = engine.metrics
    engine.reset()
    toks_1 = engine.generate(prompt, GenerationConfig(
        temperature=1.5, top_p=1e-6, seed=0, max_new_tokens=n,
        speculative_k=k))
    m1 = engine.metrics
    torch.cuda.synchronize()
    counts = launches()
    n_eq = n
    if toks != plain:
        _, margins = greedy_margins(torch, engine, prompt, n)
        close = [i for i, m in enumerate(margins) if m < NEAR_TIE]
        n_eq = close[0] if close else n
        log(f"  {label}: speculative greedy leaves plain greedy at step "
            f"{[a == b for a, b in zip(toks, plain)].index(False)}; first "
            f"near-tie of the plain run at step {n_eq}")
    if len(toks) != n or toks[:n_eq] != plain[:n_eq]:
        raise RuntimeError(f"{label}: speculative greedy tokens {toks} "
                           f"differ from plain greedy tokens {plain} before "
                           f"a near-tie (step {n_eq})")
    vocab = engine.cfg.vocab_size
    if len(toks_p) != n or not all(0 <= t < vocab for t in toks_p):
        raise RuntimeError(f"{label}: invalid speculative top-p tokens")
    out = {"host_reads": len(reads), "chunks": chunks}
    if toks_1[:n_eq] != toks[:n_eq]:
        raise RuntimeError(f"{label}: the one-token nucleus emits {toks_1}, "
                           f"speculative greedy {toks}")
    for name, m in (("speculative greedy", mg), ("speculative top-p", mp),
                    ("speculative one-token nucleus", m1)):
        steps = m.spec_proposed // k
        out[name] = dict(
            decode_tok_s=m.tokens_per_second, verify_steps=steps,
            tokens_per_step=m.decode_tokens / steps,
            proposed=m.spec_proposed, accepted=m.spec_accepted,
            acceptance=m.spec_accepted / m.spec_proposed)
        log(f"    {label}, {name} k={k}: decode {m.tokens_per_second:.2f} "
            f"tok/s, {m.decode_tokens} tokens in {steps} verify steps "
            f"({m.decode_tokens / steps:.2f} per step), "
            f"{m.spec_accepted}/{m.spec_proposed} drafts accepted "
            f"({100 * m.spec_accepted / m.spec_proposed:.1f}%)")
    log(f"    launches {counts}; top-p tokens {toks_p[:12]}...")
    for name, m in (("greedy", mg), ("one-token nucleus", m1)):
        if not 0 < m.spec_accepted < m.spec_proposed:
            raise RuntimeError(f"{label}: speculative {name} accepted "
                               f"{m.spec_accepted} of {m.spec_proposed} "
                               f"drafts: both branches must run")
    # a rejected draft sends the top-p run through the resample from the
    # zeroed row; the random prompt's first drafts are rejected for sure
    if not (mp.spec_proposed > 0 and mp.spec_accepted < mp.spec_proposed):
        raise RuntimeError(f"{label}: speculative top-p accepted "
                           f"{mp.spec_accepted} of {mp.spec_proposed} "
                           f"drafts: the rejection branch must run")
    launched = {name for name, c in counts.items() if c > 0}
    if launched != expect:
        raise RuntimeError(f"{label}: kernels launched {sorted(launched)}, "
                           f"expected {sorted(expect)}")
    return dict(launches=counts, runs=out)


@contextlib.contextmanager
def host_reads(torch):
    """Count the calls of Tensor.item, .tolist and .cpu made inside (each a
    read of a tensor by the host)."""
    names = ("item", "tolist", "cpu")
    orig = {name: getattr(torch.Tensor, name) for name in names}
    calls = []

    def counted(name):
        def read(self, *a, **kw):
            calls.append(name)
            return orig[name](self, *a, **kw)
        return read
    for name in names:
        setattr(torch.Tensor, name, counted(name))
    try:
        yield calls
    finally:
        for name in names:
            setattr(torch.Tensor, name, orig[name])


def drive_session(torch, label, work, cfg, params, cache_dtype, prompt):
    """save_session after the prompt and 16 greedy tokens, load_session
    into a fresh Engine, a second turn of 16 tokens: equal to the second
    turn of the engine that was never interrupted."""
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

    gen = GenerationConfig(temperature=0.0, max_new_tokens=16)
    first = Engine(cfg, params, cache_dtype=cache_dtype)
    first.generate(prompt, gen)
    saved_pos = first.pos
    path = work / "session.npz"
    t0 = time.perf_counter()
    first.save_session(str(path))
    save_s = time.perf_counter() - t0
    second = Engine(cfg, params, cache_dtype=cache_dtype)
    t0 = time.perf_counter()
    second.load_session(str(path))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    size_mb = path.stat().st_size / 1e6
    path.unlink()
    turn = prompt[:8]
    want = first.generate(turn, gen)
    got = second.generate(turn, gen)
    log(f"  {label}: session of {size_mb:.0f} MB saved in {save_s:.2f} s, "
        f"loaded in {load_s:.2f} s at pos {saved_pos}; "
        f"second turn {got[:8]}...")
    if got != want or second.pos != first.pos:
        raise RuntimeError(f"{label}: the resumed session continues "
                           f"{got}, the uninterrupted engine {want}")
    return dict(session_mb=size_mb, save_s=save_s, load_s=load_s)


def drive_cli(label, model, tok_path, expect, extra_args=()):
    """The chat CLI in a subprocess: one prompt, 16 greedy tokens; the
    launch counts it prints must show exactly the kernels of `expect`."""
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "lmrs_tpu_torch.cli.chat", "--model",
         str(model), "--tokenizer", str(tok_path), "--temperature", "0",
         "--max-new-tokens", "16", "--show-metrics", *extra_args],
        input="hello from the smoke run\n", capture_output=True,
        text=True, timeout=600, cwd=str(HERE),
        env=dict(os.environ, PYTHONPATH=str(HERE)))
    if cli.returncode != 0:
        raise RuntimeError(f"{label}: chat CLI exit {cli.returncode}:\n"
                           f"{cli.stderr[-4000:]}")
    lines = cli.stdout.splitlines()
    at = [i for i, ln in enumerate(lines) if ln.endswith("Assistant:")]
    reply = lines[at[0] + 1] if at and at[0] + 1 < len(lines) else ""
    if not reply.strip():
        raise RuntimeError(f"{label}: chat CLI printed no reply:\n"
                           f"{cli.stdout}")
    counted = [ln for ln in lines if ln.startswith("Kernel launches")]
    if not counted:
        raise RuntimeError(f"{label}: chat CLI printed no launch counts:\n"
                           f"{cli.stdout}")
    counts = json.loads(counted[-1].split(":", 1)[1])
    log(f"  {label}: CLI exit 0 in {time.perf_counter() - t0:.1f} s; reply "
        f"{reply[:80]!r}; {[ln for ln in lines if 'Speed' in ln]}; "
        f"launches {counts}")
    launched = {k for k, n in counts.items() if n > 0}
    if launched != expect:
        raise RuntimeError(f"{label}: kernels launched on the CLI path "
                           f"{sorted(launched)}, expected {sorted(expect)}")
    return counts


class Conn:
    """An in-process WebSocket connection for BackendServer.handle: yields
    `messages` and records what the server sends."""

    def __init__(self, messages):
        self.messages = list(messages)
        self.sent = []

    async def send(self, msg):
        self.sent.append(json.loads(msg))

    def __aiter__(self):
        return self._gen()

    async def _gen(self):
        for m in self.messages:
            yield m


def serve_wave(thread, prompts, sampling, n_new):
    """Submit `prompts` to a SchedulerThread at once (sampling: a
    (temperature, top_p) per prompt) and wait for all of them.  Returns
    the requests and the wall seconds from the first submit to the last
    token."""
    import threading

    events = [threading.Event() for _ in prompts]
    t0 = time.perf_counter()
    reqs = [thread.submit(p, max_new_tokens=n_new, temperature=t, top_p=tp,
                          on_done=lambda out, e=e: e.set())
            for p, (t, tp), e in zip(prompts, sampling, events)]
    for e in events:
        if not e.wait(600):
            raise RuntimeError("a batched request did not finish in 600 s")
    wall = max(r.done_time for r in reqs) - t0
    for r in reqs:
        if r.error is not None or len(r.out) != n_new:
            raise RuntimeError(f"request {r.id}: error {r.error!r}, "
                               f"{len(r.out)} tokens")
    return reqs, wall


def wave_metrics(reqs, wall):
    """Aggregate and per-request rates of one wave (host clock)."""
    per_req = []
    for r in reqs:
        first = r.submit_time + r.ttft
        per_req.append(dict(ttft_ms=1e3 * r.ttft, decode_tok_s=(
            (len(r.out) - 1) / (r.done_time - first))))
    n_tok = sum(len(r.out) for r in reqs)
    return dict(requests=len(reqs), tokens=n_tok, wall_s=wall,
                aggregate_tok_s=n_tok / wall, per_request=per_req)


def check_greedy(torch, label, engine, prompt, got, want, near_tie,
                 embeds=None):
    """A batched greedy stream against the single-stream Engine's greedy
    tokens, up to the first step whose top-2 margin in a plain run is
    below `near_tie` of the logit scale."""
    if got == want:
        return len(got)
    _, margins = greedy_margins(torch, engine, prompt, len(want), embeds)
    close = [i for i, m in enumerate(margins) if m < near_tie]
    n_eq = close[0] if close else len(want)
    if got[:n_eq] != want[:n_eq]:
        raise RuntimeError(f"{label}: batched greedy {got} differs from the "
                           f"Engine's {want} before a near-tie (step {n_eq})")
    log(f"    {label}: equal to the Engine up to the near-tie at step {n_eq}")
    return n_eq


def engine_refs(torch, cfg, params, cache_dtype, prompts, n_new):
    """The single-stream Engine's greedy tokens for each prompt (and the
    engine, for the near-tie rule)."""
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

    engine = Engine(cfg, params, cache_dtype=cache_dtype)
    refs = []
    for p in prompts:
        engine.reset()
        refs.append(engine.generate(p, GenerationConfig(
            temperature=0.0, max_new_tokens=n_new)))
    return engine, refs


def drive_batched(torch, label, server, waves, refs, engine, expect,
                  conversation=None, prefix_first=None, near_tie=NEAR_TIE):
    """One batched serving path through a BackendServer in --batch mode,
    the launch counts set to 0 just before and read just after: each wave
    of (prompts, sampling) served at once; optionally a prompt served
    first, alone, so that the next wave's prompts sharing its prefix fork
    its pages; then optionally a two-turn conversation through `handle`.
    `expect` = (kernels that must launch, kernels that may besides).  Then
    each greedy stream is held against `refs` (prompt tuple -> Engine
    greedy tokens) up to the first near-tie (`near_tie` of the logit
    scale)."""
    import asyncio

    from lmrs_tpu_torch.kernels import launches, reset_launches

    thread = server.scheduler
    sched = thread.sched
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    hits0, saved0 = sched.prefix_hits, sched.prefix_tokens_saved
    prop0, acc0 = sched.spec_proposed, sched.spec_accepted
    dec_s0, dec_steps0 = sched.decode_seconds, sched.decode_steps
    n_new = 64
    out = dict(waves=[])
    if prefix_first is not None:
        import threading

        ev = threading.Event()
        first = thread.submit(prefix_first, max_new_tokens=n_new,
                              temperature=0.0, on_done=lambda o: ev.set())
        while first.ttft is None and not ev.is_set():
            time.sleep(0.01)          # its prefill is done: a donor now
    greedy = []         # (prompt, tokens): held against refs after the path
    for prompts, sampling in waves:
        reqs, wall = serve_wave(thread, prompts, sampling, n_new)
        m = wave_metrics(reqs, wall)
        m["pages_used_after"] = sched.pages_used() if sched.paged else None
        out["waves"].append(m)
        greedy += [(r.prompt, r.out) for r, (t, _) in zip(reqs, sampling)
                   if t == 0.0]
        log(f"  {label}: wave of {len(reqs)}: {m['tokens']} tokens in "
            f"{wall:.2f} s = {m['aggregate_tok_s']:.1f} tok/s aggregate; "
            f"per request decode "
            f"{[round(x['decode_tok_s'], 1) for x in m['per_request']]} "
            f"tok/s, TTFT "
            f"{[round(x['ttft_ms']) for x in m['per_request']]} ms")
    if prefix_first is not None:
        if not ev.wait(600) or first.error is not None:
            raise RuntimeError(f"{label}: the prefix donor failed")
        greedy.append((first.prompt, first.out))
    if conversation is not None:
        conn = Conn(conversation)
        asyncio.run(server.handle(conn))
        eos = [m for m in conn.sent if m["text"] == "<eos>"]
        status = [m for m in conn.sent if m["category"] == "STATUS"]
        pieces = [m for m in conn.sent if m["category"] == "OUTPUT"
                  and m["text"] != "<eos>"]
        if len(eos) != len(conversation) or status or not pieces:
            raise RuntimeError(f"{label}: conversation got {conn.sent[:8]}")
        out["conversation"] = dict(turns=len(eos), pieces=len(pieces))
        log(f"  {label}: a {len(eos)}-turn conversation through handle: "
            f"{len(pieces)} pieces")
    torch.cuda.synchronize()
    counts = launches()
    launched = {k for k, n in counts.items() if n > 0}
    need, may = expect
    if not need <= launched <= need | may:
        raise RuntimeError(f"{label}: kernels launched {sorted(launched)}, "
                           f"expected {sorted(need)} (and perhaps "
                           f"{sorted(may)})")
    # the decode steps replayed the scheduler's CUDA graph (a speculative
    # scheduler never captures one); its nodes are the step's kernels,
    # one by one
    replays = sched.decode_graph_replays
    if (replays > 0) == bool(sched.spec_k):
        raise RuntimeError(f"{label}: {replays} decode graph replays with "
                           f"speculative_k {sched.spec_k}")
    if replays:
        k = thread.call(lambda: graph_step_kernels(torch, sched))
        check_graph_step(label, k)
        out["graph_step_launches"] = k["graph_launches"]
        log(f"  {label}: {replays} decode steps replayed the graph "
            f"({sched.decode_graph_captures} capture); its "
            f"{sum(k['graph'].values())} kernel nodes are the step's "
            f"captured now, its launches {k['graph_launches']}")
    out.update(decode_graph_replays=sched.decode_graph_replays,
               decode_graph_captures=sched.decode_graph_captures)
    # after the counts: a near-tie check runs the reference Engine
    n_cmp = sum(check_greedy(torch, label, engine, p, got, refs[tuple(p)],
                             near_tie) for p, got in greedy)
    steps = sched.decode_steps - dec_steps0
    dec_s = sched.decode_seconds - dec_s0
    out.update(
        launches=counts, greedy_tokens_compared=n_cmp,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        decode_steps=steps, decode_ms_per_step=1e3 * dec_s / steps,
        prefix_hits=sched.prefix_hits - hits0,
        prefix_tokens_saved=sched.prefix_tokens_saved - saved0)
    if sched.paged:
        out.update(pages=sched.n_pages - 1, pages_peak=sched.pages_peak,
                   page_size=sched.psz)
    if sched.spec_k:
        prop, acc = sched.spec_proposed - prop0, sched.spec_accepted - acc0
        out.update(spec_proposed=prop, spec_accepted=acc,
                   acceptance=acc / prop)
    log(f"  {label}: launches {counts}; peak memory "
        f"{out['peak_memory_gb']:.2f} GB; {steps} decode steps, "
        f"{out['decode_ms_per_step']:.1f} ms each; prefix hits "
        f"{out['prefix_hits']} ({out['prefix_tokens_saved']} rows); "
        + (f"pool pages peak {sched.pages_peak} of {sched.n_pages - 1}; "
           if sched.paged else "contiguous cache; ")
        + (f"speculative acceptance {out['acceptance']:.3f} "
           f"({out['spec_accepted']}/{out['spec_proposed']})"
           if sched.spec_k else ""))
    return out


def graph_step_kernels(torch, sched):
    """What the scheduler's CUDA graph launches a replay against what the
    same decode step launches now, on the scheduler's thread between
    ticks: {"graph": the graph's kernel nodes by function, "step": those
    of the step's `forward_batched` on the same inputs captured now into
    a graph of its own (never run), both read through libcuda;
    "graph_launches": the wrappers' launches a replay adds (read from the
    graph's nodes), "step_launches": the wrappers' counts of the step's
    calls}.  The profiler's device trace is no exact count here: on the
    card, on this thread, it lost a step's first three or four kernels in
    four of five readings, eager or replayed (the card tests hold it
    against the graph on the main thread)."""
    from lmrs_tpu_torch.kernels import launches, reset_launches
    from lmrs_tpu_torch.kernels.cuda import graph_kernels
    from lmrs_tpu_torch.models.transformer import forward_batched

    dg = sched._graph
    toks = torch.arange(sched.B, device=sched.device, dtype=dg._x.dtype)
    pos = torch.tensor([s.pos for s in sched.slots], dtype=dg._pos.dtype,
                       device=sched.device)
    table = sched._table_dev if sched.paged else None
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    reset_launches()
    with torch.no_grad(), torch.cuda.graph(
            graph, stream=torch.cuda.Stream(sched.device),
            capture_error_mode="thread_local"):
        forward_batched(sched.params, sched.cfg, sched.cache, toks, pos,
                        table=table, w8a8=sched.w8a8)
    out = {"graph": dict(dg.kernels), "step": graph_kernels(graph),
           "graph_launches": {k: n for k, n in dg.launches.items() if n},
           "step_launches": {k: n for k, n in launches().items() if n}}
    reset_launches()
    return out


def check_graph_step(label, k):
    """Raise unless `graph_step_kernels`' readings agree: the graph's
    kernel nodes and the step's the same functions the same number of
    times, and the launches read from the graph's nodes the wrappers'
    counts of the step's calls."""
    if k["graph"] != k["step"]:
        diff = {n: [k["graph"].get(n, 0), k["step"].get(n, 0)]
                for n in sorted(set(k["graph"]) | set(k["step"]))
                if k["graph"].get(n) != k["step"].get(n)}
        raise RuntimeError(f"{label}: kernels (the graph's nodes, the step "
                           f"captured now) {diff}")
    if k["graph_launches"] != k["step_launches"]:
        raise RuntimeError(f"{label}: the graph's nodes count "
                           f"{k['graph_launches']}, the step's calls "
                           f"{k['step_launches']}")


def batched_phase_gemma(torch, model_path, tok_path, cfg):
    """Gemma-2-9B Q4_0 through BackendServer(batch=8): 8 requests of
    256-1,024 random tokens (6 greedy, 2 top-p 0.9 at T 0.7) at once, then
    4 more (greedy, on freed slots), then a two-turn conversation through
    handle; on the default paged pool (bf16), the contiguous cache
    (--no-paged) and the int4 pool."""
    from lmrs_tpu_torch.serve.backend import BackendServer

    rng = torch.Generator().manual_seed(11)
    lens = torch.randint(256, 1025, (8,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in lens]
    sampling = [(0.0, 0.9)] * 6 + [(0.7, 0.9)] * 2
    greedy = prompts[:6]
    waves = [(prompts, sampling), (greedy[:4], [(0.0, 0.9)] * 4)]
    conversation = [json.dumps({"text": "hello from the smoke run"}),
                    json.dumps({"text": "the card"})]
    paths = {}
    refs_by_cache = {}
    for what, kw, cache_dtype, expect in (
            ("paged bf16 pool", {}, torch.bfloat16, GEMMA_PAGED),
            ("contiguous bf16 cache", dict(no_paged=True), torch.bfloat16,
             GEMMA_CONTIG),
            ("paged int4 pool", dict(cache_dtype="int4"), "int4",
             GEMMA_PAGED)):
        t0 = time.perf_counter()
        server = BackendServer(str(model_path), str(tok_path), batch=8,
                               max_new_tokens=64, **kw)
        server.warmup()
        label = f"gemma2-9b Q4_0 batch 8, {what}"
        log(f"  {label}: server up in {time.perf_counter() - t0:.1f} s")
        key = str(cache_dtype)
        if key not in refs_by_cache:
            t0 = time.perf_counter()
            refs_by_cache[key] = engine_refs(torch, cfg, server.params,
                                             cache_dtype, greedy, 64)
            log(f"  Engine references ({key}): {len(greedy)} prompts in "
                f"{time.perf_counter() - t0:.1f} s")
        engine, refs = refs_by_cache[key]
        try:
            paths[label] = drive_batched(
                torch, label, server, waves,
                {tuple(p): r for p, r in zip(greedy, refs)}, engine, expect,
                conversation=conversation)
        finally:
            server.shutdown()
        del server
        torch.cuda.empty_cache()
    del refs_by_cache
    torch.cuda.empty_cache()
    return paths


def batched_phase_llama(torch, model_path, tok_path, cfg):
    """Llama-3.2-3B Q8_0 through BackendServer(batch=16): one request with
    a 512-token system prefix served first, then 15 at once (8 greedy
    sharing that prefix, so their pages fork from the first, and 7 random:
    4 greedy, 3 top-p 0.9 at T 0.7); on the int8 pool, then on the int4
    pool with speculation (k = 4, T = 80 rows a step)."""
    from lmrs_tpu_torch.serve.backend import BackendServer

    rng = torch.Generator().manual_seed(12)
    system = torch.randint(0, cfg.vocab_size, (512,), generator=rng).tolist()
    shared = [system + torch.randint(0, cfg.vocab_size, (n,),
                                     generator=rng).tolist()
              for n in (8, 40, 100, 200, 300, 17, 64, 150, 90)]
    rand = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
            for n in torch.randint(256, 1025, (7,), generator=rng).tolist()]
    first, rest = shared[0], shared[1:] + rand
    sampling = [(0.0, 0.9)] * 12 + [(0.7, 0.9)] * 3
    greedy = [first] + rest[:12]
    paths = {}
    for what, kw, cache_dtype in (
            ("paged int8 pool", dict(cache_dtype="int8"), torch.int8),
            ("paged int4 pool, speculative k=4",
             dict(cache_dtype="int4", spec_k=4), "int4")):
        t0 = time.perf_counter()
        server = BackendServer(str(model_path), str(tok_path), batch=16,
                               max_new_tokens=64, **kw)
        server.warmup()
        label = f"llama3.2-3b Q8_0 batch 16, {what}"
        log(f"  {label}: server up in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        engine, refs = engine_refs(torch, cfg, server.params, cache_dtype,
                                   greedy, 64)
        log(f"  Engine references ({cache_dtype}): {len(greedy)} prompts in "
            f"{time.perf_counter() - t0:.1f} s")
        try:
            res = drive_batched(
                torch, label, server, [(rest, sampling)],
                {tuple(p): r for p, r in zip(greedy, refs)}, engine,
                LLAMA_PAGED, prefix_first=first, near_tie=NEAR_TIE_W8A8)
        finally:
            server.shutdown()
        if res["prefix_hits"] < 8:
            raise RuntimeError(f"{label}: {res['prefix_hits']} prefix-cache "
                               f"hits, expected the 8 shared prompts")
        paths[label] = res
        del server, engine
        torch.cuda.empty_cache()
    return paths


def per_token_launches(torch, engine, prompt):
    """The kernel launches of one decode step after `prompt`."""
    from lmrs_tpu_torch.kernels import launches, reset_launches

    engine.reset()
    tok = int(torch.argmax(engine.prefill(prompt)))
    torch.cuda.synchronize()
    reset_launches()
    engine.decode_step(tok)
    torch.cuda.synchronize()
    return {k: n for k, n in launches().items() if n}


def drive_fused_path(torch, label, cfg, params, cache_dtype, expect,
                     per_token, unfused_engine, unfused_toks):
    """The main path of `cfg` with fuse_ffn on, on the loaded params:
    drive_main_path's generations (exactly the kernels of `expect`), greedy
    tokens equal to the unfused engine's up to the first near-tie
    (NEAR_TIE_FUSED of the logit scale in the unfused run), and the
    launches of one decode step exactly `per_token`.  Returns (result,
    engine, prompt, greedy tokens)."""
    res, engine, prompt, toks = drive_main_path(
        torch, label, cfg.replace(fuse_ffn=True), params, cache_dtype,
        expect)
    res["greedy_tokens_equal_to_unfused"] = check_greedy(
        torch, label, unfused_engine, prompt, toks, unfused_toks,
        NEAR_TIE_FUSED)
    counts = res["launches_per_decode_token"]     # chunk_checks'
    if counts != per_token:
        raise RuntimeError(f"{label}: one decode step launched {counts}, "
                           f"expected {per_token}")
    return res, engine, prompt, toks


def batched_fused(torch, label, cfg, params, cache_dtype, batch, expect,
                  near_tie, seed):
    """One wave of `batch` requests (prompts of 256-1,024 random tokens,
    half greedy, half top-p 0.9 at T 0.7; 64 tokens each) through a
    BatchScheduler with fuse_ffn on, on the loaded params and the paged
    pool (`cache_dtype`), through drive_batched: the launch counts set to
    0 just before and read just after, each greedy stream held against the
    single-stream fused Engine up to a near-tie.  Every forward launches
    one FFN kernel a layer, so K's and L's counts are whole multiples of
    the layer count."""
    from types import SimpleNamespace

    from lmrs_tpu_torch.serve.scheduler import (BatchScheduler,
                                                SchedulerThread,
                                                auto_pool_tokens)

    fcfg = cfg.replace(fuse_ffn=True)
    rng = torch.Generator().manual_seed(seed)
    lens = torch.randint(256, 1025, (batch,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in lens]
    n_greedy = batch // 2
    sampling = [(0.0, 0.9)] * n_greedy + [(0.7, 0.9)] * (batch - n_greedy)
    t0 = time.perf_counter()
    engine, refs = engine_refs(torch, fcfg, params, cache_dtype,
                               prompts[:n_greedy], 64)
    log(f"  Engine references (fuse_ffn, {cache_dtype}): {n_greedy} prompts "
        f"in {time.perf_counter() - t0:.1f} s")
    thread = SchedulerThread(BatchScheduler(
        fcfg, params, max_batch=batch, cache_dtype=cache_dtype,
        pool_tokens=auto_pool_tokens(batch, fcfg.seq_len, 512),
        page_size=512, prefill_chunk=256))
    try:
        res = drive_batched(
            torch, label, SimpleNamespace(scheduler=thread),
            [(prompts, sampling)],
            {tuple(p): r for p, r in zip(prompts, refs)}, engine, expect,
            near_tie=near_tie)
    finally:
        thread.shutdown()
    for name in ("ffn_fused_xe", "ffn_fused"):
        if res["launches"][name] % cfg.n_layers:
            raise RuntimeError(f"{label}: {name} launched "
                               f"{res['launches'][name]} times, not a "
                               f"multiple of {cfg.n_layers} layers")
    del engine, thread
    torch.cuda.empty_cache()
    return {label: res}


# phase 5: Phi-3.5-vision Q8_0.  The image's rows and the turn run the Q8
# text path: F for the prefill chunks (image rows and turn), C for their
# attention, then each decode step D (layers), E (classifier), C and M.
# Batched on the paged pool: J in C's place.
PHI_IMAGE_PATH = {"q8_gemm", "flash_attention", "flash_merge", "q8_gemv_i8",
                  "q8_gemv"}
PHI_IMAGE_PAGED = {"q8_gemm", "flash_attention_paged", "flash_merge",
                   "q8_gemv_i8", "q8_gemv"}
IMAGE_SHAPE = (756, 1008, 3)       # 4 crops: a 2 x 2 grid of 336 tiles
IMAGE_CROPS = 4


def synthetic_image(seed=0):
    """A (756, 1008, 3) uint8 image from a seeded generator: smooth colour
    gradients plus noise (no file, no PIL)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w, _ = IMAGE_SHAPE
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([255 * xx / w, 255 * yy / h,
                     255 * (0.5 + 0.5 * np.sin((xx + yy) / 97.0))], axis=-1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0,
                   255).astype(np.uint8)


def event_ms(torch, fn):
    """(fn's result, device ms between CUDA events around it)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def rel_rows(torch, got, want, row_tol):
    """(max error over the output scale, share of rows with an error above
    `row_tol` of the scale)."""
    err = (got.cpu() - want).abs().reshape(-1, want.shape[-1])
    scale = want.abs().max().item()
    return (err.max().item() / scale,
            (err > row_tol * scale).any(dim=1).float().mean().item())


def vision_faults(torch):
    """Faults planted into the card's vision matmuls (name -> matmul(x,
    w)): each must fail the per-call check.  A skipped activation
    quantizer, bf16 products, the neighbouring group's weight scales, and
    one group's weight scale 2^-7 too large."""
    import dataclasses

    from lmrs_tpu_torch.ops.matmul import qmatmul_exact
    from lmrs_tpu_torch.quant import dequantize

    def scaled(w, s):
        return dataclasses.replace(w, s=s)

    def group0(x, w):
        s = w.s.clone()
        s[..., 0] *= 1 + 2 ** -7
        return qmatmul_exact(x, scaled(w, s))

    return {
        "activation quantizer skipped":
            lambda x, w: x.float() @ dequantize(w).t(),
        "bf16 products": lambda x, w: (
            x.to(torch.bfloat16) @ dequantize(w).to(torch.bfloat16).t()
        ).float(),
        "neighbouring group's weight scales": lambda x, w: qmatmul_exact(
            x, scaled(w, w.s.roll(1, dims=-1))),
        "group 0's weight scale x (1 + 2^-7)": group0,
    }


VISION_CALL_TOL = 1e-6     # of a call's output scale, as the exact matmul
# the Q8 tower's first 2 layers over 5 crops end to end, of the output
# scale: between the honest reading (1.33e-3, the last-bit rounding flips)
# and the smallest planted fault's (4.03e-3) on an H100 (PERF.md §6)
VISION_Q8_TOL = 2.5e-3


def check_vision(torch, f, vcfg, vision, patches):
    """The vision encoder on the card against the same code on the CPU on
    the same inputs.  (1) The weights as loaded, bit for bit.  (2) The
    exact matmul at a vision shape (5 crops of 577 rows, w1 of the first
    layer): its integer part bit for bit, its output within 1e-6 of the
    scale.  (3) The tower with its weights dequantized to f32, the tower's
    own arithmetic, within 1e-4 of the output scale: its first 2 layers
    over the 5 crops, and all 23 over one crop.  (4) The tower as it runs,
    Q8_0 weights and lm.rs's activation quantizer: every matmul call of
    the card's tower against the exact arithmetic on the CPU on the input
    that call was given, within VISION_CALL_TOL; end to end, the first 2
    layers over 5 crops within VISION_Q8_TOL of the output scale (the
    card's f32 sums differ from the CPU's in the last bit, so an
    activation within that bit of a rounding boundary now and then rounds
    to the neighbouring integer, and attention spreads the step over the
    crop: end to end only a factor of ~3 parts those flips from a wrong
    quantizer, the per-call check parts them by orders of magnitude), and
    all 23 over one crop (reported).  (5) Planted faults (`vision_faults`)
    in the card's matmuls, 2 layers over 5 crops: each must fail the
    per-call check; their end-to-end readings are reported beside the
    honest one."""
    import dataclasses

    from lmrs_tpu_torch.io.params import vision_params_from_lmrs
    from lmrs_tpu_torch.models.vision import (N_POSITIONS, recording_matmul,
                                              vision_forward,
                                              vision_params_dequantized,
                                              worst_call_error)
    from lmrs_tpu_torch.ops.matmul import group_ints, qmatmul_exact
    from lmrs_tpu_torch.quant import QTensor, quantize_q8_act

    _, vp_cpu, _, _ = vision_params_from_lmrs(f, device="cpu")
    vp_dev = vision[1]

    def fields(vp):
        out = {}
        for obj, pre in ((vp, ""), (vp.layers, "layers.")):
            for fl in dataclasses.fields(obj):
                v = getattr(obj, fl.name)
                if isinstance(v, QTensor):
                    out[pre + fl.name + ".q"] = v.q
                    out[pre + fl.name + ".s"] = v.s
                elif isinstance(v, torch.Tensor):
                    out[pre + fl.name] = v
        return out

    cpu_fields = fields(vp_cpu)
    loaded_equal = all(torch.equal(v.cpu(), cpu_fields[k])
                       for k, v in fields(vp_dev).items())
    log(f"  vision weights on the card == CPU load, bit for bit: "
        f"{loaded_equal}")
    if not loaded_equal:
        raise RuntimeError("the vision weights on the card differ from the "
                           "CPU's")

    rows = patches.shape[0] * N_POSITIONS
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(rows, vcfg.dim, generator=gen)
    w_cpu = vp_cpu.layers.at(0).w1
    w_dev = vp_dev.layers.at(0).w1
    want = qmatmul_exact(x, w_cpu)
    xd = x.to(w_dev.q.device)
    qmatmul_exact(xd, w_dev)                            # warm-up
    got, mm_ms = event_ms(torch, lambda: qmatmul_exact(xd, w_dev))
    rel = (got.cpu() - want).abs().max().item() / want.abs().max().item()
    xq, xs = quantize_q8_act(x, vcfg.group_size)
    cq, cs = quantize_q8_act(xd, vcfg.group_size)
    ints_equal = (torch.equal(cq.cpu(), xq) and torch.equal(cs.cpu(), xs)
                  and torch.equal(group_ints(cq, w_dev.q, vcfg.group_size)
                                  .cpu(), group_ints(xq, w_cpu.q,
                                                     vcfg.group_size)))
    log(f"  exact matmul {rows} x {vcfg.dim} -> {w_dev.out_features} (Q8_0 "
        f"w1): integer part card == CPU {ints_equal}, output max error "
        f"{rel:.2e} of its scale (tolerance 1e-6), {mm_ms:.3f} ms on the "
        f"card")
    if not ints_equal or rel > 1e-6:
        raise RuntimeError("the exact matmul on the card differs from the "
                           "CPU")
    out = dict(exact_matmul_rel_err=rel, exact_matmul_ints_equal=ints_equal,
               exact_matmul_ms=mm_ms)

    two = dataclasses.replace(vcfg, n_layers=3)       # runs 2 layers
    pd = patches.to(xd.device)
    one, od = patches[:1], pd[:1]                     # one crop
    deep = f"all {vcfg.n_layers - 1} layers, 1 crop"
    f32_cpu = vision_params_dequantized(vp_cpu)
    f32_dev = vision_params_dequantized(vp_dev)
    for what, cfg, p_cpu, p_dev in (("first 2 layers, 5 crops", two,
                                     patches, pd),
                                    (deep, vcfg, one, od)):
        want = vision_forward(f32_cpu, cfg, p_cpu)
        got = vision_forward(f32_dev, cfg, p_dev)
        vrel, share = rel_rows(torch, got, want, 1e-4)
        log(f"  vision_forward, {what}, f32 weights: card vs CPU max "
            f"error {vrel:.2e} of the output scale (tolerance 1e-4)")
        if not torch.isfinite(got).all() or vrel > 1e-4:
            raise RuntimeError(f"vision_forward ({what}, f32 weights) on "
                               f"the card differs from the CPU")
        key = "2_layers" if cfg is two else "all_layers"
        out[f"vision_{key}_f32_rel_err"] = vrel
    del f32_cpu, f32_dev

    want2 = vision_forward(vp_cpu, two, patches)
    for what, cfg, p_cpu, p_dev, want in (
            ("first 2 layers, 5 crops", two, patches, pd, want2),
            (deep, vcfg, one, od, None)):
        rec, calls = recording_matmul()
        got = vision_forward(vp_dev, cfg, p_dev, matmul=rec)
        call_err = worst_call_error(calls)
        if want is None:
            want = vision_forward(vp_cpu, cfg, p_cpu)
        vrel, share = rel_rows(torch, got, want, 1e-4)
        log(f"  vision_forward, {what}, Q8_0 weights: each of the "
            f"{len(calls)} matmul calls vs the CPU on its own input, worst "
            f"{call_err:.2e} of its scale (tolerance {VISION_CALL_TOL:g}); "
            f"end to end card vs CPU max error {vrel:.2e} of the output "
            f"scale (tolerance {VISION_Q8_TOL:g} for 2 layers, reported "
            f"for all); rows past 1e-4: {100 * share:.2f}%")
        held = cfg is not two or vrel <= VISION_Q8_TOL
        if (not torch.isfinite(got).all() or call_err > VISION_CALL_TOL
                or len(calls) != 6 * (cfg.n_layers - 1) or not held):
            raise RuntimeError(f"vision_forward ({what}, Q8_0 weights) on "
                               f"the card differs from the CPU")
        key = "2_layers" if cfg is two else "all_layers"
        out.update({f"vision_{key}_q8_rel_err": vrel,
                    f"vision_{key}_q8_rows_past_1e-4": share,
                    f"vision_{key}_q8_worst_call_err": call_err})
        del calls

    faults = {}
    for name, fault in vision_faults(torch).items():
        rec, calls = recording_matmul(fault)
        got = vision_forward(vp_dev, two, pd, matmul=rec)
        call_err = worst_call_error(calls[:1])
        vrel, _ = rel_rows(torch, got, want2, 1e-4)
        del calls
        log(f"  planted fault, {name}: first matmul call {call_err:.2e} of "
            f"its scale (tolerance {VISION_CALL_TOL:g}); 2 layers end to "
            f"end {vrel:.2e} (tolerance {VISION_Q8_TOL:g})")
        if not call_err > VISION_CALL_TOL:
            raise RuntimeError(f"the per-call check passes the planted "
                               f"fault {name!r}")
        faults[name] = dict(first_call_err=call_err, end_to_end_rel=vrel)
    out["vision_planted_faults"] = faults
    return out


def multimodal_phase(torch, work: Path):
    """Phase 5: Phi-3.5-vision Q8_0 at full width and depth."""
    import numpy as np

    from lmrs_tpu_torch.cli.chat import PHI_TURN_SUFFIX
    from lmrs_tpu_torch.config import QuantType, phi35_vision, phi35_vision_aux
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import (params_from_lmrs,
                                          vision_params_from_lmrs)
    from lmrs_tpu_torch.io.synthetic import write_synthetic_lmrs
    from lmrs_tpu_torch.kernels import launches, reset_launches
    from lmrs_tpu_torch.models.phi3v import (PHI_IMAGE_PREFIX_IDS,
                                             PHI_IMAGE_SUFFIX_IDS,
                                             encode_image_to_embeds,
                                             preprocess_image,
                                             processor_forward)
    from lmrs_tpu_torch.models.transformer import embed_tokens
    from lmrs_tpu_torch.models.vision import vision_forward
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
    from lmrs_tpu_torch.serve.scheduler import BatchScheduler

    t_phase = time.perf_counter()
    cfg = phi35_vision(quant=QuantType.Q8_0)
    vcfg, pcfg = phi35_vision_aux(QuantType.Q8_0)
    path = work / "phi35v.lmrs"
    t0 = time.perf_counter()
    write_synthetic_lmrs(str(path), cfg, seed=0, vision_cfg=vcfg,
                         processor_cfg=pcfg)
    log(f"  wrote {path.stat().st_size / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    f = read_lmrs(str(path))
    params = params_from_lmrs(f, device="cuda")
    vision = vision_params_from_lmrs(f, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"  loaded text and vision weights in {load_s:.2f} s")
    cfg, vcfg = f.cfg, f.vision_cfg

    img = synthetic_image()
    t0 = time.perf_counter()
    patches, w_crop, h_crop, n_crops = preprocess_image(img, IMAGE_CROPS,
                                                        vcfg.patch_size)
    pre_ms = 1e3 * (time.perf_counter() - t0)
    if (w_crop, h_crop, n_crops) != (2, 2, 5) or patches.shape != (5, 576,
                                                                   588):
        raise RuntimeError(f"preprocess: {w_crop}x{h_crop} crops, "
                           f"{patches.shape}")
    patches = torch.from_numpy(patches)
    out = dict(load_s=load_s, preprocess_host_ms=pre_ms)
    out.update(check_vision(torch, f, vcfg, vision, patches))

    # the tower and the projector on their own, timed by CUDA events
    with torch.no_grad():
        pd = patches.to(params.final_norm.device)
        vision_forward(vision[1], vcfg, pd)             # warm-up
        feats, v_ms = event_ms(torch, lambda: vision_forward(
            vision[1], vcfg, pd))
        img_rows, p_ms = event_ms(torch, lambda: processor_forward(
            vision[3], pcfg, feats, w_crop, h_crop))
    n_img = 24 * 25 + 1 + 12 * 13
    if (feats.shape != (5, 576, vcfg.dim)
            or img_rows.shape != (n_img, cfg.dim)
            or not torch.isfinite(img_rows).all()):
        raise RuntimeError(f"vision: features {tuple(feats.shape)}, rows "
                           f"{tuple(img_rows.shape)}")
    log(f"  preprocess (host) {pre_ms:.1f} ms; vision tower (23 layers over "
        f"5 x 577 rows) {v_ms:.1f} ms, processor {p_ms:.2f} ms of device "
        f"time (CUDA events)")
    out.update(vision_device_ms=v_ms, processor_device_ms=p_ms)

    # the Engine: image rows, then the turn; greedy twice across reset()
    # and a fresh ingest, then top-p; the counts cover exactly this path
    gen = torch.Generator().manual_seed(21)
    turn = torch.randint(0, 32000, (16,), generator=gen).tolist()
    turn += PHI_TURN_SUFFIX
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = Engine(cfg, params, cache_dtype=torch.bfloat16)
    reset_launches()
    runs, toks = [], []
    for what, g in (("greedy", GenerationConfig(temperature=0.0,
                                                max_new_tokens=32)),
                    ("greedy again", GenerationConfig(temperature=0.0,
                                                      max_new_tokens=32)),
                    ("top-p", GenerationConfig(temperature=0.7, top_p=0.9,
                                               seed=0, max_new_tokens=32))):
        engine.reset()
        t0 = time.perf_counter()
        embeds = encode_image_to_embeds(vision, params, cfg, img,
                                        IMAGE_CROPS)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        engine.prefill_embeds(embeds, want_logits=False)
        fill_s = engine.metrics.prefill_seconds
        toks.append(engine.generate(turn, g))
        m = engine.metrics
        runs.append((what, dict(
            encode_ms=1e3 * enc_s, image_prefill_ms=1e3 * fill_s,
            turn_ttft_ms=1e3 * m.ttft_seconds,
            image_turn_ttft_ms=1e3 * (enc_s + fill_s + m.ttft_seconds),
            decode_tok_s=m.tokens_per_second)))
    torch.cuda.synchronize()
    counts = launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if embeds.shape != (4 + n_img + 3, cfg.dim):
        raise RuntimeError(f"image rows {tuple(embeds.shape)}")
    want_rows = torch.cat([
        embed_tokens(params, cfg, torch.tensor(PHI_IMAGE_PREFIX_IDS,
                                               device=embeds.device)),
        img_rows, embed_tokens(params, cfg, torch.tensor(
            PHI_IMAGE_SUFFIX_IDS, device=embeds.device))])
    rows_rel = ((embeds - want_rows).abs().max()
                / want_rows.abs().max()).item()
    if rows_rel > 1e-6:
        raise RuntimeError(f"encode_image_to_embeds differs from its steps "
                           f"by {rows_rel:.2e} of the scale")
    if toks[0] != toks[1]:
        raise RuntimeError("phi3.5-vision: greedy tokens differ across "
                           "reset() and a fresh ingest")
    if any(len(t) != 32 or not all(0 <= x < cfg.vocab_size for x in t)
           for t in toks):
        raise RuntimeError(f"phi3.5-vision: invalid tokens {toks}")
    launched = {k for k, n in counts.items() if n > 0}
    label = "phi3.5-vision Q8_0 image turn, bf16 cache"
    log(f"  {label}: {embeds.shape[0]} image rows + {len(turn)}-token turn; "
        f"peak memory {peak_gb:.2f} GB; launches {counts}")
    for what, r in runs:
        log(f"    {what}: encode {r['encode_ms']:.1f} ms, prefill of the "
            f"{embeds.shape[0]} rows {r['image_prefill_ms']:.1f} ms, turn "
            f"TTFT {r['turn_ttft_ms']:.1f} ms, image turn TTFT "
            f"{r['image_turn_ttft_ms']:.1f} ms, decode "
            f"{r['decode_tok_s']:.2f} tok/s")
    log(f"    greedy tokens {toks[0][:12]}... top-p {toks[2][:12]}...")
    if launched != PHI_IMAGE_PATH:
        raise RuntimeError(f"{label}: kernels launched {sorted(launched)}, "
                           f"expected {sorted(PHI_IMAGE_PATH)}")
    paths = {label: dict(out, launches=counts, peak_memory_gb=peak_gb,
                         image_rows=embeds.shape[0], runs=dict(runs))}

    # batched: a leased conversation takes the same rows and turn while a
    # text request decodes beside it, on a paged bf16 pool of 2 slots
    text = torch.randint(0, 32000, (200,), generator=gen).tolist()
    engine.reset()
    text_ref = engine.generate(text, GenerationConfig(temperature=0.0,
                                                      max_new_tokens=32))
    label = "phi3.5-vision Q8_0 batch 2, paged bf16 pool"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sched = BatchScheduler(cfg, params, max_batch=2, prefill_chunk=256,
                           decode_chunk=8, pool_tokens=4096, page_size=256)
    t0 = time.perf_counter()
    reset_launches()
    lease = sched.new_conversation()
    side = sched.submit(text, max_new_tokens=32, temperature=0.0)
    sched.step()                       # the text request is under way
    sched.prefill_embeds(lease, embeds)
    req = sched.submit(turn, max_new_tokens=32, temperature=0.0, lease=lease)
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    launched = {k for k, n in counts.items() if n > 0}
    if req.error or side.error or len(req.out) != 32 or len(side.out) != 32:
        raise RuntimeError(f"{label}: {req.error!r} {side.error!r}")
    log(f"  {label}: image stream and a 200-token text request, 32 tokens "
        f"each, in {wall:.2f} s; image stream TTFT after its rows "
        f"{1e3 * req.ttft:.1f} ms; pages peak {sched.pages_peak} of "
        f"{sched.n_pages - 1}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{counts}")
    if launched != PHI_IMAGE_PAGED:
        raise RuntimeError(f"{label}: kernels launched {sorted(launched)}, "
                           f"expected {sorted(PHI_IMAGE_PAGED)}")
    n_img_eq = check_greedy(torch, label, engine, turn, req.out, toks[0],
                            NEAR_TIE_W8A8, embeds)
    n_txt_eq = check_greedy(torch, label, engine, text, side.out, text_ref,
                            NEAR_TIE_W8A8)
    sched.end_conversation(lease)
    paths[label] = dict(
        launches=counts, wall_s=wall, image_stream_ttft_ms=1e3 * req.ttft,
        greedy_tokens_compared=n_img_eq + n_txt_eq,
        pages_peak=sched.pages_peak,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del sched, engine, params, vision
    torch.cuda.empty_cache()
    path.unlink()
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 5 ran {phase_s:.1f} s")
    paths[label]["phase_s"] = phase_s
    return paths


# phase 6: the offline path on Llama-3.2-1B at full width and depth.  A
# seeded BF16 checkpoint in the Hugging Face layout -> the port's exporter
# (Q8_0, Q4_0) -> teacher-forced scoring through the port's kernels.
LLAMA1B = "llama3.2-1b"
PPL_TOKENS = 2048          # scored tokens (2,047 targets)
PPL_CHUNK = 128            # the JAX harness's default chunk
PPL_MATCHED = 0.05         # |NLL per token delta| of a matched model
CHUNK_TOL = 1e-3           # chunk 128 against chunk 256 (both F)
CUT_LAYERS = 2             # the card-against-CPU model: full width
CUT_TOKENS = 256
CUT_TOL = 1e-3             # NLL per token, card against the CPU
# the checkpoint's scales: HF's initializer range for the matrices, norm
# weights near 1, and an embedding (the tied classifier) whose logits
# spread by several units a row.  A wider embedding (2/sqrt(D)) makes the
# random 16-layer model chaotic enough that Q4_0's NLL moves past 0.05;
# PERF.md §6 has the trials
CKPT_STD, CKPT_NORM_STD = 0.02, 0.05
CKPT_EMBED_STD = 1.0       # times 1 / sqrt(dim)
F32_SCORE = {"flash_attention"}
Q8_SCORE = {"q8_gemm", "flash_attention"}
Q4_SCORE = {"q4_gemm", "flash_attention"}
CACHE_SCORE = {"bfloat16": Q8_SCORE,
               "int8": {"q8_gemm", "flash_attention_i8"},
               "int4": {"q8_gemm", "flash_attention_i4"}}


def write_safetensors(path: Path, entries) -> None:
    """A minimal safetensors writer (the card's machine has no
    `safetensors` package): `entries` is a list of (name, dtype name,
    shape, fill), fill() giving the tensor's raw little-endian bytes; the
    tensors are written in order, one at a time."""
    header, off = {"__metadata__": {"format": "pt"}}, 0
    item = {"BF16": 2, "F16": 2, "F32": 4}
    for name, dtype, shape, _ in entries:
        n = item[dtype]
        for d in shape:
            n *= d
        header[name] = {"dtype": dtype, "shape": list(shape),
                        "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for name, _, _, fill in entries:
            data = fill()
            lo, hi = header[name]["data_offsets"]
            if len(data) != hi - lo:
                raise ValueError(f"{name}: {len(data)} bytes, {hi - lo} "
                                 f"in the header")
            f.write(data)


def llama_checkpoint(torch, cfg, work: Path, seed: int = 0):
    """A seeded BF16 Llama checkpoint of `cfg` in the Hugging Face layout
    (one model.safetensors, tied embedding) and its config.json, the
    values drawn on the card.  Returns (checkpoint, config path)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def fill(shape, std, mean=0.0):
        def make():
            t = torch.randn(shape, generator=gen, device="cuda") * std + mean
            return t.to(torch.bfloat16).view(torch.int16).cpu().numpy() \
                .tobytes()
        return make

    D, H, A, KV = cfg.dim, cfg.hidden_dim, cfg.att_dim, cfg.kv_dim
    entries = [("model.embed_tokens.weight", "BF16", (cfg.vocab_size, D),
                fill((cfg.vocab_size, D), CKPT_EMBED_STD / D ** 0.5))]
    for l in range(cfg.n_layers):
        p = f"model.layers.{l}."
        for name, shape in (("input_layernorm", (D,)),
                            ("self_attn.q_proj", (A, D)),
                            ("self_attn.k_proj", (KV, D)),
                            ("self_attn.v_proj", (KV, D)),
                            ("self_attn.o_proj", (D, A)),
                            ("post_attention_layernorm", (D,)),
                            ("mlp.gate_proj", (H, D)),
                            ("mlp.up_proj", (H, D)),
                            ("mlp.down_proj", (D, H))):
            norm = len(shape) == 1
            entries.append((p + name + ".weight", "BF16", shape,
                            fill(shape, CKPT_NORM_STD if norm else CKPT_STD,
                                 1.0 if norm else 0.0)))
    entries.append(("model.norm.weight", "BF16", (D,),
                    fill((D,), CKPT_NORM_STD, 1.0)))
    ckpt = work / "model.safetensors"
    write_safetensors(ckpt, entries)
    config = dict(
        architectures=["LlamaForCausalLM"], hidden_size=D,
        intermediate_size=H, num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads, head_dim=cfg.head_dim,
        num_key_value_heads=cfg.n_kv_heads, vocab_size=cfg.vocab_size,
        max_position_embeddings=cfg.seq_len, rms_norm_eps=cfg.rms_norm_eps,
        rope_theta=cfg.rope_theta, tie_word_embeddings=True,
        torch_dtype="bfloat16")
    cfg_path = work / "config.json"
    cfg_path.write_text(json.dumps(config))
    return ckpt, cfg_path


def export_cli(ckpt: Path, cfg_path: Path, out: Path, qtype: int):
    """The port's exporter in a subprocess; returns (seconds, the max and
    mean group errors it reports)."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "lmrs_tpu_torch.io.export", "--files",
         str(ckpt), "--config", str(cfg_path), "--save-path", str(out),
         "--type", "LLAMA", "--quantize", "--quantize-type", str(qtype)],
        capture_output=True, text=True, timeout=600, cwd=str(HERE),
        env=dict(os.environ, PYTHONPATH=str(HERE)))
    secs = time.perf_counter() - t0
    if run.returncode != 0:
        raise RuntimeError(f"export --quantize-type {qtype}: exit "
                           f"{run.returncode}:\n{run.stderr[-4000:]}")
    found = re.search(r"group error across all weights: (\S+?)\. "
                      r"Mean: (\S+?)\.$", run.stdout, re.M)
    if found is None:
        raise RuntimeError(f"export printed no group error:\n{run.stdout}")
    return secs, float(found[1]), float(found[2])


def scored(torch, label, expect, cfg, params, tokens, f32_cache=True,
           **kw):
    """score_tokens on the card with the launch counts set to 0 just
    before and read just after; exactly the kernels of `expect` must have
    launched."""
    from torch_perplexity import score_tokens

    from lmrs_tpu_torch.kernels import launches, reset_launches

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    r = score_tokens(cfg, params, tokens, **kw)
    secs = time.perf_counter() - t0
    counts = launches()
    launched = {k for k, n in counts.items() if n > 0}
    log(f"  {label}: NLL/token {r['nll_per_token']!r} over "
        f"{r['tokens_scored']} tokens in {secs:.2f} s; launches {counts}")
    if not math.isfinite(r["nll_per_token"]):
        raise RuntimeError(f"{label}: NLL {r['nll_per_token']}")
    if launched != expect:
        raise RuntimeError(f"{label}: kernels launched {sorted(launched)}, "
                           f"expected {sorted(expect)}")
    return dict(launches=counts, f32_cache=f32_cache,
                nll_per_token=r["nll_per_token"],
                tokens_scored=r["tokens_scored"], score_s=secs)


def logit_spread(torch, cfg, params, tokens):
    """(least, median) over rows of max - min logit across the vocabulary
    of the first chunk's rows."""
    from lmrs_tpu_torch.models.transformer import (embed_tokens, forward,
                                                   init_kv_cache)

    cache = init_kv_cache(cfg, "cuda", torch.float32, seq_len=PPL_CHUNK)
    x = embed_tokens(params, cfg, torch.as_tensor(tokens[:PPL_CHUNK],
                                                  device="cuda"))
    logits = forward(params, cfg, cache, x, 0, "all")
    spread = (logits.amax(-1) - logits.amin(-1)).cpu()
    return float(spread.min()), float(spread.median())


def cut_card_vs_cpu(label, cfg, load, tokens):
    """A model cut to CUT_LAYERS layers (full width, embedding and
    classifier; `load(device)` gives its params): CUT_TOKENS tokens scored
    on the card and on the CPU's plain versions.  Returns (card NLL, CPU
    NLL)."""
    from torch_perplexity import score_tokens

    out = []
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        r = score_tokens(cfg, load(device), tokens[:CUT_TOKENS],
                         chunk=PPL_CHUNK)
        out.append(r["nll_per_token"])
        log(f"  {label}, {CUT_LAYERS} layers, {CUT_TOKENS} tokens on "
            f"{device}: NLL/token {r['nll_per_token']!r} "
            f"({time.perf_counter() - t0:.1f} s)")
    diff = abs(out[0] - out[1])
    if diff > CUT_TOL:
        raise RuntimeError(f"{label}: card NLL {out[0]} against the CPU's "
                           f"{out[1]}: {diff} > {CUT_TOL}")
    return out


def offline_phase(torch, work: Path):
    """Phase 6: Llama-3.2-1B at full width and depth from a BF16
    checkpoint through the port's exporter to Q8_0 and Q4_0, scored on the
    card; the perplexity CLI, the native tokenizer and the desktop app."""
    import asyncio
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import numpy as np

    sys.path.insert(0, str(HERE / "scripts"))
    from lmrs_tpu_torch.cli.desktop import _PageHandler
    from lmrs_tpu_torch.config import ModelType, QuantType, llama32_1b
    from lmrs_tpu_torch.io.export import gather_weights
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import params_from_lmrs, params_from_weights
    from lmrs_tpu_torch.io.safetensors import SafetensorsSource
    from lmrs_tpu_torch.kernels import launches, reset_launches
    from lmrs_tpu_torch.serve.backend import BackendServer
    from lmrs_tpu_torch.tokenizer import Tokenizer

    t_phase = time.perf_counter()
    cfg = llama32_1b()
    t0 = time.perf_counter()
    ckpt, cfg_path = llama_checkpoint(torch, cfg, work)
    log(f"  wrote a BF16 checkpoint of {ckpt.stat().st_size / 1e9:.3f} GB "
        f"in {time.perf_counter() - t0:.1f} s (embedding std "
        f"{CKPT_EMBED_STD}/sqrt({cfg.dim}), matrices {CKPT_STD}, norms 1 "
        f"+ N(0, {CKPT_NORM_STD}))")
    files, exports = {}, {}
    for qt, name in ((1, "Q8_0"), (2, "Q4_0")):
        files[name] = work / f"llama1b_{name.lower()}.lmrs"
        secs, max_err, mean_err = export_cli(
            ckpt, cfg_path, files[name].with_suffix(""), qt)
        exports[name] = dict(export_s=secs, max_group_error=max_err,
                             mean_group_error=mean_err,
                             lmrs_gb=files[name].stat().st_size / 1e9)
        log(f"  export {name}: {secs:.1f} s, "
            f"{exports[name]['lmrs_gb']:.3f} GB, group error max {max_err}"
            f", mean {mean_err}")
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, PPL_TOKENS)
    np.save(work / "ids.npy", tokens)
    paths = {}
    tag = f"{LLAMA1B} {PPL_TOKENS} tokens, chunk {PPL_CHUNK}"

    # f32: the checkpoint's dense weights, not exported
    t0 = time.perf_counter()
    weights = gather_weights(SafetensorsSource([str(ckpt)]), ModelType.LLAMA,
                             cfg.n_layers)
    cfg32 = read_lmrs(str(files["Q8_0"])).cfg.replace(quant=QuantType.NONE)
    params = params_from_weights(cfg32, weights, device="cuda")
    log(f"  f32 weights read and loaded in {time.perf_counter() - t0:.1f} s")
    label = f"{tag}: f32 weights, f32 cache"
    paths[label] = scored(torch, label, F32_SCORE, cfg32, params, tokens,
                          chunk=PPL_CHUNK)
    spread = logit_spread(torch, cfg32, params, tokens)
    paths[label].update(logit_spread_min=spread[0],
                        logit_spread_median=spread[1])
    log(f"  f32 logits spread across the vocabulary: least {spread[0]:.3f},"
        f" median {spread[1]:.3f} (ln V = {math.log(cfg.vocab_size):.4f})")
    if spread[0] < 1.0:
        raise RuntimeError(f"f32 logits sit flat: a row spreads {spread[0]}")
    del params
    torch.cuda.empty_cache()
    nll32 = paths[label]["nll_per_token"]
    # the cut model card against the CPU: with f32 weights (no B or F) the
    # difference is the attention's rounding alone, the floor under the
    # Q8_0 and Q4_0 readings below
    cut32 = cfg32.replace(n_layers=CUT_LAYERS)
    card, cpu = cut_card_vs_cpu(
        f"{LLAMA1B} f32", cut32,
        lambda dev: params_from_weights(cut32, weights, device=dev), tokens)
    paths[label].update(cut_card_nll=card, cut_cpu_nll=cpu,
                        cut_abs_diff=abs(card - cpu))
    del weights

    for name, expect in (("Q8_0", Q8_SCORE), ("Q4_0", Q4_SCORE)):
        f = read_lmrs(str(files[name]))
        params = params_from_lmrs(f, device="cuda")
        label = f"{tag}: {name} weights, f32 cache"
        paths[label] = scored(torch, label, expect, f.cfg, params, tokens,
                              chunk=PPL_CHUNK)
        delta = paths[label]["nll_per_token"] - nll32
        paths[label].update(delta_vs_f32=delta, **exports[name])
        log(f"  {name}: NLL delta against f32 {delta:+.6f}")
        if abs(delta) >= PPL_MATCHED:
            raise RuntimeError(f"{name}: NLL delta {delta} against f32, "
                               f"not matched (< {PPL_MATCHED})")
        if name == "Q8_0":
            nll8 = paths[label]["nll_per_token"]
            for cache, kernels in CACHE_SCORE.items():
                clabel = f"{tag}: Q8_0 weights, {cache} cache"
                paths[clabel] = scored(torch, clabel, kernels, f.cfg, params,
                                       tokens, f32_cache=False,
                                       chunk=PPL_CHUNK, cache_dtype=cache)
                d = paths[clabel]["nll_per_token"] - nll8
                paths[clabel]["delta_vs_f32_cache"] = d
                log(f"  Q8_0, {cache} cache: NLL delta against the f32 "
                    f"cache {d:+.6f}")
                if abs(d) >= PPL_MATCHED:
                    raise RuntimeError(f"{cache} cache: NLL delta {d}")
            clabel = f"{LLAMA1B} {PPL_TOKENS} tokens, chunk 256: Q8_0 " \
                     "weights, f32 cache"
            paths[clabel] = scored(torch, clabel, Q8_SCORE, f.cfg, params,
                                   tokens, chunk=256)
            d = paths[clabel]["nll_per_token"] - nll8
            paths[clabel]["delta_vs_chunk_128"] = d
            log(f"  Q8_0, chunk 256 against chunk 128: {d:+.3e}")
            if abs(d) >= CHUNK_TOL:
                raise RuntimeError(f"chunk 256 against 128: {d}")
        del params
        torch.cuda.empty_cache()
    log(f"  NLL per token: f32 {nll32:.6f}, Q8_0 {nll8:.6f}, Q4_0 "
        f"{paths[f'{tag}: Q4_0 weights, f32 cache']['nll_per_token']:.6f};"
        f" ln V = {math.log(cfg.vocab_size):.6f}")

    # the perplexity CLI on the exported Q8_0 file
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, str(HERE / "scripts" / "torch_perplexity.py"),
         "--model", str(files["Q8_0"]), "--tokens", str(work / "ids.npy")],
        capture_output=True, text=True, timeout=600, cwd=str(HERE))
    if cli.returncode != 0:
        raise RuntimeError(f"torch_perplexity.py exit {cli.returncode}:\n"
                           f"{cli.stderr[-4000:]}")
    last = cli.stdout.strip().splitlines()[-1]
    want = f"nll/tok {nll8:.9f}  over {PPL_TOKENS - 1} tok"
    log(f"  scripts/torch_perplexity.py in {time.perf_counter() - t0:.1f} "
        f"s: {last!r}")
    if not last.endswith(want):
        raise RuntimeError(f"the CLI printed {last!r}, in process {want!r}")

    # the exported files cut to 2 layers, card against the CPU's plain
    # versions: B and F against their plain arithmetic in a whole model
    for name, path in files.items():
        f = read_lmrs(str(path))
        f.cfg = f.cfg.replace(n_layers=CUT_LAYERS)   # layers 0, 1 load
        card, cpu = cut_card_vs_cpu(
            f"{LLAMA1B} {name}", f.cfg,
            lambda dev, f=f: params_from_lmrs(f, device=dev), tokens)
        paths[f"{tag}: {name} weights, f32 cache"].update(
            cut_card_nll=card, cut_cpu_nll=cpu, cut_abs_diff=abs(card - cpu))

    # the native tokenizer on a 128,256-token vocabulary
    tok_path = work / "tokenizer.bin"
    synthetic_tokenizer(tok_path, cfg.vocab_size, merges=True)
    tok = Tokenizer.from_file(str(tok_path))
    if tok._native is None:
        raise RuntimeError("the native tokenizer engine did not attach")
    plain = Tokenizer.from_file(str(tok_path), native=False)
    words = list(SMOKE_WORDS) + [" x", "é", "."]
    text = "".join(np.random.default_rng(7).choice(words, 600))
    t0 = time.perf_counter()
    ids = tok.encode(text)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids_plain = plain.encode(text)
    plain_s = time.perf_counter() - t0
    log(f"  tokenizer ({cfg.vocab_size} tokens): {len(text)} characters -> "
        f"{len(ids)} ids, native merge {1e3 * native_s:.1f} ms, Python "
        f"{1e3 * plain_s:.1f} ms")
    if ids != ids_plain:
        raise RuntimeError("native and Python merges differ")

    # the desktop app: the page, then one turn through the backend
    _PageHandler.ws_port = 5000
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _PageHandler)
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{httpd.server_address[1]}",
                timeout=30) as r:
            page = r.read().decode()
    finally:
        httpd.shutdown()
        server_thread.join(30)
    if "const WS_PORT = 5000;" not in page or "WebSocket" not in page:
        raise RuntimeError("the desktop page is not served")
    server = BackendServer(str(files["Q8_0"]), str(tok_path),
                           temperature=0.0, max_new_tokens=32)
    server.warmup()
    conn = Conn([json.dumps({"text": "hello from the smoke run"})])
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    asyncio.run(server.handle(conn))
    torch.cuda.synchronize()
    turn_s = time.perf_counter() - t0
    counts = launches()
    launched = {k for k, n in counts.items() if n > 0}
    pieces = [m for m in conn.sent if m["category"] == "OUTPUT"
              and m["text"] != "<eos>"]
    if (conn.sent[-1] != {"category": "OUTPUT", "text": "<eos>"}
            or not pieces or any(m["category"] == "STATUS"
                                 for m in conn.sent)):
        raise RuntimeError(f"desktop turn: {conn.sent[:8]}")
    log(f"  desktop page served ({len(page)} bytes); one turn through "
        f"BackendServer.handle: {len(pieces)} pieces in {turn_s:.2f} s; "
        f"launches {counts}")
    if launched != Q8_PATH:
        raise RuntimeError(f"desktop turn: kernels launched "
                           f"{sorted(launched)}, expected {sorted(Q8_PATH)}")
    server.shutdown()
    del server
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 6 ran {phase_s:.1f} s")
    paths[f"{LLAMA1B} Q8_0 desktop turn, bf16 cache"] = dict(
        launches=counts, turn_s=turn_s, pieces=len(pieces),
        tokenizer_native_ms=1e3 * native_s, tokenizer_python_ms=1e3 * plain_s,
        tokenizer_ids=len(ids), phase_s=phase_s)
    return paths


# the mesh paths (phase 7): kernel sets summed over every rank of a run
MESH_TP = Q8_PATH
MESH_TP_I8 = Q8_I8_PATH
# cp: a prefill chunk's attention is plain torch ops (the JAX package's
# attention_cp is XLA), a decode step's is B1 (kernel I's split pass with
# the shard's row base, its own count, then M's raw merge); no C
MESH_CP = {"q8_gemv_i8", "q8_gemv", "q8_gemm", "flash_attention_batched",
           "flash_attention_batched_lse", "flash_merge"}
# the paged mesh and dp schedulers: a prompt tail of up to 8 rows and the
# 8-row decode steps take D, the classifier E, prefill chunks F
MESH_PAGED = {"q8_gemv_i8", "q8_gemv", "q8_gemm", "flash_attention_paged",
              "flash_merge"}
P7_NEW = 32
P7_NOTE = ("ranks time-sharing one card over gloo: correctness, not a "
           "scaling figure")


def mesh_counts(stats):
    """The launch counts of a mesh run summed over its ranks, and the
    kernels each rank launched."""
    per_rank = stats["launches"]
    total = {k: sum(r[k] for r in per_rank) for k in per_rank[0]}
    return total, [{k for k, n in r.items() if n} for r in per_rank]


def mesh_report(torch, label, mesh, expect, t0, extra=None):
    """Read a mesh run's per-rank stats (set to 0 by mesh.reset_stats()
    just before it), check the kernel set of the sum against `expect`,
    log the peak memory per rank, and return the result record."""
    torch.cuda.synchronize()
    stats = mesh.stats()
    total, per_rank = mesh_counts(stats)
    launched = {k for k, n in total.items() if n}
    res = dict(launches=total, launches_per_rank=stats["launches"],
               peak_memory_gb_per_rank=[b / 1e9 for b in
                                        stats["peak_bytes"]],
               collectives_per_rank=stats["collectives"],
               collective_s_per_rank=stats["collective_s"],
               seconds=time.perf_counter() - t0, note=P7_NOTE,
               **(extra or {}))
    log(f"  {label}: launches summed over {len(per_rank)} ranks {total}; "
        f"peak memory per rank "
        f"{[round(g, 2) for g in res['peak_memory_gb_per_rank']]} GB; "
        f"collectives per rank {stats['collectives']} "
        f"({[round(s, 2) for s in stats['collective_s']]} s host)")
    if launched != expect:
        raise RuntimeError(f"{label}: kernels launched {sorted(launched)}, "
                           f"expected {sorted(expect)}")
    return res, per_rank


def decode_collectives(torch, engine, prompt):
    """After one prefill of `prompt`: one decode step (one mesh call at a
    host position) and then one decode chunk (engine.decode_chunk steps,
    one mesh call), each read from rank 0's stats: the step's collectives,
    their host ms and its ms; the chunk's collectives and broadcasts a
    token, their host ms a token and its ms a token (host clock,
    synchronized).  The reading call's own header broadcast is left out
    of the chunk's figures (the step's figure keeps it)."""
    from lmrs_tpu_torch.runtime.engine import GenerationConfig

    mesh = engine.mesh
    engine.reset()
    tok = int(torch.argmax(engine.prefill(prompt)))
    torch.cuda.synchronize()
    mesh.reset_stats()
    t0 = time.perf_counter()
    logits = engine.decode_step(tok)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    st = mesh.stats()
    step = dict(collectives=st["collectives"][0],
                collective_ms=1e3 * st["collective_s"][0], step_ms=step_ms)
    n = engine.decode_chunk
    tok = torch.argmax(logits).reshape(1)
    torch.cuda.synchronize()
    mesh.reset_stats()
    t0 = time.perf_counter()
    engine._decode_chunk(tok, engine.pos, n,
                         GenerationConfig(temperature=0.0), None, 0)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    st = mesh.stats()
    engine.reset()
    chunk = dict(steps=n, collectives_per_token=(st["collectives"][0] - 1) / n,
                 broadcasts=st["broadcasts"][0] - 1,
                 collective_ms_per_token=1e3 * st["collective_s"][0] / n,
                 ms_per_token=ms / n)
    return step, chunk


def mesh_generate(torch, label, mesh, cfg, prompt, n, want, ref_engine,
                  expect, cache_dtype=None, spec_k=0, twice=False):
    """A mesh Engine on `mesh`, decoding in mesh chunks of 8 steps (one
    call a chunk, every rank sampling): greedy (`twice`: twice across
    reset(), identical), against the one-device engine's greedy tokens
    (its chunk path) `want` up to
    the first near-tie (NEAR_TIE_W8A8: the mesh sums partial products in another
    order, and a last-bit difference can flip a W8A8 quantizer's rounding
    step); the kernel set summed over the ranks exact."""
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

    engine = Engine(cfg, mesh.params, mesh=mesh,
                    cache_dtype=cache_dtype or torch.bfloat16)
    gen = GenerationConfig(temperature=0.0, max_new_tokens=n,
                           speculative_k=spec_k)
    t0 = time.perf_counter()
    mesh.reset_stats()
    toks = engine.generate(prompt, gen)
    m = engine.metrics
    engine.reset()
    again = engine.generate(prompt, gen) if twice else toks
    res, per_rank = mesh_report(torch, label, mesh, expect, t0, dict(
        ttft_ms=1e3 * m.ttft_seconds, decode_tok_s=m.tokens_per_second,
        prefill_tok_s=m.prefill_tokens_per_second))
    log(f"    TTFT {res['ttft_ms']:.1f} ms, prefill "
        f"{res['prefill_tok_s']:.1f} tok/s, decode "
        f"{res['decode_tok_s']:.2f} tok/s ({P7_NOTE}); tokens {toks[:10]}...")
    if again != toks:
        raise RuntimeError(f"{label}: greedy differs across reset()")
    if spec_k and not 0 < m.spec_accepted < m.spec_proposed:
        raise RuntimeError(f"{label}: speculative accepted {m.spec_accepted}"
                           f" of {m.spec_proposed}: both branches must run")
    res["greedy_tokens_compared"] = check_greedy(
        torch, label, ref_engine, prompt, toks, want, NEAR_TIE_W8A8)
    return res, engine, toks, per_rank


def mesh_wave(torch, label, server, prompts, sampling, refs, ref_engine,
              expect):
    """One wave through a BackendServer's scheduler(s): all at once, every
    greedy stream against the one-device Engine's (NEAR_TIE_W8A8); the
    kernel set of the run exact (summed over the server's mesh's ranks, or
    this process's counts for the dp replicas).  Under --dp every request
    first takes a conversation lease through the backend's own lease path,
    as a connection does when it opens, then submits its turn on the
    leased replica's thread; returns the result record and the replica
    each lease went to."""
    from lmrs_tpu_torch.kernels import launches, reset_launches

    mesh = server.mesh
    t0 = time.perf_counter()
    if mesh is not None:
        mesh.reset_stats()
    reset_launches()
    placed = []
    if server.router is not None:       # dp: the replicas' threads at once
        import threading

        leases = [server.lease() for _ in prompts]
        if any(lease is None for _, lease in leases):
            raise RuntimeError(f"{label}: no free slot for a lease")
        placed = [server.threads.index(thread) for thread, _ in leases]
        events, reqs = [], []
        for p, (t, tp), (thread, lease) in zip(prompts, sampling, leases):
            ev = threading.Event()
            reqs.append(thread.submit(p, max_new_tokens=P7_NEW,
                                      temperature=t, top_p=tp, lease=lease,
                                      on_done=lambda o, e=ev: e.set()))
            events.append(ev)
        for e in events:
            if not e.wait(600):
                raise RuntimeError(f"{label}: a request did not finish")
        wall = max(r.done_time for r in reqs) - t0
        for r in reqs:
            if r.error is not None or len(r.out) != P7_NEW:
                raise RuntimeError(f"request {r.id}: error {r.error!r}, "
                                   f"{len(r.out)} tokens")
        for thread, lease in leases:
            thread.call(lambda s=thread.sched, z=lease:
                        s.end_conversation(z))
    else:
        reqs, wall = serve_wave(server.scheduler, prompts, sampling, P7_NEW)
    m = wave_metrics(reqs, wall)
    if mesh is not None:
        res, _ = mesh_report(torch, label, mesh, expect, t0, m)
    else:
        torch.cuda.synchronize()
        counts = launches()
        launched = {k for k, n in counts.items() if n}
        res = dict(launches=counts, seconds=time.perf_counter() - t0, **m)
        if launched != expect:
            raise RuntimeError(f"{label}: kernels launched "
                               f"{sorted(launched)}, expected "
                               f"{sorted(expect)}")
    log(f"    wave of {len(reqs)}: {m['tokens']} tokens in {wall:.2f} s = "
        f"{m['aggregate_tok_s']:.1f} tok/s aggregate, TTFT "
        f"{[round(x['ttft_ms']) for x in m['per_request']]} ms ({P7_NOTE})")
    res["greedy_tokens_compared"] = sum(
        check_greedy(torch, label, ref_engine, r.prompt, r.out,
                     refs[tuple(r.prompt)], NEAR_TIE_W8A8)
        for r, (t, _) in zip(reqs, sampling) if t == 0.0)
    return res, placed


def server_on_mesh(BackendServer, path, work, **kw):
    """BackendServer(--batch with --tp or --cp) on the phase's file: it
    starts the mesh of its ranks itself, as `serve.backend --tp` does."""
    t0 = time.perf_counter()
    server = BackendServer(str(path), str(work / "tok.bin"), max_ctx=2048,
                           max_new_tokens=P7_NEW, **kw)
    log(f"  BackendServer({kw}) up in {time.perf_counter() - t0:.1f} s; "
        f"load s per rank "
        f"{[round(s, 2) for s in server.mesh.load_seconds]}")
    return server


def parallel_phase(torch, work: Path):
    """Phase 7: tensor, context and data parallelism on Llama-3.2-3B Q8_0
    at full width and depth, every rank a process of its own on this one
    card over gloo (module note)."""
    from lmrs_tpu_torch.config import QuantType, llama32_3b
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import params_from_lmrs
    from lmrs_tpu_torch.io.synthetic import write_synthetic_lmrs
    from lmrs_tpu_torch.parallel.distributed import Mesh, choose_backend
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig
    from lmrs_tpu_torch.serve.backend import BackendServer

    t_phase = time.perf_counter()
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    log(f"  compute mode {mode}; backend "
        f"{choose_backend(torch.device('cuda'), 2)} for the 2 and 4 ranks "
        f"of this phase on {torch.cuda.device_count()} card(s)")
    if "Exclusive_Process" in mode:
        raise RuntimeError("compute mode Exclusive_Process: a second "
                           "process cannot open a context on the card")
    path = work / "parallel.lmrs"
    write_synthetic_lmrs(str(path), llama32_3b(quant=QuantType.Q8_0), seed=0)
    synthetic_tokenizer(work / "tok.bin", LLAMA["V"])
    f = read_lmrs(str(path))
    cfg = f.cfg
    params = params_from_lmrs(f, device="cuda")
    rng = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (1024,), generator=rng).tolist()
    rng = torch.Generator().manual_seed(1)
    long = torch.randint(0, cfg.vocab_size, (5000,), generator=rng).tolist()
    greedy = GenerationConfig(temperature=0.0, max_new_tokens=P7_NEW)
    ref = {}
    ref_engines = {}
    for what, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        ref_engines[what] = Engine(cfg, params, cache_dtype=dtype)
        ref[what] = ref_engines[what].generate(prompt, greedy)
    one = ref_engines["bf16"]
    one.reset()
    ref["long"] = one.generate(long, greedy)
    log(f"  one-device references: {ref['bf16'][:8]}... (int8 "
        f"{ref['int8'][:8]}..., 5,000-token prompt {ref['long'][:8]}...)")
    paths, shapes = {}, {}

    # ---- tp = 2: Engine (bf16, int8, speculative), session, scheduler
    t0 = time.perf_counter()
    mesh = Mesh.start(f, tp=2)
    shapes["tp=2"] = dict(load_s_per_rank=mesh.load_seconds,
                          start_s=time.perf_counter() - t0)
    log(f"  tp=2 mesh up in {shapes['tp=2']['start_s']:.1f} s; load s per "
        f"rank {[round(s, 2) for s in mesh.load_seconds]}")
    try:
        label = "llama3.2-3b Q8_0 tp=2 bf16 cache"
        res, engine, toks, _ = mesh_generate(
            torch, label, mesh, cfg, prompt, P7_NEW, ref["bf16"], one,
            MESH_TP, twice=True)
        res["decode_step"], res["decode_chunk"] = decode_collectives(
            torch, engine, prompt)
        log(f"    one decode step: {res['decode_step']}")
        log(f"    one decode chunk: {res['decode_chunk']}")
        paths[label] = res
        label = "llama3.2-3b Q8_0 tp=2 bf16 cache, speculative k=4"
        paths[label], _, _, _ = mesh_generate(
            torch, label, mesh, cfg, prompt, P7_NEW, ref["bf16"], one,
            MESH_TP, spec_k=4)
        # a session saved on tp = 2, continued on one device
        gen16 = GenerationConfig(temperature=0.0, max_new_tokens=16)
        engine.reset()
        engine.generate(prompt, gen16)
        spath = work / "tp2_session.npz"
        t0 = time.perf_counter()
        engine.save_session(str(spath))
        save_s = time.perf_counter() - t0
        saved_pos = engine.pos
        single = Engine(cfg, params)
        single.load_session(str(spath))
        spath.unlink()
        want = engine.generate(prompt[:8], gen16)
        got = single.generate(prompt[:8], gen16)
        log(f"  tp=2 session: saved in {save_s:.2f} s at pos {saved_pos}, "
            f"continued on one device {got[:8]}...")
        if got != want:
            raise RuntimeError(f"tp=2 session continues {got} on one device,"
                               f" {want} on tp=2")
        res["session_to_one_device"] = dict(save_s=save_s, pos=saved_pos,
                                            continued=got)
        engine.close()
        del single
        label = "llama3.2-3b Q8_0 tp=2 int8 cache"
        paths[label], engine, _, _ = mesh_generate(
            torch, label, mesh, cfg, prompt, P7_NEW, ref["int8"],
            ref_engines["int8"], MESH_TP_I8, cache_dtype=torch.int8)
        engine.close()
    finally:
        mesh.shutdown()

    # ---- the mesh scheduler: BackendServer(batch=8, tp=2), its own mesh
    rng = torch.Generator().manual_seed(7)
    wave = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
            for n in (128, 150, 192, 200, 256, 130, 170, 240)]
    sampling = [(0.0, 0.9)] * 6 + [(0.7, 0.9)] * 2
    refs = {}
    for p in wave[:6]:
        one.reset()
        refs[tuple(p)] = one.generate(p, greedy)
    server = server_on_mesh(BackendServer, path, work, batch=8, tp=2)
    try:
        label = "llama3.2-3b Q8_0 tp=2 batch 8, paged bf16 pool"
        paths[label], _ = mesh_wave(torch, label, server, wave, sampling,
                                    refs, one, MESH_PAGED)
    finally:
        server.shutdown()

    # ---- cp = 2: Engine on a 5,000-token prompt, then the scheduler
    t0 = time.perf_counter()
    mesh = Mesh.start(f, cp=2)
    shapes["cp=2"] = dict(load_s_per_rank=mesh.load_seconds,
                          start_s=time.perf_counter() - t0)
    log(f"  cp=2 mesh up in {shapes['cp=2']['start_s']:.1f} s")
    try:
        label = "llama3.2-3b Q8_0 cp=2 bf16 cache, 5,000-token prompt"
        res, engine, _, per_rank = mesh_generate(
            torch, label, mesh, cfg, long, P7_NEW, ref["long"], one, MESH_CP)
        if not all("flash_attention_batched_lse" in r for r in per_rank) \
                or any("flash_attention" in r for r in per_rank):
            raise RuntimeError(f"{label}: B1 must launch on both ranks and "
                               f"C on neither: {per_rank}")
        res["decode_step"], res["decode_chunk"] = decode_collectives(
            torch, engine, long)
        log(f"    one decode step: {res['decode_step']}")
        log(f"    one decode chunk: {res['decode_chunk']}")
        paths[label] = res
        engine.close()
    finally:
        mesh.shutdown()
    # BackendServer(batch=4, cp=2): no paged pool under cp
    server = server_on_mesh(BackendServer, path, work, batch=4, cp=2)
    try:
        if server.scheduler.sched.paged:
            raise RuntimeError("--batch with --cp took the paged pool")
        label = "llama3.2-3b Q8_0 cp=2 batch 4, per-slot bf16 cache"
        paths[label], _ = mesh_wave(torch, label, server, wave[:4],
                                    sampling[:4], refs, one, MESH_CP)
    finally:
        server.shutdown()

    # ---- tp 2 x cp 2: four ranks
    t0 = time.perf_counter()
    mesh = Mesh.start(f, tp=2, cp=2)
    shapes["tp=2 x cp=2"] = dict(load_s_per_rank=mesh.load_seconds,
                                 start_s=time.perf_counter() - t0)
    log(f"  tp=2 x cp=2 mesh up in {shapes['tp=2 x cp=2']['start_s']:.1f} s")
    try:
        label = "llama3.2-3b Q8_0 tp=2 x cp=2 bf16 cache"
        res, engine, _, _ = mesh_generate(torch, label, mesh, cfg, prompt, 16,
                                          ref["bf16"][:16], one, MESH_CP)
        res["decode_step"], res["decode_chunk"] = decode_collectives(
            torch, engine, prompt)
        log(f"    one decode step: {res['decode_step']}")
        log(f"    one decode chunk: {res['decode_chunk']}")
        paths[label] = res
        engine.close()
    finally:
        mesh.shutdown()

    # ---- dp = 2 over tp = 1: two replicas on this card behind the router
    server = BackendServer(str(path), str(work / "tok.bin"), batch=8, dp=2,
                           max_ctx=2048, max_new_tokens=P7_NEW)
    try:
        label = "llama3.2-3b Q8_0 dp=2 batch 8, paged bf16 pools"
        paths[label], placed = mesh_wave(torch, label, server, wave,
                                         sampling, refs, one, MESH_PAGED)
        counts = [sched.tokens_emitted for sched in server.router.replicas]
        per_replica = [placed.count(i) for i in range(2)]
        log(f"    leases placed on replicas {placed}; tokens per replica "
            f"{counts}")
        if per_replica != [4, 4] or counts != [4 * P7_NEW, 4 * P7_NEW]:
            raise RuntimeError(f"{label}: the router placed {per_replica} "
                               f"requests, {counts} tokens")
        paths[label]["requests_per_replica"] = per_replica
    finally:
        server.shutdown()
    del server
    torch.cuda.empty_cache()

    # ---- the chat CLI with --tp 2
    cli_counts = drive_cli("llama3.2-3b Q8_0 --tp 2", path, work / "tok.bin",
                           MESH_TP, ("--tp", "2"))
    del one, ref_engines
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 7 ran {phase_s:.1f} s; mesh shapes {json.dumps(shapes)}")
    for p in paths.values():
        p.setdefault("phase_s", phase_s)
    return (paths, {"llama3.2-3b Q8_0 --tp 2": cli_counts},
            dict(cfg=cfg, params=params, prompt=prompt, ref=ref["bf16"]))


# phase 8: the decode chunk at full depth (phase 7's Llama-3.2-3B Q8_0 on
# one device): plain decode through chunks of 1 and of 8 steps, read at
# the end or streamed, and speculation k = 4
P8_NEW = 65


def decode_phase(torch, cfg, params, prompt, ref):
    """Phase 8: Llama-3.2-3B Q8_0 at full width and depth (28 layers),
    phase 7's file and loaded params, one device, bf16 cache, a 1,024-token
    prompt and 65 tokens a run.  Plain greedy decode with decode_chunk 1
    and 8, each without streaming (one read at the end) and streaming
    (on_token: a chunk is drained after the next is dispatched), in two
    turns, the second in the reverse order: decode tok/s and host ms a
    token (the host clock inside the engine's chunk
    dispatch, which never waits for the device unless the launch queue is
    full), every run's tokens equal and equal to phase 7's one-device
    reference; then speculative greedy, k = 4, chunks of 8 verify steps:
    tokens a verify step, decode tok/s, host ms a token, tokens equal to
    plain greedy up to a near-tie (NEAR_TIE).  The launch counts are set
    to 0 before the runs and read after: D, E, F, C and M exactly."""
    from lmrs_tpu_torch.kernels import launches, reset_launches
    from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

    t_phase = time.perf_counter()
    engine = Engine(cfg, params)
    engine.warmup()
    gen = GenerationConfig(temperature=0.0, max_new_tokens=P8_NEW)
    spent = [0.0, 0]

    def timed(fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            spent[0] += time.perf_counter() - t0
            spent[1] += a[2]          # the chunk's steps
            return out
        return call

    engine._decode_chunk = timed(engine._decode_chunk)
    engine._spec_chunk = timed(engine._spec_chunk)
    runs, toks = {}, []
    reset_launches()
    # two turns, the second in the reverse order: the host clock spreads
    # between runs, so each setting is read twice
    order = [(n, streaming) for n in (1, 8) for streaming in (False, True)]
    for n, streaming in order + order[::-1]:
        engine.decode_chunk = n
        engine.reset()
        spent[:] = [0.0, 0]
        seen = []
        toks.append(engine.generate(
            prompt, gen, on_token=seen.append if streaming else None))
        m = engine.metrics
        what = (f"decode_chunk {n}, "
                f"{'streaming' if streaming else 'read at the end'}")
        run = runs.setdefault(what, dict(decode_tok_s=[],
                                         host_ms_per_token=[]))
        run["decode_tok_s"].append(m.tokens_per_second)
        run["host_ms_per_token"].append(1e3 * spent[0] / spent[1])
        log(f"  {what}: decode {m.tokens_per_second:.2f} tok/s, host "
            f"{run['host_ms_per_token'][-1]:.2f} ms a token in the "
            f"dispatch ({spent[1]} steps dispatched)")
        if streaming and seen != toks[-1]:
            raise RuntimeError(f"phase 8 {what}: on_token saw {seen}")
    if any(t != toks[0] for t in toks) or toks[0][:32] != ref:
        raise RuntimeError(f"phase 8: the runs' greedy tokens differ: "
                           f"{[t[:12] for t in toks]}, phase 7 {ref[:12]}")
    k = 4
    engine.decode_chunk = 8
    engine.reset()
    spent[:] = [0.0, 0]
    spec = engine.generate(prompt, GenerationConfig(
        temperature=0.0, max_new_tokens=P8_NEW, speculative_k=k))
    m = engine.metrics
    steps = m.spec_proposed // k
    runs["speculative k=4, chunks of 8"] = dict(
        decode_tok_s=m.tokens_per_second, tokens_per_verify_step=(
            m.decode_tokens / steps), verify_steps=steps,
        acceptance=m.spec_accepted / m.spec_proposed,
        host_ms_per_token=1e3 * spent[0] / m.decode_tokens)
    log(f"  speculative k=4: {m.decode_tokens / steps:.2f} tokens a verify "
        f"step ({steps} steps), decode {m.tokens_per_second:.2f} tok/s, "
        f"{m.spec_accepted}/{m.spec_proposed} drafts accepted")
    torch.cuda.synchronize()
    counts = launches()
    n_eq = check_greedy(torch, "phase 8 speculative k=4", engine, prompt,
                        spec, toks[0], NEAR_TIE)
    launched = {name for name, c in counts.items() if c}
    if launched != Q8_PATH:
        raise RuntimeError(f"phase 8: kernels launched {sorted(launched)}, "
                           f"expected {sorted(Q8_PATH)}")
    del engine
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    log(f"  phase 8 ran {phase_s:.1f} s")
    return {"llama3.2-3b Q8_0 28 layers, decode chunks (phase 8)": dict(
        launches=counts, runs=runs, speculative_tokens_compared=n_eq,
        phase_s=phase_s)}


def load_model(torch, work: Path, cfg):
    """Write the synthetic .lmrs of `cfg` (seed 0) and load it onto the
    card; returns (path, config as read, params, load seconds)."""
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import params_from_lmrs
    from lmrs_tpu_torch.io.synthetic import write_synthetic_lmrs

    path = work / "model.lmrs"
    t0 = time.perf_counter()
    write_synthetic_lmrs(str(path), cfg, seed=0)
    log(f"  wrote {path.stat().st_size / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    f = read_lmrs(str(path))
    params = params_from_lmrs(f, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"  loaded in {load_s:.2f} s")
    return path, f.cfg, params, load_s


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (HERE / "lmrs_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    t_run = time.perf_counter()

    # ---- 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    card_line = smi.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    if kind not in PEAKS:
        raise RuntimeError(f"no data-sheet peaks for {kind!r}: add them to "
                           f"PEAKS to compute the bounds")
    peak = PEAKS[kind]
    log(f"card: {card_line}  (peaks used: {kind} data sheet, "
        f"{peak['mem'] / 1e12:.2f} TB/s, {peak['bf16'] / 1e12:.0f} TFLOP/s "
        f"bf16, {peak['f32'] / 1e12:.0f} TFLOP/s f32, "
        f"{peak['int8'] / 1e12:.0f} TOP/s int8)")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    from lmrs_tpu_torch.kernels import cuda

    t0 = time.perf_counter()
    build = cuda.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s into {build}")
    for name in cuda.SOURCES:
        regs = [ln.strip() for ln in (build / f"{name}.log").read_text()
                .splitlines() if "registers" in ln]
        log(f"  {name}: {regs[0] if regs else 'built earlier'}")

    cases, row_independent = [], {}
    # ---- 2. kernels against their plain versions
    timer = Timer(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("phase 2: kernels vs plain versions at Gemma-2-9B shapes (A, K, L, "
        "B, C)")
    cases = check_matmul_kernels(torch, timer, peak, GEMMA, "q4")
    cases += check_ffn_kernels(torch, timer, peak, GEMMA, "q4")
    cases += check_flash_kernel(torch, timer, peak, GEMMA, "bf16")
    cases += check_flash_kernel(torch, timer, peak, GEMMA, "int4")
    log("phase 2: kernels vs plain versions at Llama-3.2-3B shapes "
        "(D, E, F, K, L, C, C on f32, G, H)")
    check_act_quant(torch, torch.Generator(device="cuda").manual_seed(2))
    cases += check_matmul_kernels(torch, timer, peak, LLAMA, "q8")
    cases += check_ffn_kernels(torch, timer, peak, LLAMA, "q8")
    for cache in ("bf16", "f32", "int8", "int4"):
        cases += check_flash_kernel(torch, timer, peak, LLAMA, cache)
    log("phase 2: per-slot and paged flash (I, J) at both models' shapes, "
        f"B = {len(BATCH_POS)} slots at {BATCH_POS}")
    for model in (GEMMA, LLAMA):
        for cache in ("bf16", "f32", "int8", "int4"):
            cases += check_batched_kernels(torch, timer, peak, model, cache)
    log("phase 2: kernels vs plain versions at Phi-3.5-mini shapes, phase "
        "5's text model (D, E with its 64-row tail, F; C, I and J at 32 "
        "heads on 32 KV heads, head_dim 96 in 128 lanes)")
    cases += check_matmul_kernels(torch, timer, peak, PHI, "q8")
    cases += check_flash_kernel(torch, timer, peak, PHI, "bf16")
    cases += check_batched_kernels(torch, timer, peak, PHI, "bf16")
    log("phase 2: the cp partials (B1) on 4 sequence shards, and kernel M "
        "on the split pass's workspaces (Gemma-2-9B)")
    cases += check_cp_partials(torch, timer, peak, GEMMA)
    cases += check_cp_partials(torch, timer, peak, GEMMA, n_shards=2,
                               timed=False)
    cases += check_merge(torch, timer, peak, GEMMA)
    log("phase 2: the matmul and fused-FFN kernels at a rank's local "
        "shapes under tp (held, not timed): A, B, K at Gemma-2-9B "
        "tp=2; D, E, F, L at Llama-3.2-3B tp=2 and tp=4")
    cases += check_matmul_kernels(torch, timer, peak,
                                  local_model(GEMMA, 2), "q4",
                                  timed=False)
    cases += check_ffn_kernels(torch, timer, peak, local_model(GEMMA, 2),
                               "q4", timed=False, only=("ffn_fused_xe",))
    for tp in (2, 4):
        cases += check_matmul_kernels(torch, timer, peak,
                                      local_model(LLAMA, tp), "q8",
                                      timed=False)
        cases += check_ffn_kernels(torch, timer, peak,
                                   local_model(LLAMA, tp), "q8",
                                   timed=False, only=("ffn_fused",))
    log("phase 2: is a row of a T=5 call (A: and T=8) the row computed "
        "alone?")
    row_independent = check_row_independence(torch)
    row_independent.update(check_batched_row_independence(torch))
    # A, D, K and the flash kernels promise it by design (one arithmetic
    # path for every T; fixed split rows, a merge in split order): a "no"
    # there fails the run
    promised = {name: ok for name, ok in row_independent.items()
                if name.startswith(("q4_gemv", "q8_gemv_i8", "ffn_fused_xe",
                                    "flash_attention"))}
    if not all(promised.values()):
        raise RuntimeError(f"a kernel breaks row independence: {promised}")
    del timer
    torch.cuda.empty_cache()

    (HERE / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=str(HERE /
                                                              "build")))
    try:
        from lmrs_tpu_torch.config import QuantType, gemma2_9b, llama32_3b

        paths, cli_counts = {}, {}
        tok_path = work / "tokenizer.bin"
        # ---- 3. the Q4_0 main path at full width and depth, bf16 then
        # int4 KV cache (plain, then speculative), and its CLI
        log("phase 3: Gemma-2-9B Q4_0 main path")
        model, cfg, params, load_s = load_model(
            torch, work, gemma2_9b(quant=QuantType.Q4_0).replace(
                n_layers=GEMMA_DEPTH))
        label = "gemma2-9b Q4_0 bf16 cache"
        res, engine, prompt, plain = drive_main_path(
            torch, label, cfg, params, torch.bfloat16, Q4_PATH)
        paths[label] = dict(load_s=load_s, **res)
        # the fused FFN on the same params: single stream, speculation, a
        # batched wave
        label = "gemma2-9b Q4_0 bf16 cache, fuse_ffn"
        res, f_engine, _, f_plain = drive_fused_path(
            torch, label, cfg, params, torch.bfloat16, GEMMA_FUSED,
            GEMMA_FUSED_TOKEN, engine, plain)
        paths[label] = dict(load_s=load_s, **res)
        del engine
        paths[label + ", speculative"] = drive_speculative(
            torch, label, f_engine, prompt, f_plain, GEMMA_FUSED)
        del f_engine
        torch.cuda.empty_cache()
        paths.update(batched_fused(
            torch, "gemma2-9b Q4_0 batch 8, paged bf16 pool, fuse_ffn", cfg,
            params, torch.bfloat16, 8, GEMMA_PAGED_FUSED, NEAR_TIE, seed=13))
        label = "gemma2-9b Q4_0 int4 cache"
        res, engine, prompt, plain = drive_main_path(
            torch, label, cfg, params, "int4", Q4_I4_PATH)
        paths[label] = dict(load_s=load_s, **res)
        paths[label + ", speculative"] = drive_speculative(
            torch, label, engine, prompt, plain, Q4_I4_PATH)
        del params, engine
        torch.cuda.empty_cache()
        synthetic_tokenizer(tok_path, GEMMA["V"])
        cli_counts["gemma2-9b Q4_0 bf16 cache"] = drive_cli(
            "gemma2-9b Q4_0", model, tok_path, Q4_PATH)
        log("phase 3b: Gemma-2-9B Q4_0 batched serving (BackendServer, "
            "batch 8)")
        paths.update(batched_phase_gemma(torch, model, tok_path, cfg))
        model.unlink()

        # ---- 4. the Q8_0 main path, bf16, int8 and int4 KV cache; on the
        # int4 engine speculation and a session; an f32 cache; its CLI
        log("phase 4: Llama-3.2-3B Q8_0 main path")
        model, cfg, params, load_s = load_model(
            torch, work, llama32_3b(quant=QuantType.Q8_0).replace(
                n_layers=LLAMA_DEPTH))
        greedy = {}
        for what, cache_dtype, expect in (
                ("bf16", torch.bfloat16, Q8_PATH),
                ("int8", torch.int8, Q8_I8_PATH),
                ("int4", "int4", Q8_I4_PATH)):
            label = f"llama3.2-3b Q8_0 {what} cache"
            res, engine, prompt, greedy[what] = drive_main_path(
                torch, label, cfg, params, cache_dtype, expect)
            paths[label] = dict(load_s=load_s, **res)
            if what == "int4":
                paths[label + ", speculative"] = drive_speculative(
                    torch, label, engine, prompt, greedy[what], expect)
            del engine
            torch.cuda.empty_cache()
        paths["llama3.2-3b Q8_0 int4 cache"].update(drive_session(
            torch, "llama3.2-3b Q8_0 int4 cache", work, cfg, params, "int4",
            prompt))
        torch.cuda.empty_cache()
        # an f32 cache is rounded to bf16 as it is read: the bf16 path's
        # tokens, through kernel C's f32 instantiation
        from lmrs_tpu_torch.kernels import launches, reset_launches
        from lmrs_tpu_torch.runtime.engine import Engine, GenerationConfig

        label = "llama3.2-3b Q8_0 f32 cache"
        torch.cuda.reset_peak_memory_stats()
        engine = Engine(cfg, params, cache_dtype=torch.float32)
        reset_launches()
        toks = engine.generate(prompt, GenerationConfig(
            temperature=0.0, max_new_tokens=64))
        torch.cuda.synchronize()
        counts, m = launches(), engine.metrics
        log(f"  {label}: peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, TTFT "
            f"{1e3 * m.ttft_seconds:.1f} ms, decode "
            f"{m.tokens_per_second:.2f} tok/s, launches {counts}")
        if toks != greedy["bf16"]:
            raise RuntimeError(f"{label}: greedy tokens {toks} differ from "
                               f"the bf16 cache's {greedy['bf16']}")
        if {n for n, c in counts.items() if c > 0} != Q8_PATH:
            raise RuntimeError(f"{label}: kernels launched {counts}")
        paths[label] = dict(
            launches=counts, f32_cache=True,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            runs={"greedy": dict(ttft_ms=1e3 * m.ttft_seconds,
                                 decode_tok_s=m.tokens_per_second)})
        del engine
        # the fused FFN on the same params: the int8 path, a batched wave
        label = "llama3.2-3b Q8_0 int8 cache, fuse_ffn"
        engine = Engine(cfg, params, cache_dtype=torch.int8)
        res, f_engine, _, _ = drive_fused_path(
            torch, label, cfg, params, torch.int8, LLAMA_I8_FUSED,
            LLAMA_I8_FUSED_TOKEN, engine, greedy["int8"])
        paths[label] = dict(load_s=load_s, **res)
        del engine, f_engine
        torch.cuda.empty_cache()
        paths.update(batched_fused(
            torch, "llama3.2-3b Q8_0 batch 16, paged int8 pool, fuse_ffn",
            cfg, params, torch.int8, 16, LLAMA_PAGED_FUSED, NEAR_TIE_W8A8,
            seed=14))
        del params
        torch.cuda.empty_cache()
        synthetic_tokenizer(tok_path, LLAMA["V"])
        cli_counts["llama3.2-3b Q8_0 int8 cache"] = drive_cli(
            "llama3.2-3b Q8_0 --cache-dtype int8", model, tok_path,
            Q8_I8_PATH, ("--cache-dtype", "int8"))
        cli_counts["llama3.2-3b Q8_0 int4 cache, speculative"] = drive_cli(
            "llama3.2-3b Q8_0 --cache-dtype int4 --spec-k 4", model,
            tok_path, Q8_I4_PATH, ("--cache-dtype", "int4", "--spec-k", "4"))
        log("phase 4b: Llama-3.2-3B Q8_0 batched serving (BackendServer, "
            "batch 16)")
        paths.update(batched_phase_llama(torch, model, tok_path, cfg))
        model.unlink()
        torch.cuda.empty_cache()

        # ---- 5. Phi-3.5-vision Q8_0: image -> vision tower -> rows ->
        # Engine and a 2-slot paged scheduler
        log("phase 5: Phi-3.5-vision Q8_0 multimodal path")
        paths.update(multimodal_phase(torch, work))

        # ---- 6. Llama-3.2-1B: checkpoint -> exporter -> scored on the
        # card; the perplexity CLI, the native tokenizer, the desktop app
        log("phase 6: Llama-3.2-1B offline path (export, perplexity, "
            "tokenizer, desktop)")
        paths.update(offline_phase(torch, work))

        # ---- 7. Llama-3.2-3B Q8_0 on meshes of ranks on this card: tp,
        # cp, tp x cp, the mesh schedulers, dp replicas, the --tp CLI
        log("phase 7: Llama-3.2-3B Q8_0 tensor, context and data "
            "parallelism")
        p7_paths, p7_cli, p7_model = parallel_phase(torch, work)
        paths.update(p7_paths)
        cli_counts.update(p7_cli)

        # ---- 8. the decode chunk at full depth on one device
        log("phase 8: Llama-3.2-3B Q8_0 at 28 layers: decode chunks of 1 "
            "and 8 steps, read at the end and streamed; speculation")
        paths.update(decode_phase(torch, **p7_model))
        del p7_model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # ---- 9. results: one unit of work per kernel, (model, shape, T, count)
    g, ll = GEMMA["name"], LLAMA["name"]
    unit = {
        "q4_gemv": ("gemma2-9b decode token: 42 x (wqkv, wo, w13, w2) + "
                    "classifier at T=1",
                    [(g, s, 1, GEMMA["L"]) for s in LAYER_SHAPES]
                    + [(g, "classifier", 1, 1)]),
        "q4_gemv_t8": ("gemma2-9b batched decode step of 8 rows: 42 x "
                       "(wqkv, wo, w13, w2) + classifier at T=8",
                       [(g, s, 8, GEMMA["L"]) for s in LAYER_SHAPES]
                       + [(g, "classifier", 8, 1)]),
        "q4_gemm": ("gemma2-9b prefill chunk: 42 x (wqkv, wo, w13, w2) at "
                    "T=256", [(g, s, 256, GEMMA["L"]) for s in LAYER_SHAPES]),
        "flash_attention": ("gemma2-9b decode token at pos 6000: 42 x T=1",
                            [(g, "pos6000", 1, GEMMA["L"])]),
        "q8_gemv_i8": ("llama3.2-3b decode token: 28 x (wqkv, wo, w13, w2) "
                       "at T=1",
                       [(ll, s, 1, LLAMA["L"]) for s in LAYER_SHAPES]),
        "q8_gemv": ("llama3.2-3b decode token: classifier at T=1",
                    [(ll, "classifier", 1, 1)]),
        "q8_gemm": ("llama3.2-3b prefill chunk: 28 x (wqkv, wo, w13, w2) at "
                    "T=256", [(ll, s, 256, LLAMA["L"]) for s in LAYER_SHAPES]),
        "flash_attention_i8": ("llama3.2-3b decode token at pos 6000: 28 x "
                               "T=1", [(ll, "pos6000", 1, LLAMA["L"])]),
        "flash_attention_i4": ("llama3.2-3b decode token at pos 6000: 28 x "
                               "T=1", [(ll, "pos6000", 1, LLAMA["L"])]),
        "flash_attention_f32": ("llama3.2-3b decode token at pos 6000: 28 x "
                                "T=1", [(ll, "pos6000", 1, LLAMA["L"])]),
        "flash_attention_batched": (
            f"gemma2-9b batched decode step, {len(BATCH_POS)} slots at pos "
            f"{BATCH_POS[0]}..{BATCH_POS[-1]}, bf16 per-slot cache: 42 x T=1",
            [(g, "bf16 per-slot", 1, GEMMA["L"])]),
        "flash_attention_paged": (
            f"gemma2-9b batched decode step, {len(BATCH_POS)} slots at pos "
            f"{BATCH_POS[0]}..{BATCH_POS[-1]}, bf16 pool of 512-row pages: "
            "42 x T=1", [(g, "bf16 page512", 1, GEMMA["L"])]),
        "ffn_fused_xe": ("gemma2-9b decode token's FFNs: 42 x T=1",
                         [(g, "ffn", 1, GEMMA["L"])]),
        "ffn_fused": ("llama3.2-3b batched decode step of 16 rows, its "
                      "FFNs: 28 x T=16", [(ll, "ffn", 16, LLAMA["L"])]),
        "flash_merge": ("gemma2-9b decode token at pos 6000: 42 x the "
                        "merge of kernel C's T=1 split pass",
                        [(g, "pos6000", 1, GEMMA["L"])]),
        "flash_attention_batched_lse": (
            f"gemma2-9b batched decode step, {len(BATCH_POS)} slots at pos "
            f"{BATCH_POS[0]}..{BATCH_POS[-1]}, bf16 per-slot cache cut into "
            f"{N_SHARDS} sequence shards, return_lse on each: 42 x T=1",
            [(g, f"bf16 {N_SHARDS} shards", 1, GEMMA["L"])]),
    }

    def path_launches(name):
        """Launches of `name` over the main paths; C's two instantiations
        share a count, told apart by the path's cache type."""
        counter = COUNTER.get(name, name)
        return sum(p["launches"][counter] for p in paths.values()
                   if counter != "flash_attention"
                   or bool(p.get("f32_cache")) == (name in COUNTER))

    per_kernel = []
    for name in REPLACES:
        mine = [c for c in cases if c["kernel"] == name]
        what, plan = unit[name]
        pick = {(c["model"], c["shape"], c["T"]): c for c in mine}
        tot = {}
        for key in ("ms", "device_ms", "plain_ms", "library_ms",
                    "int_mm_ms", "bound_ms"):
            vals = [n * pick[(m, s, t)][key] for m, s, t, n in plan
                    if pick[(m, s, t)].get(key) is not None]
            tot[key] = sum(vals) if len(vals) == len(plan) else None
        per_kernel.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name],
            launches=path_launches(name),
            **({"launches_are": LAUNCHES_ARE[name]} if name in LAUNCHES_ARE
               else {}),
            cli_launches=sum(c.get(name, 0) for c in cli_counts.values()),
            max_abs_err=max(c["max_abs_err"] for c in mine),
            err_over_tol=max(c["err_over_tol"] for c in mine),
            ms=tot["ms"],
            # K and M: the profiler's device time of the same unit beside
            # the timer's (whose window holds host time for short calls)
            **({"device_ms": tot["device_ms"]} if tot["device_ms"]
               is not None else {}),
            plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by=pick[plan[0][:3]]["bound_by"],
            library_ms=tot["library_ms"],
            **({"int_mm_ms": tot["int_mm_ms"]} if name == "q8_gemv_i8"
               else {}), unit=what, cases=mine))
    log("rows of a T=5 call (A and D: and T=8) equal the rows alone: "
        + json.dumps(row_independent))
    log("main paths: " + json.dumps(paths))
    log(f"chip_smoke ran {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": per_kernel}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "decode_graph_replays": sum(
        p.get("decode_graph_replays", 0) for p in paths.values()),
        "device": {"platform": "gpu", "kind": kind,
                   "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
