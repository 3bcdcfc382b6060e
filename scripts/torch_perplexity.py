#!/usr/bin/env python3
"""Perplexity of lmrs_tpu_torch models: f32 against Q8_0 and Q4_0 at one
group size (the port of `scripts/perplexity.py`).

"Matched Q8_0/Q4_0 perplexity" means |NLL per token of the quantized
model - NLL per token of the f32 model| < 0.05 on the same weights and
tokens.  Scoring is teacher-forced prefill in chunks through the port's
`forward(..., logit_idx="all")`, so its matmuls and attention run the
port's kernels (B or F at more than 8 rows, C, G or H on the KV cache);
log-softmax in float32; NLL summed over the target rows.

The port pads nothing: a chunk is `min(chunk, n - pos)` rows, and the
cache holds exactly the n scored rows, so no write can land past it.  A
tail of 8 rows or fewer takes the T <= 8 kernels (A, D or E), whose
numerics differ from the longer chunks'.  There is no `--impl`: the port
has one matmul dispatch (`ops.matmul.qmatmul`).

Usage (on the card; add --device cpu for the kernels' plain versions):
  python scripts/torch_perplexity.py --model m.lmrs --tokenizer tok.bin --text corpus.txt
  python scripts/torch_perplexity.py --model m.lmrs --tokens ids.npy
  python scripts/torch_perplexity.py --compare tiny-llama --n-tokens 512
"""

from __future__ import annotations

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

MATCHED = 0.05      # |NLL per token delta| of a matched quantization


def score_tokens(cfg, params, tokens, chunk: int = 128,
                 cache_dtype=torch.float32) -> dict:
    """Sum of -log p(t_i | t_<i) for i >= 1 over `tokens`, by chunked
    teacher-forced prefill on the device of `params`.  Returns the NLL per
    token, the perplexity and the number of tokens scored."""
    from lmrs_tpu_torch.models.transformer import (embed_tokens, forward,
                                                   init_kv_cache)

    tokens = np.asarray(tokens, np.int64)
    n = len(tokens)
    if n < 2:
        raise ValueError("need at least 2 tokens to score")
    if n > cfg.seq_len:
        raise ValueError(f"{n} tokens > seq_len {cfg.seq_len}")
    if chunk < 1:
        raise ValueError(f"chunk of {chunk} rows")
    device = params.embed.q.device
    toks = torch.from_numpy(tokens).to(device)
    cache = init_kv_cache(cfg, device, cache_dtype, seq_len=n)
    total_nll = 0.0
    count = 0
    pos = 0
    while pos < n - 1:
        t_chunk = min(chunk, n - pos)
        x = embed_tokens(params, cfg, toks[pos:pos + t_chunk])
        logits = forward(params, cfg, cache, x, pos, "all")
        logp = torch.log_softmax(logits.float(), dim=-1)
        # row i predicts token pos + i + 1
        n_score = min(t_chunk, n - 1 - pos)
        rows = torch.arange(n_score, device=device)
        picked = logp[rows, toks[pos + 1:pos + 1 + n_score]]
        total_nll -= picked.double().sum().item()
        count += n_score
        pos += t_chunk
    nll = total_nll / count
    return {"nll_per_token": nll, "perplexity": math.exp(nll),
            "tokens_scored": count}


def _compare(preset: str, n_tokens: int, gs: int, seed: int,
             cache_dtype=torch.float32, device=None) -> dict:
    """One synthetic f32 model quantized to Q8_0 and Q4_0 at the same
    group size (`params_from_weights` of the same dense weights), each
    scored on the same tokens.  The tokens and weights are the JAX
    harness's for the same preset and seed."""
    from lmrs_tpu_torch.config import ModelType, QuantType
    from lmrs_tpu_torch.io.params import params_from_weights
    from lmrs_tpu_torch.io.synthetic import random_weights, tiny_config

    mt = {"tiny-llama": ModelType.LLAMA, "tiny-gemma": ModelType.GEMMA,
          "tiny-phi": ModelType.PHI}[preset]
    cfg32 = tiny_config(mt, QuantType.NONE, dim=128, hidden_dim=256,
                        n_layers=4, vocab_size=512, group_size=gs,
                        seq_len=max(256, n_tokens))
    weights = random_weights(cfg32, seed=seed)
    rng = np.random.default_rng(seed + 1)
    tokens = rng.integers(1, cfg32.vocab_size - 1, size=n_tokens)

    results = {}
    for qt in (QuantType.NONE, QuantType.Q8_0, QuantType.Q4_0):
        cfg = cfg32.replace(quant=qt)
        params = params_from_weights(cfg, weights, device)
        r = score_tokens(cfg, params, tokens, cache_dtype=cache_dtype)
        results[qt.name] = r
        print(f"{qt.name:5s}: ppl {r['perplexity']:10.4f}  "
              f"nll/tok {r['nll_per_token']:.6f}", flush=True)
    f32 = results["NONE"]["nll_per_token"]
    for name in ("Q8_0", "Q4_0"):
        d = results[name]["nll_per_token"] - f32
        print(f"{name} nll delta vs f32: {d:+.6f} "
              f"({'matched' if abs(d) < MATCHED else 'DEGRADED'})")
    return results


def main(argv=None):
    from lmrs_tpu_torch.models.transformer import CACHE_DTYPES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", help=".lmrs model file")
    ap.add_argument("--tokenizer", help="tokenizer.bin (with --text)")
    ap.add_argument("--text", help="text file to score")
    ap.add_argument("--tokens", help=".npy file of token ids to score")
    ap.add_argument("--compare", metavar="PRESET",
                    help="synthetic study: tiny-llama|tiny-gemma|tiny-phi")
    ap.add_argument("--n-tokens", type=int, default=512)
    ap.add_argument("--gs", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--cache-dtype", default="float32",
                    choices=sorted(CACHE_DTYPES),
                    help="KV cache storage while scoring: the quantized "
                         "caches' cost in NLL")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    cache_dtype = CACHE_DTYPES[args.cache_dtype]
    if args.compare:
        _compare(args.compare, args.n_tokens, args.gs, args.seed,
                 cache_dtype=cache_dtype, device=args.device)
        return

    if not args.model:
        ap.error("--model or --compare required")
    if args.tokens:
        tokens = np.load(args.tokens)
    elif args.text and args.tokenizer:
        from lmrs_tpu_torch.tokenizer import Tokenizer

        tok = Tokenizer.from_file(args.tokenizer)
        with open(args.text, encoding="utf-8") as f:
            tokens = np.asarray([tok.bos] + tok.encode(f.read()), np.int64)
    else:
        ap.error("--tokens, or --text with --tokenizer, required with "
                 "--model")
    from lmrs_tpu_torch.io.lmrs import read_lmrs
    from lmrs_tpu_torch.io.params import params_from_lmrs

    f = read_lmrs(args.model)
    params = params_from_lmrs(f, device=args.device)
    r = score_tokens(f.cfg, params, tokens[:f.cfg.seq_len], chunk=args.chunk,
                     cache_dtype=cache_dtype)
    print(f"perplexity {r['perplexity']:.4f}  "
          f"nll/tok {r['nll_per_token']:.9f}  over {r['tokens_scored']} tok")


if __name__ == "__main__":
    main()
