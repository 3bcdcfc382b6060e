"""The per-tensor split plan of tensor parallelism.

Megatron placement, as the JAX package's (`lmrs_tpu/parallel/sharding.py`
and `tp.py`), adapted to quantized weights:

  wq/wk/wv, w1/w3  column-parallel: each rank takes a block of output rows
  wo, w2           row-parallel: a block of input columns (the packed Q4 or
                   int8 values AND the group scales, split at group edges)
  embed, lm_head   vocab-sharded: a block of vocabulary rows
  norms, RoPE      replicated

A tp that does not divide a split axis raises (`config.check_divisible`):
the JAX plan falls back to replicating such a tensor, which only its GSPMD
dry run uses; the port's shard-local forward needs every split exact.
"""

from __future__ import annotations

from typing import Dict

from lmrs_tpu_torch.config import ModelConfig, check_divisible

# what each layout name's tensor does under tp
COLUMN, ROW, VOCAB, REPLICATED = "column", "row", "vocab", "replicated"


def tp_param_shardings(cfg: ModelConfig, tp: int) -> Dict[str, str]:
    """The split of every tensor base name under `tp` (module note);
    raises for a tp that does not divide the model."""
    if tp > 1:
        check_divisible(cfg, tp)
    plan = {name: COLUMN for name in ("wq", "wk", "wv", "w1", "w3")}
    plan.update(wo=ROW, w2=ROW, embed=VOCAB, lm_head=VOCAB)
    for name in ("att_norm", "post_att_norm", "pre_ffn_norm",
                 "post_ffn_norm", "final_norm"):
        plan[name] = REPLICATED
    return plan
