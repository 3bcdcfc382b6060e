"""The yardstick: the card's peaks and the operations and bytes that a
forward's inputs need, whatever kernel computes them (the bound arithmetic
of `chip_smoke.py`, `bound_ms`: least time = max(bytes / bandwidth,
operations / peak)).

Counting rules:
- weights count once per forward (every layer matrix, the classifier
  where logits are made, the embedding rows gathered);
- KV rows count at the published head_dim (96 for Phi-3.5), not the
  cache's padded lanes, at the cache type's bytes; a row that several
  slots read in one step (a shared prefix page) counts once;
- products whose operands are both 8-bit-or-narrower integers in the
  reference arithmetic count against the int8 peak, all others against
  bf16.
"""

from __future__ import annotations

from typing import Dict, Optional

# NVIDIA's data sheet, SXM part, dense (no sparsity), at the 700 W limit
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": dict(mem=3.35e12, bf16=989e12, int8=1979e12,
                                  f32=67e12),
}

CACHE_BYTES = {"bfloat16": 2, "float32": 4, "int8": 1, "int4": 0.5}
WEIGHT_BYTES = {"Q4_0": 0.5, "Q8_0": 1.0, "NONE": 4.0}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(kind)


def bound_s(nbytes: float, ops_bf16: float, ops_int8: float,
            peak: Dict[str, float]) -> float:
    """The least time of work moving `nbytes` and doing the operations."""
    return max(nbytes / peak["mem"],
               ops_bf16 / peak["bf16"] + ops_int8 / peak["int8"])


def matrix_bytes(out_f: int, in_f: int, quant: str, gs: int) -> float:
    """A quantized (out, in) matrix's values and f32 group scales."""
    scales = 0.0 if quant == "NONE" else 4.0 * out_f * in_f / gs
    return WEIGHT_BYTES[quant] * out_f * in_f + scales


def layer_matrices(cfg) -> Dict[str, tuple]:
    att, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return {"wqkv": (att + 2 * kv, cfg.dim), "wo": (cfg.dim, att),
            "w13": (2 * cfg.hidden_dim, cfg.dim),
            "w2": (cfg.dim, cfg.hidden_dim)}


def layer_macs(cfg) -> int:
    """Multiply-accumulates of one row through one layer's matrices."""
    return sum(o * i for o, i in layer_matrices(cfg).values())


def weight_bytes(cfg, quant: str, gs: int, logits: bool,
                 embed_rows: int) -> float:
    per_layer = sum(matrix_bytes(o, i, quant, gs)
                    for o, i in layer_matrices(cfg).values())
    b = cfg.n_layers * per_layer
    if logits:
        b += matrix_bytes(cfg.vocab_size, cfg.dim, quant, gs)
    b += embed_rows * matrix_bytes(1, cfg.dim, quant, gs)
    return b


def kv_row_bytes(cfg, cache_dtype: str) -> float:
    """One token's K and V over all layers, at the published head_dim."""
    return (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
            * CACHE_BYTES[cache_dtype])


def forward_cost(cfg, quant: str, gs: int, cache_dtype: str, *, rows: int,
                 logit_rows: int, kv_read_rows: int, kv_write_rows: int,
                 attn_keys: int, int8_rows: bool = False,
                 embed_rows: Optional[int] = None) -> Dict[str, float]:
    """Bytes and operations of one forward of `rows` query rows: its
    inputs and outputs (weights, the KV rows read and written, the
    logits), not what passes between its kernels.
    `attn_keys`: keys summed over the query rows (each row attends to its
    position + 1 keys); `int8_rows`: the layer products take integer
    activations (W8A8)."""
    mm = 2.0 * rows * cfg.n_layers * layer_macs(cfg)
    cls = 2.0 * logit_rows * cfg.vocab_size * cfg.dim
    att = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * attn_keys
    nbytes = (weight_bytes(cfg, quant, gs, logit_rows > 0,
                           rows if embed_rows is None else embed_rows)
              + (kv_read_rows + kv_write_rows) * kv_row_bytes(cfg,
                                                              cache_dtype)
              + 4.0 * logit_rows * cfg.vocab_size)
    return dict(bytes=nbytes, ops_bf16=(0.0 if int8_rows else mm) + cls + att,
                ops_int8=mm if int8_rows else 0.0)


def attention_cost(cfg, cache_dtype: str, kv_read_rows: int,
                   attn_keys: int, rows: int) -> Dict[str, float]:
    """A decode step's attention over all layers: the KV rows it needs
    (each once), q in and the output out, and QK^T and PV."""
    nbytes = (kv_read_rows * kv_row_bytes(cfg, cache_dtype)
              + 2 * 4.0 * rows * cfg.n_layers * cfg.n_heads * cfg.head_dim)
    ops = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * attn_keys
    return dict(bytes=nbytes, ops_bf16=ops, ops_int8=0.0)


def unique_rows(lanes, psz: int) -> int:
    """KV rows read once per step by lanes [(pages, rows)]: a physical page
    that several lanes hold (a shared prefix page) counts once, at the
    most rows any of them reads in it."""
    seen: Dict[int, int] = {}
    for pages, rows in lanes:
        full, part = divmod(rows, psz)
        for k in range(full):
            seen[pages[k]] = psz
        if part:
            pg = pages[full]
            seen[pg] = max(seen.get(pg, 0), part)
    return sum(seen.values())


def image_cost(dims: Dict[str, int], quant: str, gs: int, crops: int,
               rows: int) -> Dict[str, float]:
    """One image through the CLIP tower (its first n_layers - 1 layers,
    577 positions a crop, as run) and the projector (`rows` merged rows):
    the integer products count against int8 (both operands are integers in
    lm.rs's arithmetic), the patch embedding and attention against bf16;
    bytes: the weights once, the patches in, the rows out."""
    d, h, td = dims["dim"], dims["hidden_dim"], dims["text_dim"]
    ps, nh = dims["patch_size"], dims["n_heads"]
    layers = dims["n_layers"] - 1
    t = (dims["image_size"] // ps) ** 2 + 1
    tokens = crops * t
    int8 = 2.0 * tokens * layers * (4 * d * d + 2 * d * h)
    int8 += 2.0 * rows * (4 * d * td + td * td)
    bf16 = 2.0 * crops * (t - 1) * 3 * ps * ps * d
    bf16 += 4.0 * crops * nh * t * t * (d // nh) * layers
    nbytes = (layers * (4 * matrix_bytes(d, d, quant, gs)
                        + 2 * matrix_bytes(h, d, quant, gs))
              + matrix_bytes(td, 4 * d, quant, gs)
              + matrix_bytes(td, td, quant, gs)
              + 4.0 * (d * 3 * ps * ps + t * d)
              + 4.0 * crops * (t - 1) * 3 * ps * ps + 4.0 * rows * td)
    return dict(bytes=nbytes, ops_bf16=bf16, ops_int8=int8)
