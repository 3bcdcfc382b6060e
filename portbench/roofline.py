"""The yardstick: the card's peaks and the arithmetic of bytes and
operations that every architecture shares (the bound arithmetic of
`chip_smoke.py`, `bound_ms`: least time = max(bytes / bandwidth,
operations / peak)).

Shared counting rules:
- a quantized matrix's bytes are its values and f32 group scales
  (`matrix_bytes`), read once per forward that uses it;
- KV rows count at the cache type's bytes (`CACHE_BYTES`); a page that
  several lanes read in one step (a shared prefix page) counts once, at
  the most rows any of them reads in it (`unique_rows`);
- products whose operands are both 8-bit-or-narrower integers in the
  reference arithmetic count against the int8 peak, all others against
  bf16;
- an image's tower and projector (`image_cost`).
What a forward of one architecture reads and computes (which matrices,
which layers read which KV rows, at which head width) is its module's
(`arch/<model_type>.py`: `forward_cost`, `attention_cost`).
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
