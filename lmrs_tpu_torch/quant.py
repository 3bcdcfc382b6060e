"""Group-wise weight/activation quantization (Q8_0 / Q4_0) over torch tensors.

Weights are stored as the `.lmrs` format stores them: Q8_0 as int8 values
plus one f32 scale per `group_size` values, Q4_0 as two 4-bit values per
byte plus f32 scales.  On the device Q4_0 uses the RUNTIME byte layout: a
byte holds element j of a group (low nibble) and element j + gs/2 (high
nibble), XOR 0x80.  The kernels in `lmrs_tpu_torch.kernels` read exactly
these bytes.

Activation quantizers round half AWAY from zero (Rust's `f32::round`);
`torch.round` rounds half to even, so it is not used for them.  The KV-cache
quantizers (`quantize_kv_rows`, `quantize_kv_rows_q4`) do round half to
even.  They live here, beside the other quantizers; the JAX package keeps
its own in `lmrs_tpu/models/transformer.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lmrs_tpu_torch.config import QuantType


@dataclasses.dataclass
class QTensor:
    """A quantized 2-D weight matrix of logical shape (out, in).

    - NONE:  q is float (out, in), s is None.
    - Q8_0:  q is int8 (out, in), s is f32 (out, in // gs).
    - Q4_0:  q is uint8 (out, in // 2) in the runtime layout, s is f32
             (out, in // gs).
    """

    q: torch.Tensor
    s: Optional[torch.Tensor]
    qtype: QuantType
    group_size: int
    out_features: int
    in_features: int


# ---------------------------------------------------------------------------
# Rounding helpers
# ---------------------------------------------------------------------------

def _const(like: torch.Tensor, value: float) -> torch.Tensor:
    """`value` as a tensor: on a CUDA device PyTorch divides a tensor by a
    Python scalar by multiplying with its reciprocal, which is not the IEEE
    quotient the CPU (and the reference) computes; tensor / tensor is."""
    return torch.full_like(like, value)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (Rust f32::round), unlike torch.round."""
    return torch.trunc(x + torch.where(x >= 0, 0.5, -0.5))


# ---------------------------------------------------------------------------
# Activation quantization (lm.rs's runtime scheme)
# ---------------------------------------------------------------------------

def quantize_q8_act(x: torch.Tensor, group_size: int):
    """Per-group symmetric int8: scale = absmax/127, round half away from
    zero.  All-zero groups give q=0, s=0.

    Returns (q int8 (..., n), s f32 (..., n // gs))."""
    n = x.shape[-1]
    g = x.float().reshape(*x.shape[:-1], n // group_size, group_size)
    wmax = g.abs().amax(dim=-1)
    scale = wmax / _const(wmax, 127.0)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = _round_half_away(g / safe[..., None])
    q = torch.where(scale[..., None] == 0, torch.zeros_like(q), q)
    return q.to(torch.int8).reshape(x.shape), scale


def quantize_q4_act(x: torch.Tensor, group_size: int):
    """Per-group int4, kept UNPACKED as int8 in [-8, 7]: scale =
    absmax/(-8), q_u = clamp(round(x/scale + 8), 0, 15), value q_u - 8.
    All-zero groups give q_u = 0 (value -8) with scale 0.

    Returns (values int8 (..., n), s f32 (..., n // gs))."""
    n = x.shape[-1]
    g = x.float().reshape(*x.shape[:-1], n // group_size, group_size)
    wmax = g.abs().amax(dim=-1)
    scale = wmax / (-8.0)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    qu = _round_half_away(g / safe[..., None] + 8.0).clamp(0.0, 15.0)
    qu = torch.where(scale[..., None] == 0, torch.zeros_like(qu), qu)
    return (qu - 8.0).to(torch.int8).reshape(x.shape), scale


def quantize_kv_rows(x: torch.Tensor):
    """int8 KV-cache rows: (..., KH, hd) float -> ((..., KH * hd) int8 rows,
    (..., KH) f32 scales).  Symmetric absmax/127 per (token, head);
    all-zero rows get scale 0.  Unlike the activation quantizers this one
    multiplies by 127/absmax and rounds half to EVEN (`torch.round`)."""
    amax = x.abs().amax(dim=-1)
    c127 = _const(amax, 127.0)
    inv = torch.where(amax > 0, c127 / amax, torch.zeros_like(amax))
    q = torch.round(x * inv[..., None]).to(torch.int8)
    return q.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1]), amax / c127


def q4_cache_pair_mode(kh: int, hd: int) -> bool:
    """Which packing an int4 KV cache uses.  "half" (channel i shares a
    byte with channel i + hd/2 of the same head) when hd % 256 == 0 or the
    kv-head count is odd; "pair" (head 2p in the low nibbles, head 2p+1 in
    the high ones, channel by channel) for every other geometry."""
    return hd % 256 != 0 and kh % 2 == 0


def q4_cache_supported(kh: int, hd: int) -> bool:
    """Whether the JAX package's flash kernels serve an int4 cache of this
    geometry (else it unpacks and takes its einsum attention).  The port's
    kernel H takes both packings at every head dim it is built for; this
    is kept for the tests that carry a geometry across."""
    return hd % 256 == 0 or (hd % 128 == 0 and kh % 2 == 0)


def quantize_kv_rows_q4(x: torch.Tensor):
    """int4 KV-cache rows: (..., KH, hd) float -> ((..., KH * hd / 2) int8
    biased nibble bytes, (..., KH) f32 scales).  Symmetric absmax/7 per
    (token, head), round half to even, clipped to [-8, 7]; all-zero rows
    get scale 0.  A byte is v = 16 * q_hi + q_lo + 8 as int8 (the whole
    int8 range, -128 included); which two values share it is
    `q4_cache_pair_mode`'s choice."""
    kh, hd = x.shape[-2:]
    amax = x.abs().amax(dim=-1)
    c7 = _const(amax, 7.0)
    inv = torch.where(amax > 0, c7 / amax, torch.zeros_like(amax))
    q = torch.round(x * inv[..., None]).clamp(-8, 7)
    return pack_kv_q4(q), amax / c7


def pack_kv_q4(q: torch.Tensor) -> torch.Tensor:
    """int4 values (..., KH, hd) in [-8, 7] (any dtype holding integers)
    -> (..., KH * hd / 2) int8 biased nibble bytes, in the packing
    `q4_cache_pair_mode` picks for KH and hd; `unpack_kv_q4`'s inverse."""
    kh, hd = q.shape[-2:]
    q = q.to(torch.int32)
    if q4_cache_pair_mode(kh, hd):
        qlo, qhi = q[..., 0::2, :], q[..., 1::2, :]          # head pairs
    else:
        qlo, qhi = q[..., :hd // 2], q[..., hd // 2:]
    v = (16 * qhi + qlo + 8).to(torch.int8)
    return v.reshape(*q.shape[:-2], kh * hd // 2)


def unpack_kv_q4(vals: torch.Tensor, kh: int, hd: int) -> torch.Tensor:
    """Inverse of quantize_kv_rows_q4's packing (no scale): (..., KH*hd/2)
    int8 biased bytes -> (..., KH, hd) f32 integer values in [-8, 7]."""
    v = vals.to(torch.int32)
    qhi = v >> 4                                    # arithmetic: floor(v/16)
    qlo = (v & 15) - 8
    lead = vals.shape[:-1]
    if q4_cache_pair_mode(kh, hd):
        q = torch.stack([qlo.reshape(*lead, kh // 2, hd),
                         qhi.reshape(*lead, kh // 2, hd)], dim=-2)
        return q.reshape(*lead, kh, hd).float()
    return torch.cat([qlo.reshape(*lead, kh, hd // 2),
                      qhi.reshape(*lead, kh, hd // 2)], dim=-1).float()


# ---------------------------------------------------------------------------
# Weight unpacking / dequantization
# ---------------------------------------------------------------------------

def unpack_q4_file(packed: torch.Tensor) -> torch.Tensor:
    """FILE-layout Q4 bytes (..., n // 2) -> int8 values (..., n): low
    nibble = even element, high nibble = odd element."""
    u = packed.to(torch.uint8)
    lo = (u & 0x0F).to(torch.int8) - 8
    hi = ((u >> 4) & 0x0F).to(torch.int8) - 8
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def unpack_q4(packed: torch.Tensor, group_size: int) -> torch.Tensor:
    """RUNTIME-layout Q4 bytes (..., n // 2) -> int8 values (..., n).

    Byte j of a group holds element j (low nibble) and element j + gs/2
    (high nibble), XOR 0x80: b = u ^ 0x80, lo = (b & 15) - 8,
    hi = (b >> 4) - 8."""
    half = group_size // 2
    b = packed.to(torch.uint8) ^ 0x80
    lo = (b & 0x0F).to(torch.int8) - 8
    hi = (b >> 4).to(torch.int8) - 8
    g = packed.shape[-1] // half
    lo = lo.reshape(*packed.shape[:-1], g, half)
    hi = hi.reshape(*packed.shape[:-1], g, half)
    out = torch.cat([lo, hi], dim=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def q4_file_to_runtime(packed: torch.Tensor, group_size: int) -> torch.Tensor:
    """Repack file-layout (adjacent-pair) Q4 bytes into the runtime
    group-half layout, on whatever device `packed` lies on.  A pure byte
    permutation: values are unchanged."""
    u = packed.to(torch.uint8)
    half = group_size // 2
    b = u.reshape(*u.shape[:-1], -1, half)          # (..., G, gs/2 bytes)
    vals = torch.stack([b & 0x0F, b >> 4], dim=-1)  # natural element order
    vals = vals.reshape(*b.shape[:-1], group_size)
    out = (vals[..., :half] | (vals[..., half:] << 4)) ^ 0x80
    return out.reshape(u.shape)


def q4_file_to_runtime_np(packed: np.ndarray, group_size: int) -> np.ndarray:
    """Host (numpy) form of q4_file_to_runtime."""
    u = np.asarray(packed).view(np.uint8)
    n2 = u.shape[-1]
    lo = u & 0x0F
    hi = (u >> 4) & 0x0F
    vals = np.stack([lo, hi], axis=-1).reshape(*u.shape[:-1], n2 * 2)
    g = vals.reshape(*u.shape[:-1], (n2 * 2) // group_size, group_size)
    first = g[..., : group_size // 2]
    second = g[..., group_size // 2:]
    out = ((first | (second << 4)) ^ 0x80).astype(np.uint8)
    return out.reshape(*u.shape[:-1], n2)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Dense float matrix of the QTensor's logical shape."""
    if qt.qtype == QuantType.NONE:
        return qt.q.to(dtype)
    if qt.qtype == QuantType.Q8_0:
        vals = qt.q.float()
    elif qt.qtype == QuantType.Q4_0:
        vals = unpack_q4(qt.q, qt.group_size).float()
    else:
        raise ValueError(qt.qtype)
    gs = qt.group_size
    shape = vals.shape
    g = vals.reshape(*shape[:-1], shape[-1] // gs, gs)
    return (g * qt.s[..., None]).reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# Weight quantization (numpy, export side)
# ---------------------------------------------------------------------------

def quantize_q80_np(w: np.ndarray, group_size: int):
    """Export-side Q8_0: scale = absmax/127, round half to even.
    Returns (int8 values flat-grouped, f32 scales, max group error)."""
    if w.size % group_size:
        raise ValueError(f"{w.size} values do not split into groups of "
                         f"{group_size}")
    w32 = w.astype(np.float32).reshape(-1, group_size)
    wmax = np.abs(w32).max(axis=1)
    scale = wmax / 127.0
    with np.errstate(divide="ignore", invalid="ignore"):
        quant = w32 / scale[:, None]
    quant = np.nan_to_num(quant, nan=0.0, posinf=0.0, neginf=0.0)
    int8val = np.round(quant).astype(np.int8)
    fp32val = int8val.astype(np.float32) * scale[:, None]
    err = np.abs(fp32val - w32).max() if w32.size else 0.0
    return int8val, scale.astype(np.float32), float(err)


def quantize_q40_np(w: np.ndarray, group_size: int):
    """Export-side Q4_0: scale = absmax/(-7.5), values +8 offset, packed
    lo | hi << 4 (file layout).
    Returns (packed uint8 (groups, gs // 2), f32 scales, max group error)."""
    if w.size % group_size or group_size % 2:
        raise ValueError(f"{w.size} values do not split into groups of "
                         f"{group_size}")
    w32 = w.astype(np.float32).reshape(-1, group_size)
    wmax = np.abs(w32).max(axis=1)
    scale = wmax / -7.5
    with np.errstate(divide="ignore", invalid="ignore"):
        quant = w32 / scale[:, None]
    quant = np.nan_to_num(quant, nan=-8.0, posinf=0.0, neginf=0.0)
    uint8val = np.clip(np.round(quant + 8.0), 0, 15).astype(np.uint8)
    fp32val = (uint8val.astype(np.float32) - 8.0) * scale[:, None]
    err = np.abs(fp32val - w32).max() if w32.size else 0.0
    pairs = uint8val.reshape(uint8val.shape[0], group_size // 2, 2)
    packed = (pairs[..., 0] | (pairs[..., 1] << 4)).astype(np.uint8)
    return packed, scale.astype(np.float32), float(err)
