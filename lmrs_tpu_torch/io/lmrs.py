"""`.lmrs` v4 single-file model format — reader and writer (text section).

Format:

    offset 0:   magic  u32 = 0x73726d6c ("lmrs" little-endian)
    offset 4:   version u32 (= 4)
    offset 8:   packed header: dim, hidden_dim, n_layers, n_heads, head_dim,
                n_kv_heads, vocab_size, seq_len (u32 x8); rms_norm_eps,
                rope_theta (f32 x2); q_type, model_type (u8 x2);
                group_size (u32); multimodal (u8)      [47 bytes]
    offset 256: tensor data in fixed order (see _tensor_layout below).

Quantized tensors are stored per tensor as [q-bytes][f32 scales]; Q4_0
packs two values per byte (adjacent elements, low nibble first), so its
q-bytes section is size/2.  Float tensors are raw little-endian f32.

The reader memory-maps the file and hands out zero-copy numpy views;
`lmrs_tpu_torch.io.params` copies them to the device.  The vision and
processor sections of multimodal files are not read yet (ROADMAP.md A13).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from lmrs_tpu_torch.config import (PHI3_SHORT_FACTOR, ModelConfig, ModelType,
                                   QuantType, unsupported)
from lmrs_tpu_torch.quant import quantize_q40_np, quantize_q80_np

MAGIC = 0x73726D6C
VERSION = 4
HEADER_BYTES = 256
_HEADER_FMT = "<IIIIIIIIffBBIB"  # after magic+version
DEFAULT_MAX_SEQ_LEN = 32768


def _seq_len_cap(max_seq_len: Optional[int]) -> int:
    cap = max_seq_len if max_seq_len is not None else int(
        os.environ.get("LMRS_MAX_SEQ_LEN", str(DEFAULT_MAX_SEQ_LEN)))
    return cap if cap > 0 else (1 << 31)


def parse_header(data: memoryview,
                 max_seq_len: Optional[int] = None) -> Tuple[ModelConfig, int]:
    """Parse the 256-byte header; returns (config, version).  seq_len is
    capped at `max_seq_len` (default LMRS_MAX_SEQ_LEN or 32768; 0 keeps the
    header value)."""
    magic, version = struct.unpack_from("<II", data, 0)
    if magic != MAGIC:
        raise ValueError("not an lm.rs model file (bad magic)")
    (dim, hidden_dim, n_layers, n_heads, head_dim, n_kv_heads, vocab_size,
     seq_len, rms_norm_eps, rope_theta, q_type, model_type, group_size,
     multimodal) = struct.unpack_from(_HEADER_FMT, data, 8)
    kw = {}
    if ModelType(model_type) == ModelType.PHI:
        # the longrope table is sized for Phi-3.5's head_dim=96; adapt for
        # other (e.g. test-scale) head dims
        half = head_dim // 2
        sf = PHI3_SHORT_FACTOR[:half]
        kw["rope_short_factor"] = sf + (1.0,) * (half - len(sf))
    cfg = ModelConfig.make(
        ModelType(model_type),
        dim=dim, hidden_dim=hidden_dim, n_layers=n_layers, n_heads=n_heads,
        head_dim=head_dim, n_kv_heads=n_kv_heads, vocab_size=vocab_size,
        seq_len=min(seq_len, _seq_len_cap(max_seq_len)),
        rms_norm_eps=rms_norm_eps, rope_theta=rope_theta,
        quant=QuantType(q_type), group_size=group_size,
        multimodal=bool(multimodal), **kw,
    )
    return cfg, version


def _tensor_layout(cfg: ModelConfig) -> List[Tuple[str, Tuple[int, ...], bool]]:
    """(name, shape, quantized?) in file order.  Per-layer tensors appear
    as name@l."""
    L, D, H = cfg.n_layers, cfg.dim, cfg.hidden_dim
    A, KV, V = cfg.att_dim, cfg.kv_dim, cfg.vocab_size
    q = cfg.quant != QuantType.NONE
    gemma = cfg.model_type == ModelType.GEMMA
    phi = cfg.model_type == ModelType.PHI

    out: List[Tuple[str, Tuple[int, ...], bool]] = []
    out.append(("embed", (V, D), q))
    out += [(f"att_norm@{l}", (D,), False) for l in range(L)]
    for name, shape in (("wq", (A, D)), ("wk", (KV, D)), ("wv", (KV, D)),
                        ("wo", (D, A))):
        out += [(f"{name}@{l}", shape, q) for l in range(L)]
    out += [(f"post_att_norm@{l}", (D,), False) for l in range(L)]
    if gemma:
        out += [(f"pre_ffn_norm@{l}", (D,), False) for l in range(L)]
    for name, shape in (("w1", (H, D)), ("w2", (D, H)), ("w3", (H, D))):
        out += [(f"{name}@{l}", shape, q) for l in range(L)]
    if gemma:
        out += [(f"post_ffn_norm@{l}", (D,), False) for l in range(L)]
    out.append(("final_norm", (D,), False))
    if phi:
        out.append(("lm_head", (V, D), q))
    return out


def pack_header(cfg: ModelConfig, seq_len_header: Optional[int] = None
                ) -> bytes:
    """The 256-byte file header for `cfg`."""
    head = struct.pack("<II", MAGIC, VERSION) + struct.pack(
        _HEADER_FMT, cfg.dim, cfg.hidden_dim, cfg.n_layers, cfg.n_heads,
        cfg.head_dim, cfg.n_kv_heads, cfg.vocab_size,
        seq_len_header or cfg.seq_len, cfg.rms_norm_eps, cfg.rope_theta,
        int(cfg.quant), int(cfg.model_type), cfg.group_size,
        int(cfg.multimodal))
    return head + b"\0" * (HEADER_BYTES - len(head))


def write_lmrs(path: str, cfg: ModelConfig, weights: Dict[str, np.ndarray],
               seq_len_header: Optional[int] = None) -> Dict[str, float]:
    """Serialize dense float weights to a .lmrs file, quantizing per
    cfg.quant.  `weights` maps layout names ("embed", "wq@0", ...) to float
    arrays of the layout shapes.  Returns per-tensor max quantization group
    errors."""
    if cfg.multimodal:
        raise unsupported("writing a multimodal .lmrs file",
                          "A13 multimodal")
    errors: Dict[str, float] = {}
    with open(path, "wb") as f:
        f.write(pack_header(cfg, seq_len_header))
        for name, shape, quantized in _tensor_layout(cfg):
            w = np.ascontiguousarray(weights[name], dtype=np.float32)
            if w.shape != shape:
                raise ValueError(f"{name}: shape {w.shape}, layout {shape}")
            if not quantized:
                f.write(w.tobytes())
                continue
            if cfg.quant == QuantType.Q8_0:
                qv, s, err = quantize_q80_np(w, cfg.group_size)
            else:
                qv, s, err = quantize_q40_np(w, cfg.group_size)
            f.write(qv.tobytes())
            f.write(s.astype(np.float32).tobytes())
            errors[name] = err
    return errors


class LmrsFile:
    """Zero-copy view of a .lmrs file's text tensors (numpy memmap)."""

    def __init__(self, path: str, max_seq_len: Optional[int] = None):
        self.path = path
        self.data = np.memmap(path, dtype=np.uint8, mode="r")
        self.cfg, self.version = parse_header(
            memoryview(self.data[:HEADER_BYTES]), max_seq_len)
        self.tensors: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]] = {}
        self._offset = HEADER_BYTES
        for name, shape, quantized in _tensor_layout(self.cfg):
            self.tensors[name] = self._read_tensor(
                shape, quantized, self.cfg.quant, self.cfg.group_size)

    def _take(self, nbytes: int) -> np.ndarray:
        view = self.data[self._offset:self._offset + nbytes]
        if view.size != nbytes:
            raise ValueError(f"file truncated at offset {self._offset}")
        self._offset += nbytes
        return view

    def _read_tensor(self, shape, quantized: bool, qtype: QuantType, gs: int):
        n = int(np.prod(shape))
        if not quantized:
            return self._take(n * 4).view(np.float32).reshape(shape), None
        qbytes = n // 2 if qtype == QuantType.Q4_0 else n
        q = self._take(qbytes)
        q = q.view(np.uint8) if qtype == QuantType.Q4_0 else q.view(np.int8)
        s = self._take((n // gs) * 4).view(np.float32)
        if len(shape) == 2:
            q = q.reshape(shape[0], -1)
            s = s.reshape(shape[0], shape[1] // gs)
        return q, s

    @property
    def text_end_offset(self) -> int:
        """Offset after the text weights (start of a vision section)."""
        return self._offset


def read_lmrs(path: str, max_seq_len: Optional[int] = None) -> LmrsFile:
    return LmrsFile(path, max_seq_len)
