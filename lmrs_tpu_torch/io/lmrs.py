"""`.lmrs` v4 single-file model format — reader and writer.

Format:

    offset 0:   magic  u32 = 0x73726d6c ("lmrs" little-endian)
    offset 4:   version u32 (= 4)
    offset 8:   packed header: dim, hidden_dim, n_layers, n_heads, head_dim,
                n_kv_heads, vocab_size, seq_len (u32 x8); rms_norm_eps,
                rope_theta (f32 x2); q_type, model_type (u8 x2);
                group_size (u32); multimodal (u8)      [47 bytes]
    offset 256: tensor data in fixed order (see _tensor_layout below).

A multimodal file (header flag `multimodal`) goes on after the text
tensors with two sections, each a header padded to 128 bytes and then its
tensors:

    vision:    dim, hidden_dim, n_layers, n_heads, head_dim (u32 x5);
               layernorm_eps (f32); patch_size, image_size (u32 x2);
               q_type (u8); group_size (u32)        [37 bytes]
               tensors in `_vision_tensor_layout` order
    processor: hidden_dim, text_dim (u32 x2); q_type (u8);
               group_size (u32)                      [13 bytes]
               tensors in `_processor_tensor_layout` order

Quantized tensors are stored per tensor as [q-bytes][f32 scales]; Q4_0
packs two values per byte (adjacent elements, low nibble first), so its
q-bytes section is size/2.  Float tensors are raw little-endian f32.

The reader memory-maps the file and hands out zero-copy numpy views;
`lmrs_tpu_torch.io.params` copies them to the device.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from lmrs_tpu_torch.config import (PHI3_SHORT_FACTOR, ModelConfig, ModelType,
                                   QuantType)
from lmrs_tpu_torch.quant import quantize_q40_np, quantize_q80_np

MAGIC = 0x73726D6C
VERSION = 4
HEADER_BYTES = 256
_HEADER_FMT = "<IIIIIIIIffBBIB"  # after magic+version
_VISION_HEADER_FMT = "<IIIIIfIIBI"
_PROCESSOR_HEADER_FMT = "<IIBI"
SECTION_HEADER_BYTES = 128
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


def _vision_tensor_layout(vc) -> List[Tuple[str, Tuple[int, ...], bool]]:
    """The vision section's tensor order (577 positions are fixed by the
    format)."""
    from lmrs_tpu_torch.models.vision import N_POSITIONS

    L, D, H = vc.n_layers, vc.dim, vc.hidden_dim
    q = vc.quant != QuantType.NONE
    out: List[Tuple[str, Tuple[int, ...], bool]] = [
        ("v.class_embedding", (D,), False),
        ("v.patch_embedding", (D, 3 * vc.patch_size * vc.patch_size), False),
        ("v.position_embedding", (N_POSITIONS, D), False),
    ]
    for name in ("ln1_w", "ln1_b", "ln2_w", "ln2_b"):
        out += [(f"v.{name}@{l}", (D,), False) for l in range(L)]
    for name in ("wq", "wk", "wv", "wo"):
        out += [(f"v.{name}@{l}", (D, D), q) for l in range(L)]
        out += [(f"v.{name}_b@{l}", (D,), False) for l in range(L)]
    out += [(f"v.w1@{l}", (H, D), q) for l in range(L)]
    out += [(f"v.w1_b@{l}", (H,), False) for l in range(L)]
    out += [(f"v.w2@{l}", (D, H), q) for l in range(L)]
    out += [(f"v.w2_b@{l}", (D,), False) for l in range(L)]
    out += [("v.pre_ln_w", (D,), False), ("v.pre_ln_b", (D,), False)]
    return out


def _processor_tensor_layout(pc) -> List[Tuple[str, Tuple[int, ...], bool]]:
    """The processor section's tensor order."""
    q = pc.quant != QuantType.NONE
    return [
        ("p.glb_gn", (pc.hidden_dim,), False),
        ("p.sub_gn", (pc.hidden_dim,), False),
        ("p.proj0", (pc.text_dim, pc.hidden_dim), q),
        ("p.proj1", (pc.text_dim, pc.text_dim), q),
        ("p.proj0_b", (pc.text_dim,), False),
        ("p.proj1_b", (pc.text_dim,), False),
    ]


def pack_vision_header(vc) -> bytes:
    """The vision section's header, padded to SECTION_HEADER_BYTES."""
    head = struct.pack(_VISION_HEADER_FMT, vc.dim, vc.hidden_dim,
                       vc.n_layers, vc.n_heads, vc.head_dim, vc.layernorm_eps,
                       vc.patch_size, vc.image_size, int(vc.quant),
                       vc.group_size)
    return head + b"\0" * (SECTION_HEADER_BYTES - len(head))


def pack_processor_header(pc) -> bytes:
    """The processor section's header, padded to SECTION_HEADER_BYTES."""
    head = struct.pack(_PROCESSOR_HEADER_FMT, pc.hidden_dim, pc.text_dim,
                       int(pc.quant), pc.group_size)
    return head + b"\0" * (SECTION_HEADER_BYTES - len(head))


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
               seq_len_header: Optional[int] = None, vision_cfg=None,
               processor_cfg=None) -> Dict[str, float]:
    """Serialize dense float weights to a .lmrs file, quantizing per
    cfg.quant.  `weights` maps layout names ("embed", "wq@0", ...) to float
    arrays of the layout shapes; with cfg.multimodal also the "v.*" and
    "p.*" tensors of `vision_cfg` and `processor_cfg`, each section
    quantized per its own config.  Returns per-tensor max quantization
    group errors."""
    errors: Dict[str, float] = {}

    def write_section(f, layout, quant, gs):
        for name, shape, quantized in layout:
            w = np.ascontiguousarray(weights[name], dtype=np.float32)
            if w.shape != shape:
                raise ValueError(f"{name}: shape {w.shape}, layout {shape}")
            if not quantized:
                f.write(w.tobytes())
                continue
            if quant == QuantType.Q8_0:
                qv, s, err = quantize_q80_np(w, gs)
            else:
                qv, s, err = quantize_q40_np(w, gs)
            f.write(qv.tobytes())
            f.write(s.astype(np.float32).tobytes())
            errors[name] = err

    if cfg.multimodal and (vision_cfg is None or processor_cfg is None):
        raise ValueError("a multimodal file needs vision_cfg and "
                         "processor_cfg")
    with open(path, "wb") as f:
        f.write(pack_header(cfg, seq_len_header))
        write_section(f, _tensor_layout(cfg), cfg.quant, cfg.group_size)
        if cfg.multimodal:
            f.write(pack_vision_header(vision_cfg))
            write_section(f, _vision_tensor_layout(vision_cfg),
                          vision_cfg.quant, vision_cfg.group_size)
            f.write(pack_processor_header(processor_cfg))
            write_section(f, _processor_tensor_layout(processor_cfg),
                          processor_cfg.quant, processor_cfg.group_size)
    return errors


class LmrsFile:
    """Zero-copy view of a .lmrs file's tensors (numpy memmap); a
    multimodal file's vision and processor tensors too, with their
    configs in `vision_cfg` and `processor_cfg`."""

    def __init__(self, path: str, max_seq_len: Optional[int] = None):
        self.path = path
        self.data = np.memmap(path, dtype=np.uint8, mode="r")
        self.cfg, self.version = parse_header(
            memoryview(self.data[:HEADER_BYTES]), max_seq_len)
        self.tensors: Dict[str, Tuple[np.ndarray, Optional[np.ndarray]]] = {}
        self.vision_cfg = None
        self.processor_cfg = None
        self._offset = HEADER_BYTES
        self._read_section(_tensor_layout(self.cfg), self.cfg.quant,
                           self.cfg.group_size)
        self._text_end = self._offset
        if self.cfg.multimodal:
            self._read_vision()
            self._read_processor()

    def _read_section(self, layout, qtype: QuantType, gs: int):
        for name, shape, quantized in layout:
            self.tensors[name] = self._read_tensor(shape, quantized, qtype,
                                                   gs)

    def _section_header(self, fmt: str):
        """Unpack a section header at the offset and move past its 128
        bytes."""
        head = self._take(SECTION_HEADER_BYTES)
        return struct.unpack_from(fmt, head.tobytes(), 0)

    def _read_vision(self):
        from lmrs_tpu_torch.models.vision import VisionConfig

        (dim, hidden, layers, heads, head_dim, eps, patch, img, qt,
         gs) = self._section_header(_VISION_HEADER_FMT)
        self.vision_cfg = VisionConfig(
            dim=dim, hidden_dim=hidden, n_layers=layers, n_heads=heads,
            head_dim=head_dim, layernorm_eps=eps, patch_size=patch,
            image_size=img, quant=QuantType(qt), group_size=gs)
        self._read_section(_vision_tensor_layout(self.vision_cfg),
                           QuantType(qt), gs)

    def _read_processor(self):
        from lmrs_tpu_torch.models.phi3v import ProcessorConfig

        hidden, text, qt, gs = self._section_header(_PROCESSOR_HEADER_FMT)
        self.processor_cfg = ProcessorConfig(
            hidden_dim=hidden, text_dim=text, quant=QuantType(qt),
            group_size=gs)
        self._read_section(_processor_tensor_layout(self.processor_cfg),
                           QuantType(qt), gs)

    def cfg_vision_processor(self):
        if self.vision_cfg is None:
            raise ValueError("model file has no vision section")
        return self.vision_cfg, self.processor_cfg

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
        """Offset after the text weights (the start of a multimodal file's
        vision section)."""
        return self._text_end


def read_lmrs(path: str, max_seq_len: Optional[int] = None) -> LmrsFile:
    return LmrsFile(path, max_seq_len)
