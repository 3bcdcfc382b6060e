"""Random model weights made on the card from the run's seed.

The weights are inputs of the benchmark, made by it and handed to both
sides: the port gets them as its `TransformerParams` (quantized matrices in
the runtime layout the port's loader builds), the plain reference reads the
same bytes and scales through its own decoding (`reference/`).  Each kind
of matrix is made for all layers in one call of a `torch.Generator` on the
card, in the type it is served in, and the layers are views of it.

Values: uniform and centred, -7..7 (Q4_0) or -127..127 (Q8_0), as the
exporter's symmetric rounding leaves them: a value range with a mean off 0
(all 16 nibbles, say) gives every row of every matrix a shared component,
the residual stream a fixed direction, and the logits the same few
winners by wide margins whatever the input.  A group's scale |s| =
U(0.5, 1.5) / (std(values) sqrt(fan_in)), so a matrix keeps its input's
scale; negative for Q4_0 as the exporter writes it (absmax / -7.5).  Norm
weights are U(0.9, 1.1).

What matrices a model has, and how they are handed to the port, is its
architecture's (`arch/<model_type>.py`); this module holds what they
share.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch

# the spread of a uniform value in -7..7 or -127..127
VALUE_STD = {"Q4_0": math.sqrt((15 ** 2 - 1) / 12),
             "Q8_0": math.sqrt((255 ** 2 - 1) / 12)}


@dataclasses.dataclass
class QMat:
    """A quantized (out, in) matrix as the benchmark made it: `q` uint8
    runtime-layout Q4 bytes (out, in/2) or int8 values (out, in), `s` f32
    group scales (out, in/gs)."""

    q: torch.Tensor
    s: torch.Tensor
    quant: str
    gs: int
    out_f: int
    in_f: int


def port_qtensor(m: QMat):
    """The port's `QTensor` over the same tensors (no copy)."""
    from lmrs_tpu_torch.config import QuantType
    from lmrs_tpu_torch.quant import QTensor

    return QTensor(m.q, m.s, QuantType[m.quant], m.gs, m.out_f, m.in_f)


def seed_gen(gen: torch.Generator, seed: int, salt: int) -> torch.Generator:
    gen.manual_seed((seed * 1_000_003 + salt) % (1 << 63))
    return gen


def random_qmats(gen: torch.Generator, n: int, out_f: int, in_f: int,
                 quant: str, gs: int, device) -> List[QMat]:
    """n quantized (out_f, in_f) matrices made in two calls, views of one
    stacked (n, ...) tensor each."""
    q, s = random_stack(gen, n, out_f, in_f, quant, gs, device)
    return [QMat(q[i], s[i], quant, gs, out_f, in_f) for i in range(n)]


def random_stack(gen: torch.Generator, n: int, out_f: int, in_f: int,
                 quant: str, gs: int, device):
    """(values, scales) of n quantized matrices, stacked on a leading
    axis."""
    if quant == "Q4_0":
        # nibble codes 1..15 (values -7..7), two to a byte: the runtime
        # layout's byte is (lo | hi << 4) ^ 0x80
        shape = (n, out_f, in_f // 2)
        lo = torch.randint(1, 16, shape, dtype=torch.uint8, device=device,
                           generator=gen)
        hi = torch.randint(1, 16, shape, dtype=torch.uint8, device=device,
                           generator=gen)
        q = (lo | (hi << 4)) ^ 0x80
        del lo, hi
        sign = -1.0
    elif quant == "Q8_0":
        q = torch.randint(-127, 128, (n, out_f, in_f), dtype=torch.int8,
                          device=device, generator=gen)
        sign = 1.0
    else:
        raise ValueError(f"no random weights of type {quant!r}")
    mag = 1.0 / (VALUE_STD[quant] * math.sqrt(in_f))
    s = torch.rand((n, out_f, in_f // gs), device=device, generator=gen)
    s = (s + 0.5) * (sign * mag)
    return q, s
