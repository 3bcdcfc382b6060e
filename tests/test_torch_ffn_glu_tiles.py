"""Kernel L's first stage (ffn_fused.cu on csrc/qgemm_sm90.cuh, Epi::Glu)
on the CPU: how its tiles pair the gate and up rows of W13, and its plain
version against the JAX package's `ffn_fused_pallas` at T = 12.

A tile of the GLU stage holds 64 gate rows j0..j0+63 and their 64 up rows
H+j0.., read through two TMA maps of H rows each (gate: rows [0, H) of
W13, up: rows [H, 2H)); a box that runs past a map's last row reads zeros.
The epilogue takes quads of 4 gate rows and the quad 64 rows later, and
writes g[t, j] = bf16(act(gate_j) * up_j) for j < H.  The emulation below
walks those tiles, boxes and quads as the kernel does and holds:

- every g[t, j] pairs gate row j with up row H + j, every row of W13 is
  read by exactly one box, and no box reads past its map (the gate map
  never reaches an up row), for H = 96 at gs = 32 (H not a multiple of
  the 64-row half-tile), the tiny presets' H = 512 and the models' H;
- a quad of 4 rows is all inside H or all outside (H % 4 == 0 for every
  H the wrapper takes: a multiple of gs >= 32);
- g from the emulated tiles equals, bit for bit, the GLU of the plain
  product's gate and up halves (the same per-row sums).

Tolerance of the JAX parity test: 1e-3 of max|y|, as
tests/test_torch_ffn_fused.py states it (the same bf16 operands and exact
products, f32 sums in another order, a g value's bf16 rounding flipped by
a last-bit difference of its f32 gate or up).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.kernels.fused_ffn import ffn_fused_pallas

from lmrs_tpu_torch.kernels.ffn_fused import (ffn_fused_plain, glu_bf16)
from lmrs_tpu_torch.kernels.q4_gemm import dequant_bf16 as dequant_q4
from lmrs_tpu_torch.kernels.q8_gemm import dequant_bf16 as dequant_q8
from test_torch_ffn_fused import D, GS, TOL, _case, _jax_pair

torch.set_num_threads(1)

HALF_TILE = 64          # gate rows (and up rows) a tile


def tiles(h: int):
    """For each tile: the rows of W13 its gate box and its up box read
    (None past the map's last row, read as zeros)."""
    out = []
    for j0 in range(0, h, HALF_TILE):
        gate = [j0 + r if j0 + r < h else None for r in range(HALF_TILE)]
        up = [h + j0 + r if j0 + r < h else None for r in range(HALF_TILE)]
        out.append((j0, gate, up))
    return out


@pytest.mark.parametrize("h", [96, 160, 320, 512, 8192, 14336])
def test_tiles_pair_gate_and_up_rows(h):
    read = []
    pairs = {}
    for j0, gate, up in tiles(h):
        assert all(r is None or r < h for r in gate)         # gate map only
        assert all(r is None or h <= r < 2 * h for r in up)  # up map only
        read += [r for r in gate + up if r is not None]
        for quad in range(HALF_TILE // 4):
            rows = range(4 * quad, 4 * quad + 4)
            inside = [j0 + r < h for r in rows]
            assert all(inside) or not any(inside)
            for r in rows:
                if j0 + r < h:
                    pairs[j0 + r] = (gate[r], up[r])
    assert sorted(read) == list(range(2 * h))
    assert pairs == {j: (j, h + j) for j in range(h)}


def _rows_product(x, w):
    """Each row's sum over K in f64 rounded to f32: the same bits for a row
    whatever other rows are computed beside it."""
    return (x.double()[:, None, :] * w.double()[None]).sum(-1).float()


@pytest.mark.parametrize("quant", ["q4", "q8"])
@pytest.mark.parametrize("h,gs", [(96, 32), (512, 32), (320, 64)])
def test_emulated_tiles_give_the_plain_glu(quant, h, gs):
    d = 128
    rng = np.random.default_rng(h + gs)
    x = torch.from_numpy(rng.normal(0, 1, (12, d)).astype(np.float32))
    xb = x.to(torch.bfloat16).float()
    if quant == "q4":
        q = torch.from_numpy(rng.integers(0, 256, (2 * h, d // 2),
                                          dtype=np.uint8))
        s = torch.from_numpy(-0.003 * (0.5 + rng.random((2 * h, d // gs)))
                             ).float()
        w = dequant_q4(q, s, gs).float()
    else:
        q = torch.from_numpy(rng.integers(-127, 128, (2 * h, d),
                                          dtype=np.int8))
        s = torch.from_numpy(1e-4 * (0.5 + rng.random((2 * h, d // gs)))
                             ).float()
        w = dequant_q8(q, s, gs).float()
    zero = torch.zeros(d)
    g = torch.full((12, h), float("nan"), dtype=torch.bfloat16)
    for j0, gate, up in tiles(h):
        wg = torch.stack([w[r] if r is not None else zero for r in gate])
        wu = torch.stack([w[r] if r is not None else zero for r in up])
        tile = glu_bf16(_rows_product(xb, wg), _rows_product(xb, wu),
                        "gelu")
        live = min(HALF_TILE, h - j0)
        g[:, j0:j0 + live] = tile[:, :live]
    gu = _rows_product(xb, w)
    want = glu_bf16(gu[:, :h], gu[:, h:], "gelu")
    assert torch.equal(g.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("quant", ["q4", "q8"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ffn_fused_plain_matches_jax_at_t12(quant, act):
    """Reference: ffn_fused_pallas -> _ffn_kernel (fused_ffn.py:242) at
    T = 12, between the 9 and 16 that test_torch_ffn_fused.py covers."""
    t = 12
    x, w13p, w2, jq, port = _case(quant, t, seed=10 * t + len(act))
    j13, j2 = _jax_pair(w13p, w2, jq, stacked=False)
    want = np.asarray(ffn_fused_pallas(jnp.asarray(x), j13, j2, act=act,
                                       interpret=True))
    got = ffn_fused_plain(torch.from_numpy(x), *port, GS, act).numpy()
    assert got.shape == (t, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
