"""Kernel M's order of operations on the CPU.

Kernel M (flash_merge_kernel in lmrs_tpu_torch/csrc/flash_attention.cu)
merges a query row's splits: m_g = max of the live m_s, w_s = exp(m_s -
m_g) (0 for a split with no live key, m_s = -inf, whose acc may hold
anything and is never read), then num and den over s = 0, 1, ... one fused
multiply-add a split, out = num / den, or raw (the cp partials of B1):
num, m_g (_MASK_NEG where no split holds a live key) and den.  These tests
emulate that order with torch and hold:

- dead splits add exactly nothing: whatever their acc holds (here NaN or
  huge values), the merge gives the same bits, raw and normalized;
- the merge stays within `flash_merge_tol` of `flash_merge_plain`, raw and
  normalized, m_g exactly;
- B1's shard with no live key anywhere merges to m = _MASK_NEG, acc = l = 0.
"""

import numpy as np
import pytest
import torch

from lmrs_tpu_torch.kernels.flash_merge import (flash_merge_plain,
                                                flash_merge_tol)

torch.set_num_threads(1)

MASK_NEG = torch.finfo(torch.float32).min


def _pieces(n, t_q=2, h=4, hd=8, seed=0, dead=0.3, empty_rows=()):
    """Random raw pieces of n splits (B = 1): acc (1, n, T, H, hd), m and l
    (1, n, T, H); a share of (split, row) pairs hold no live key (m = -inf,
    l = 0, acc NaN: a kernel never writes it), and the rows of
    `empty_rows` have no live key in any split."""
    rng = np.random.default_rng(seed)
    acc = torch.from_numpy(rng.normal(0, 1, (1, n, t_q, h, hd))
                           .astype(np.float32))
    m = torch.from_numpy((3 * rng.normal(0, 1, (1, n, t_q, h)))
                         .astype(np.float32))
    l = torch.from_numpy((1 + rng.random((1, n, t_q, h))).astype(np.float32))
    gone = torch.from_numpy(rng.random((1, n, t_q, h)) < dead)
    gone[:, 0] = False                 # every row keeps one live split ...
    for t, hh in empty_rows:           # ... but the empty ones
        gone[:, :, t, hh] = True
    m[gone] = float("-inf")
    l[gone] = 0.0
    acc[gone] = float("nan")
    return acc, m, l


def merge_in_split_order(acc, m, l, raw=False):
    """Kernel M's order: m_g = max of the live m_s, w_s = exp(m_s - m_g)
    (0 for a dead split), then num and den over s = 0, 1, ... one fused
    multiply-add a split (emulated in f64, rounded to f32 each step)."""
    live = m != float("-inf")
    mg = torch.where(live, m, float("-inf")).amax(dim=1)
    w = torch.where(live, torch.exp(m - mg[:, None]), 0.0)
    num = torch.zeros(acc[:, 0].shape, dtype=torch.float32)
    den = torch.zeros(l[:, 0].shape, dtype=torch.float32)
    for s in range(acc.shape[1]):
        ws = w[:, s]
        a = torch.where(ws[..., None] != 0, acc[:, s], 0.0)
        ls = torch.where(ws != 0, l[:, s], 0.0)
        den = (ls.double() * ws.double() + den.double()).float()
        num = (a.double() * ws[..., None].double() + num.double()).float()
    if raw:
        return num, torch.where(live.any(dim=1), mg, MASK_NEG), den
    return num / den[..., None]


def _same(a, b):
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("n", [1, 2, 4, 5, 9, 47])
def test_dead_splits_add_nothing(n, raw):
    acc, m, l = _pieces(n, seed=n, empty_rows=[(1, 2)] if raw else ())
    got = merge_in_split_order(acc, m, l, raw)
    dead = (m == float("-inf"))[..., None].expand_as(acc)
    for fill in (0.0, 3e38, -3e38):
        other = acc.clone()
        other[dead] = fill
        assert _same(merge_in_split_order(other, m, l, raw), got)
    want = flash_merge_plain(acc, m, l, raw)
    tol = flash_merge_tol(acc, m, l, raw)
    g0, w0 = (got[0], want[0]) if raw else (got, want)
    assert torch.isfinite(g0).all()
    assert ((g0 - w0).abs() <= tol).all()
    if raw:
        assert torch.equal(got[1], want[1])
        assert (got[1][0, 1, 2] == MASK_NEG) and (got[2][0, 1, 2] == 0)


def test_b1_empty_shard_merges_to_mask_neg():
    """A cp shard that holds no live key for any row (every split at
    m = -inf): raw merge m = _MASK_NEG, acc = l = 0, in the kernel's order
    and in the plain version."""
    n = 4
    acc, m, l = _pieces(n, seed=7)
    m[:] = float("-inf")
    l[:] = 0.0
    acc[:] = float("nan")
    for num, mg, den in (merge_in_split_order(acc, m, l, raw=True),
                         flash_merge_plain(acc, m, l, raw=True)):
        assert (mg == MASK_NEG).all() and (num == 0).all() \
            and (den == 0).all()


@pytest.mark.parametrize("n", [3, 17, 64])
def test_split_order_merge_within_the_merge_tolerance(n):
    acc, m, l = _pieces(n, t_q=5, h=8, hd=64, seed=100 + n)
    for raw in (False, True):
        got = merge_in_split_order(acc, m, l, raw)
        want = flash_merge_plain(acc, m, l, raw)
        tol = flash_merge_tol(acc, m, l, raw)
        g0, w0 = (got[0], want[0]) if raw else (got, want)
        assert ((g0 - w0).abs() <= tol).all()
        if raw:
            assert torch.equal(got[1], want[1])
