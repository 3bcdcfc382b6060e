"""The flash attention kernel's tolerance (`flash_attention_tol`) against
its two jobs, on the CPU: it admits the kernel's own rounding, and it
rejects a kernel that reads the wrong keys.

The kernel's arithmetic is emulated here in float32: 64-key tiles, an
online softmax whose unnormalized weights are rounded to bf16 before p.V
(`csrc/flash_attention.cu`).  The planted faults are the ones a tile walk
can make: one tile skipped, the window start one tile late, the causal
diagonal dropped.  No JAX: this checks the port's own bound.
"""

import numpy as np
import pytest
import torch

from lmrs_tpu_torch.kernels.flash_attention import (flash_attention_plain,
                                                    flash_attention_tol)

HD, KH, G, WINDOW, SOFTCAP, BKV = 256, 8, 2, 4096, 50.0, 64


def _emulate(q, k, v, pos, fault=None):
    """The kernel's online softmax over 64-key tiles, vectorized over the
    (token, head) rows; `fault` plants one tile-walk error."""
    t_q = q.shape[0]
    n = pos + t_q
    kf = k[:n].float().reshape(n, KH, HD)
    vf = v[:n].float().reshape(n, KH, HD)
    qb = q.to(torch.bfloat16).float().reshape(t_q, KH, G, HD)
    q_pos = pos + torch.arange(t_q)[:, None, None, None]
    lo = torch.clamp(q_pos - WINDOW + (BKV if fault == "window_start" else 0),
                     min=0)
    skip = (max(pos - WINDOW, 0) // BKV + 2) * BKV
    m = torch.full((t_q, KH, G, 1), -torch.inf)
    l = torch.zeros((t_q, KH, G, 1))
    o = torch.zeros((t_q, KH, G, HD))
    for kv0 in range(0, n, BKV):
        if fault == "skip_tile" and kv0 == skip:
            continue
        key = torch.arange(kv0, min(kv0 + BKV, n))
        s = torch.einsum("tkgd,skd->tkgs", qb, kf[key]) * HD ** -0.5
        s = torch.tanh(s / SOFTCAP) * SOFTCAP
        last = q_pos - (1 if fault == "causal" else 0)
        live = (key <= last) & (key >= lo) & (q_pos - key <= WINDOW)
        s = torch.where(live, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.where(m_new == -torch.inf, 1.0, torch.exp(m - m_new))
        p = torch.where(live, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + torch.einsum(
            "tkgs,skd->tkgd", p.to(torch.bfloat16).float(), vf[key])
        m = m_new
    return (o / l).reshape(t_q, KH * G, HD)


def _inputs(t_q, pos):
    rng = np.random.default_rng(pos + t_q)
    n = pos + t_q
    k = torch.from_numpy(rng.standard_normal((1, n, KH * HD),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((1, n, KH * HD),
                                             dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((t_q, KH * G, HD),
                                             dtype=np.float32))
    return q, k.to(torch.bfloat16), v.to(torch.bfloat16)


@pytest.mark.parametrize("t_q,pos,fault", [
    (1, 1100, None), (1, 6000, None), (3, 63, None), (16, 6000, None),
    (1, 1100, "skip_tile"), (1, 6000, "skip_tile"),
    (1, 6000, "window_start"), (16, 6000, "window_start"),
    (3, 63, "causal")])
def test_flash_tolerance_admits_rounding_rejects_faults(t_q, pos, fault):
    """Gemma-2-9B's attention shape (hd 256, 8 KV heads, 2 query heads
    each, window 4096, softcap 50): the emulated kernel stays within the
    bound everywhere; each planted fault exceeds it somewhere."""
    q, k, v = _inputs(t_q, pos)
    kw = dict(n_kv=KH, scale=HD ** -0.5, softcap=SOFTCAP, window=WINDOW)
    want = flash_attention_plain(q, k, v, 0, pos, **kw)
    tol = flash_attention_tol(q, k, v, 0, pos, **kw)
    ratio = ((_emulate(q, k[0], v[0], pos, fault) - want).abs() / tol).max()
    if fault is None:
        assert ratio <= 1.0
    else:
        assert ratio > 1.0
