"""Inputs of the per-slot and paged attention tests (kernels I and J): the
same K/V rows as a per-slot cache (B, L, S, row) and as a page pool (L, P,
psz, row) behind a shuffled page table, made with numpy from a seed.  Used
by tests/test_torch_batched_attention.py (CPU, against the JAX functions)
and tests/test_torch_cuda.py (the card); imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from lmrs_tpu_torch.quant import quantize_kv_rows, quantize_kv_rows_q4

GARBAGE = 77.0


def make_case(device, *, b, n_layers, s_len, kh, hd, cache, psz, pos, t_q,
              seed=0, g=2):
    """Random rows for `b` slots of `s_len` rows at positions `pos` (a list
    of b ints, pos[i] + t_q <= s_len), and q (b, t_q, kh * g, hd).

    Returns a dict: q, pos (b,) int32; `contig` = (k, v, k_scale, v_scale)
    of a per-slot cache (float caches: scales None); `paged` = (k_pool,
    v_pool, table, k_scale, v_scale) of a pool holding the same rows, with
    every slot's pages drawn in shuffled order from pages 1.. and page 0
    the trash page; `rows` the float rows (b, n_layers, s_len, kh, hd).
    Rows past a slot's last live row hold garbage in both layouts, and the
    trash page holds garbage too."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((b, n_layers, s_len, 2, kh, hd),
                               dtype=np.float32)
    rows *= 0.25 + 4 * rng.random((b, n_layers, s_len, 2, kh, 1),
                                  dtype=np.float32)
    rows = torch.from_numpy(rows)
    q = torch.from_numpy(rng.standard_normal((b, t_q, kh * g, hd),
                                             dtype=np.float32))
    kv = rows.permute(3, 0, 1, 2, 4, 5)            # (2, b, L, S, kh, hd)
    if cache in ("int8", "int4"):
        quantize = quantize_kv_rows if cache == "int8" else quantize_kv_rows_q4
        vals, sc = quantize(kv)                      # (2,b,L,S,row), (..,kh)
        sc = sc.permute(0, 1, 2, 4, 3).contiguous()  # (2, b, L, kh, S)
    else:
        dtype = torch.bfloat16 if cache == "bf16" else torch.float32
        vals = kv.reshape(2, b, n_layers, s_len, kh * hd).to(dtype)
        sc = None
    row = vals.shape[-1]
    for i, p in enumerate(pos):
        vals[:, i, :, p + t_q:] = (0x77 if vals.dtype == torch.int8
                                   else GARBAGE)
        if sc is not None:
            sc[:, i, :, :, p + t_q:] = GARBAGE

    # the pool: slot i's virtual page j at table[i, j]
    maxp = -(-s_len // psz)
    n_pages = 1 + b * maxp
    perm = rng.permutation(np.arange(1, n_pages)).reshape(b, maxp)
    table = torch.from_numpy(perm.astype(np.int32))
    pool = torch.empty((2, n_layers, n_pages, psz, row), dtype=vals.dtype)
    pool.fill_(0x77 if vals.dtype == torch.int8 else GARBAGE)
    padded = torch.full((2, b, n_layers, maxp * psz, row), 0,
                        dtype=vals.dtype)
    padded[:, :, :, :s_len] = vals
    pool_sc = None
    if sc is not None:
        pool_sc = torch.full((2, n_layers, n_pages, kh, psz), GARBAGE)
        sc_pad = torch.zeros((2, b, n_layers, kh, maxp * psz))
        sc_pad[..., :s_len] = sc
    for i in range(b):
        for j in range(maxp):
            pg = int(perm[i, j])
            pool[:, :, pg] = padded[:, i, :, j * psz:(j + 1) * psz]
            if sc is not None:
                pool_sc[:, :, pg] = sc_pad[:, i, :, :, j * psz:(j + 1) * psz]

    def dev(a):
        return None if a is None else a.contiguous().to(device)

    return dict(
        q=dev(q), pos=torch.tensor(pos, dtype=torch.int32, device=device),
        rows=rows,
        contig=(dev(vals[0]), dev(vals[1]),
                dev(None if sc is None else sc[0]),
                dev(None if sc is None else sc[1])),
        paged=(dev(pool[0]), dev(pool[1]), dev(table),
               dev(None if pool_sc is None else pool_sc[0]),
               dev(None if pool_sc is None else pool_sc[1])))


def spoil(case, keep: int):
    """Copies of the case's caches in which every slot but `keep`, and the
    pool's trash page and the pages of the other slots, hold NaN (integer
    caches: 0x77 with NaN scales)."""
    k, v, ks, vs = (None if a is None else a.clone() for a in case["contig"])
    kp, vp, table, pks, pvs = (None if a is None else a.clone()
                               for a in case["paged"])
    others = [i for i in range(k.shape[0]) if i != keep]
    mine = set(table[keep].tolist())
    foreign = [p for p in range(kp.shape[1]) if p not in mine]
    bad = 0x77 if k.dtype == torch.int8 else float("nan")
    for a in (k, v):
        a[others] = bad
    for a in (kp, vp):
        a[:, foreign] = bad
    for a in (ks, vs):
        if a is not None:
            a[others] = float("nan")
    for a in (pks, pvs):
        if a is not None:
            a[:, foreign] = float("nan")
    return (k, v, ks, vs), (kp, vp, table, pks, pvs)
