"""Flash-decoding on the CPU: the cp partials form of kernel I (B1,
`flash_attention_batched(..., seq_base=, return_lse=True)`) and kernel M's
merge, in their plain versions, against the JAX package.

- B1 against `lmrs_tpu.kernels.flash_attention.flash_decode_batched(...,
  seq_base=, return_lse=True)` in interpret mode, for bf16, f32 and int8
  caches, t_q 1 and 3, with and without a window, on the four shards of a
  512-row cache: for some slot each shard lies before its window, holds
  its position, holds part of its verify window, or lies wholly past it.
- The shards' partials merged (kernel M's plain version) against the
  unsharded JAX call and the port's unsharded plain version.
- Partials at the kernel's split (SPLIT) merged against the unsplit
  plain version of C and G, at positions on and next to split boundaries
  and the window's edge.

Tolerances, stated at each assert:
- B1's acc against JAX on rows with a live key in the shard: per element
  within `flash_attention_batched_tol(..., return_lse=True)`, (2^-7 +
  2^-9) times the plain raw acc on |v| (both round their unnormalized
  softmax weights to bf16, the TPU kernel block by block); m within 1e-5
  (the same largest score, f32 sums of hd products in another order); l
  within 1e-4 relative (each exp(s - m) moves by |s| 2^-24 of itself when
  s moves by its last bit, and s reaches 50 under the softcap).  A row
  with no live key in the shard: m == _MASK_NEG exactly (JAX's acc and l
  there are not comparable: its kernel adds exp(MASK - MASK) = 1 for each
  masked column).
- Merged partials: per element within the unsharded plain version's bound
  (`flash_attention_batched_tol`, `flash_attention_tol`,
  `flash_attention_i8_tol`): the merge only rescales the weights in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmrs_tpu.kernels.flash_attention import flash_decode_batched

from lmrs_tpu_torch.kernels import launches, reset_launches
from lmrs_tpu_torch.kernels.flash_attention import (flash_attention_plain,
                                                    flash_attention_tol)
from lmrs_tpu_torch.kernels.flash_attention_batched import (
    flash_attention_batched, flash_attention_batched_plain,
    flash_attention_batched_tol)
from lmrs_tpu_torch.kernels.flash_attention_i8 import (
    flash_attention_i8_plain, flash_attention_i8_tol)
from lmrs_tpu_torch.kernels.flash_merge import (SPLIT, flash_merge,
                                                flash_merge_plain,
                                                n_splits_device,
                                                n_splits_host)
from lmrs_tpu_torch.ops.attention import attention_batched_partials
from lmrs_tpu_torch.quant import quantize_kv_rows
from torch_batched_cases import make_case

torch.set_num_threads(1)

MASK_NEG = float(np.finfo(np.float32).min)
S_LEN, SHARD, KH, G, HD = 512, 128, 2, 3, 128
WINDOW = 64
# slot 0: shard 0 before its window, shard 2 holds pos; slot 1: a verify
# window of 3 rows across shards 0 and 1; slot 2: shards 1-3 wholly past
POS = [300, 126, 20]


def _np(a):
    if a is None:
        return None
    if a.dtype == torch.bfloat16:
        return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(a.numpy())


def _case(cache, t_q):
    case = make_case("cpu", b=len(POS), n_layers=2, s_len=S_LEN, kh=KH,
                     hd=HD, cache=cache, psz=64, pos=POS, t_q=t_q,
                     seed=t_q * 10 + len(cache), g=G)
    return case


def _shard(a, i, axis):
    return None if a is None else \
        a.narrow(axis, i * SHARD, SHARD).contiguous()


def _live_rows(t_q, base, window):
    """(B, T, H) bool: rows with a live key in the shard [base, base +
    SHARD)."""
    live = np.zeros((len(POS), t_q, KH * G), bool)
    for b, p in enumerate(POS):
        for t in range(t_q):
            lo = max(p + t - window, 0) if window is not None else 0
            live[b, t] = max(lo, base) <= min(p + t, base + SHARD - 1)
    return live


@pytest.mark.parametrize("cache", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("t_q", [1, 3])
@pytest.mark.parametrize("window", [WINDOW, None])
def test_b1_partials_match_flash_decode_batched(cache, t_q, window):
    case = _case(cache, t_q)
    k, v, ks, vs = case["contig"]
    q, pos = case["q"], case["pos"]
    kw = dict(n_kv=KH, scale=HD ** -0.5,
              softcap=50.0 if window else None, window=window)
    parts = []
    for i in range(S_LEN // SHARD):
        base = i * SHARD
        sk, sv = _shard(k, i, 2), _shard(v, i, 2)
        sks, svs = _shard(ks, i, 3), _shard(vs, i, 3)
        want = flash_decode_batched(
            jnp.asarray(q.numpy() if t_q > 1 else q[:, 0].numpy()), _np(sk),
            _np(sv), jnp.int32(1), jnp.asarray(pos.numpy()),
            attn_len=SHARD, s_blk=64, interpret=True, k_scale=_np(sks),
            v_scale=_np(svs), seq_base=jnp.int32(base), return_lse=True,
            **kw)
        want = [np.asarray(a) if t_q > 1 else np.asarray(a)[:, None]
                for a in want]
        reset_launches()
        got = flash_attention_batched(q, sk, sv, 1, pos, k_scale=sks,
                                      v_scale=svs, seq_base=base,
                                      return_lse=True, **kw)
        assert launches()["flash_attention_batched"] == 0   # plain version
        tol = flash_attention_batched_tol(q, sk, sv, 1, pos, k_scale=sks,
                                          v_scale=svs, seq_base=base,
                                          return_lse=True, **kw).numpy()
        acc, m, l = (a.numpy() for a in got)
        live = _live_rows(t_q, base, window)
        # module note: acc per element, m 1e-5, l 1e-4 relative
        assert (np.abs(acc - want[0]) <= tol)[live].all()
        np.testing.assert_allclose(m[live], want[1][live], rtol=0, atol=1e-5)
        np.testing.assert_allclose(l[live], want[2][live], rtol=1e-4)
        assert (m[~live] == MASK_NEG).all()
        assert (acc[~live] == 0).all() and (l[~live] == 0).all()
        parts.append(got)

    # the shards merged (kernel M's plain version) against the unsharded
    # calls, within the unsharded plain version's bound
    merged = flash_merge(*(torch.stack([p[j] for p in parts], dim=1)
                           for j in range(3)))
    whole = flash_decode_batched(
        jnp.asarray(q.numpy() if t_q > 1 else q[:, 0].numpy()), _np(k),
        _np(v), jnp.int32(1), jnp.asarray(pos.numpy()), attn_len=S_LEN,
        s_blk=64, interpret=True, k_scale=_np(ks), v_scale=_np(vs), **kw)
    whole = np.asarray(whole) if t_q > 1 else np.asarray(whole)[:, None]
    plain = flash_attention_batched_plain(q, k, v, 1, pos, k_scale=ks,
                                          v_scale=vs, **kw).numpy()
    tol = flash_attention_batched_tol(q, k, v, 1, pos, k_scale=ks,
                                      v_scale=vs, **kw).numpy()
    assert (np.abs(merged.numpy() - whole) <= tol).all()
    assert (np.abs(merged.numpy() - plain) <= tol).all()


def _single_cache(cache, s_len, kh, hd, seed):
    rng = np.random.default_rng(seed)
    kv = torch.from_numpy(rng.standard_normal((2, s_len, kh, hd),
                                              dtype=np.float32))
    if cache == "int8":
        rows, sc = quantize_kv_rows(kv)
        return (rows[0][None], rows[1][None], sc[0].t()[None].contiguous(),
                sc[1].t()[None].contiguous())
    rows = kv.reshape(2, s_len, kh * hd).to(torch.bfloat16)
    return rows[0][None], rows[1][None], None, None


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("t_q", [1, 5])
def test_split_partials_merge_to_the_unsplit_plain_version(cache, t_q):
    """C's (G's) plain version against its own rows cut at the kernel's
    split: partials of each split (B1's plain form, seq_base = the split's
    first row), merged by kernel M's plain version."""
    kh, g, hd, window = 2, 2, 128, 300
    split = SPLIT
    s_len = 4 * split
    k, v, ks, vs = _single_cache(cache, s_len, kh, hd, seed=t_q)
    kw = dict(n_kv=kh, scale=hd ** -0.5, softcap=50.0, window=window)
    rng = np.random.default_rng(100 + t_q)
    for pos in (split - 1, split, 2 * split - 1, window + split,
                window + split - 1, s_len - t_q):
        q = torch.from_numpy(rng.standard_normal((t_q, kh * g, hd),
                                                 dtype=np.float32))
        parts = []
        for s in range(s_len // split):
            rows = slice(s * split, (s + 1) * split)
            parts.append(attention_batched_partials(
                q[None], k[0, rows].reshape(1, split, kh, hd),
                v[0, rows].reshape(1, split, kh, hd),
                torch.tensor([pos]), seq_base=s * split, scale=kw["scale"],
                softcap=kw["softcap"], window=window,
                k_scale=None if ks is None else ks[:, :, rows],
                v_scale=None if vs is None else vs[:, :, rows]))
        got = flash_merge_plain(*(torch.stack([p[j] for p in parts], dim=1)
                                  for j in range(3)))[0]
        if cache == "bf16":
            want = flash_attention_plain(q, k, v, 0, pos, **kw)
            tol = flash_attention_tol(q, k, v, 0, pos, **kw)
        else:
            want = flash_attention_i8_plain(q, k, v, ks, vs, 0, pos, **kw)
            tol = flash_attention_i8_tol(q, k, v, ks, vs, 0, pos, **kw)
        # within the unsplit plain version's bound (module note)
        assert ((got - want).abs() <= tol).all(), pos


def test_merge_raw_and_normalized_agree():
    """Kernel M's plain version: the normalized merge is the raw merge's
    acc / l; a split at m = -inf adds nothing whatever its acc holds; a row
    with no live split merges to m = _MASK_NEG, acc = l = 0."""
    rng = np.random.default_rng(3)
    acc = torch.from_numpy(rng.standard_normal((2, 5, 3, 4, 64),
                                               dtype=np.float32))
    m = torch.from_numpy(rng.standard_normal((2, 5, 3, 4),
                                             dtype=np.float32))
    l = torch.from_numpy(rng.random((2, 5, 3, 4), dtype=np.float32)) + 0.5
    m[0, 1] = float("-inf")
    acc[0, 1] = float("nan")              # never read
    m[1, :, 2] = float("-inf")            # row (1, 2, :) has no live split
    l[1, :, 2] = 0.0
    reset_launches()
    out = flash_merge(acc, m, l)
    num, mg, den = flash_merge(acc, m, l, raw=True)
    assert launches()["flash_merge"] == 0          # CPU: plain version
    torch.testing.assert_close(out[0], num[0] / den[0, ..., None])
    assert torch.isfinite(num[0]).all()
    assert (mg[1, 2] == MASK_NEG).all() and (num[1, 2] == 0).all() \
        and (den[1, 2] == 0).all()
    keep = [0, 2, 3, 4]
    alone = flash_merge(acc[:, keep], m[:, keep], l[:, keep])
    # the same terms, summed by torch in another grouping: f32 roundings
    torch.testing.assert_close(alone[0], out[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window", [None, 64, 300])
@pytest.mark.parametrize("t_q", [1, 5, 21, 30])
def test_split_axis_covers_every_live_row(window, t_q):
    """The grid's split axis, counted from the split of a query block's
    first live row: n_splits_device, which knows no position, reaches the
    last live row of every query block at every position, and
    n_splits_host (decode calls: one query block, G*T <= 64) is the number
    of splits the block's live range touches."""
    s_len, g, split = 1024, 3, 128
    for pos in range(0, s_len - t_q + 1, 7):
        n_dev = n_splits_device(s_len, t_q, window, split)
        for r0 in range(0, g * t_q, 64):
            t_lo = r0 // g
            t_hi = (min(r0 + 64, g * t_q) - 1) // g
            lo = max(pos + t_lo - window, 0) if window is not None else 0
            hi = pos + t_hi
            assert (lo // split + n_dev) * split > hi
        if g * t_q <= 64:
            n = n_splits_host(pos, t_q, s_len, window, split)
            lo = max(pos - window, 0) if window is not None else 0
            assert n == len(range(lo // split, (pos + t_q - 1) // split + 1))
            assert n <= n_dev
