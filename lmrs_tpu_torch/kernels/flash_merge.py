"""Kernel M and the split pass of the flash template (flash-decoding).
CUDA source: `lmrs_tpu_torch/csrc/flash_attention.cu`, whose header note
names what they replace and their design.

A decode call of kernels C, G, H, I or J (one 64-row query block per kv
head: G*T <= 64) runs in two launches from one host call.  The split
pass is the template with a split axis in its grid: split s owns the
cache rows [s*SPLIT, (s+1)*SPLIT) of the call's live range and writes its
raw online-softmax pieces (acc, m, l) to a workspace that the wrapper
allocates here.  Kernel M merges each query row's splits in increasing
split order: m_g = max m_s, w_s = exp(m_s - m_g), out = sum acc_s w_s /
sum l_s w_s; a split that holds no live key for the row (m_s = -inf) adds
nothing.  The same merge with `raw=True` leaves out the division and
returns (acc, m, l): the cp partials of `flash_attention_batched(...,
seq_base=, return_lse=True)` (the JAX `flash_decode_batched` contract, a
row with no live key at m = _MASK_NEG).

SPLIT is a fixed number of rows, a multiple of the 64-row tile, chosen by
measurement on the card (PERF.md): it never depends on the position, T or
B, so a row's split boundaries are the same global rows in every call, and
a row of a T = 5 call equals the row computed alone bit for bit.

What bounds kernel M is its place as a second launch, not its bytes: its
blocks wait for the split pass's last one.  Its merge folded into the
split pass's last block of each group was measured slower on an H100
(1.05-1.32x the device time of a decode call: one block a group runs the
merge's L2 round trips in series), so the two launches stay (PERF.md §6);
M is a programmatic dependent launch: its blocks are resident and waiting
(griddepcontrol.wait) when the split pass ends, which cut a decode call's
span by ~1.4 us on an H100 at every geometry and cache type measured.

`flash_merge` launches kernel M for CUDA tensors (or raises) and runs its
plain version for CPU tensors; `flash_merge.launches` counts kernel M's
launches, those that `split_pass(..., out=)` makes behind the split pass
included.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lmrs_tpu_torch.kernels import cuda

BKV = 64        # K/V rows per tile of the template
BQ = 64         # query rows per block of the template
# the C entry points' cache type numbers
BF16, F32, I8, I4_HALF, I4_PAIR = range(5)
# rows per split: of {128, 256, 512} the fastest at T = 1, pos 1,100 and
# 6,000 for every head dim and cache type measured on an H100
# (`scripts/torch_flash_ab.py --splits`, PERF.md).  0 turns the split off:
# each block walks its whole range in one launch, as the template did
# before flash-decoding (`scripts/torch_flash_ab.py` runs the parent so)
SPLIT = 128
_MASK_NEG = torch.finfo(torch.float32).min


def decode_split(n_heads: int, n_kv: int, t_q: int) -> int:
    """Rows per split of a call, or 0 for one unsplit launch.  Decode calls
    split: one query block per kv head (G*T <= 64).  Longer calls (prefill
    chunks) already fill the card with query blocks."""
    return SPLIT if (n_heads // n_kv) * t_q <= BQ else 0


def n_splits_host(pos: int, t_q: int, s_len: int, window: Optional[int],
                  split: int) -> int:
    """The split axis of a decode call (one query block per kv head) of one
    sequence whose position the host knows: the splits its live range
    [window start of query 0, pos + T - 1] touches."""
    lo = max(pos - window, 0) if window is not None else 0
    hi = min(pos + t_q - 1, s_len - 1)
    return hi // split - lo // split + 1


def n_splits_range(pos_lo: int, pos_hi: int, t_q: int, s_len: int,
                   window: Optional[int], split: int) -> int:
    """The split axis of a decode call of one sequence whose position
    stays on the device, known on the host to lie in [pos_lo, pos_hi]: the
    splits from the window start of pos_lo to pos_hi + T - 1.  A position
    p of the range touches n_splits_host(p) of them, counted from the
    split of its own window start, so its live splits come first and the
    ones past them exit at once; kernel M stops at the last live split, so
    the result is the host-position call's bit for bit."""
    lo = max(pos_lo - window, 0) if window is not None else 0
    hi = min(pos_hi + t_q - 1, s_len - 1)
    return hi // split - lo // split + 1


def n_splits_device(s_len: int, t_q: int, window: Optional[int],
                    split: int) -> int:
    """The split axis when the positions stay on the device (I, J, B1):
    every split of the operand's rows, or, under a window, as many as a
    live range of window + T rows can touch; splits past a slot's live
    range exit at once."""
    n = -(-s_len // split)
    if window is not None:
        n = min(n, -(-(window + t_q) // split) + 1)
    return n


def _entry(name: str):
    """lmrs_flash_partials, or lmrs_flash_decode (the same arguments with
    a workspace and an output in place of acc, m and l: the split pass and
    kernel M in one call from the host)."""
    fn = getattr(cuda.library("flash_attention"), name)
    if fn.argtypes is None:
        p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_longlong)
        bufs = [p, p, p] if name == "lmrs_flash_partials" else [p, p]
        fn.argtypes = [p, p, p, p, p, *bufs, i, i, i, i, i, i, i, p, i, i,
                       ll, ll, p, i, i, i, i, f, f, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def split_pass(q: torch.Tensor, k, v, ks, vs, *, n_kv: int, s_len: int,
               row: int, pos, seq_base: int, slot_stride: int,
               scale_slot_stride: int, table, maxp: int, psz: int,
               split: int, n_split: int, scale: float,
               softcap: Optional[float], window: Optional[int], ctype: int,
               what: str, out: Optional[torch.Tensor] = None):
    """Launch the template's split pass on q (B, T, H, hd), or (T, H, hd)
    for one sequence, contiguous f32; k, v (ks, vs) are tensors of the
    layer's first row (scale) or None, pos a (B,) int32 device tensor or a
    host int (B = 1).  Returns the workspace: acc (B, n_split, T, H, hd),
    m and l (B, n_split, T, H).  With `out` (q's shape, f32) the same host
    call also launches kernel M into it, over a workspace of one
    allocation, and returns out: a decode call's two launches for the host
    cost of about one."""
    *lead, t_q, n_heads, hd = q.shape
    b = lead[0] if lead else 1
    if out is None:
        acc = torch.empty((b, n_split, t_q, n_heads, hd),
                          dtype=torch.float32, device=q.device)
        m = torch.empty((b, n_split, t_q, n_heads), dtype=torch.float32,
                        device=q.device)
        l = torch.empty_like(m)
        bufs = (acc.data_ptr(), m.data_ptr(), l.data_ptr())
    else:
        ws = torch.empty(b * n_split * t_q * n_heads * (hd + 2),
                         dtype=torch.float32, device=q.device)
        bufs = (ws.data_ptr(), out.data_ptr())
    on_device = isinstance(pos, torch.Tensor)
    err = _entry("lmrs_flash_partials" if out is None
                 else "lmrs_flash_decode")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), *bufs, b, t_q, n_heads,
        n_kv, hd, s_len, row, pos.data_ptr() if on_device else None,
        0 if on_device else int(pos), int(seq_base), slot_stride,
        scale_slot_stride, None if table is None else table.data_ptr(),
        maxp, psz, split, n_split, scale,
        0.0 if softcap is None else float(softcap),
        -1 if window is None else int(window), ctype,
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda.check(err, what)
    if out is None:
        return acc, m, l
    flash_merge.launches += 1
    return out


def decode_single(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ks,
                  vs, *, n_kv: int, s_len: int, row: int, pos,
                  split: int, scale: float, softcap: Optional[float],
                  window: Optional[int], ctype: int, what: str,
                  pos_range: Optional[Tuple[int, int]] = None
                  ) -> torch.Tensor:
    """A decode call of C, G or H: the split pass over one sequence (q (T,
    H, hd) contiguous f32; k, v (ks, vs) one layer of the cache (scales)),
    then kernel M -> (T, H, hd).  `pos` is a host int, whose splits size
    the grid, or a (1,) int32 tensor on q's device with host bounds
    `pos_range` = (lo, hi), which size it (`n_splits_range`)."""
    if isinstance(pos, torch.Tensor):
        n = n_splits_range(*pos_range, q.shape[0], s_len, window, split)
    else:
        n = n_splits_host(pos, q.shape[0], s_len, window, split)
    return split_pass(q, k, v, ks, vs, n_kv=n_kv, s_len=s_len, row=row,
                      pos=pos, seq_base=0, slot_stride=0,
                      scale_slot_stride=0, table=None, maxp=0, psz=0,
                      split=split, n_split=n, scale=scale, softcap=softcap,
                      window=window, ctype=ctype, what=what,
                      out=torch.empty_like(q))


def flash_merge_plain(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                      raw: bool = False):
    """Plain PyTorch version of kernel M: acc (B, n, T, H, hd), m and l (B,
    n, T, H) merged over axis 1.  A split with m = -inf adds nothing (its
    acc may hold anything); a row with no live key anywhere merges to
    m = _MASK_NEG, acc = l = 0 (raw) or 0 / 0 (normalized)."""
    if acc.is_cuda:
        cuda.plain_numerics()
    live = m != float("-inf")
    mg = m.amax(dim=1)
    w = torch.where(live, torch.exp(m - mg[:, None]), 0.0)
    num = (torch.where(live[..., None], acc, 0.0) * w[..., None]).sum(dim=1)
    den = (l * w).sum(dim=1)
    if raw:
        return num, torch.where(live.any(dim=1), mg, _MASK_NEG), den
    return num / den[..., None]


def flash_merge_tol(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                    raw: bool = False) -> torch.Tensor:
    """Per-element bound on |kernel M - plain version| of the merged acc
    (raw) or output: both compute the same weights and sums in f32, in
    another order and with exp on two libraries, so each term of the sum
    carries a few f32 roundings, and n terms summed in another order add
    up to n of them: 2^-16 of the sum of |acc_s| w_s (and of that over the
    denominator for a normalized output) covers 100 splits."""
    a = flash_merge_plain(acc.abs(), m, l, raw=True)[0]
    if not raw:
        a = a / flash_merge_plain(acc, m, l, raw=True)[2][..., None]
    return 2.0 ** -16 * a


def _merge_entry():
    fn = cuda.library("flash_attention").lmrs_flash_merge
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_merge(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                raw: bool = False):
    """Kernel M: acc (B, n, T, H, hd), m and l (B, n, T, H) f32 merged over
    their n splits -> (B, T, H, hd) f32, or with `raw` (acc (B, T, H, hd),
    m (B, T, H), l (B, T, H))."""
    if not acc.is_cuda:
        return flash_merge_plain(acc, m, l, raw)
    b, n, t_q, n_heads, hd = acc.shape
    for a in (acc, m, l):
        if a.dtype != torch.float32 or not a.is_contiguous() \
                or a.device != acc.device:
            raise ValueError("flash_merge needs contiguous f32 tensors on "
                             "one device")
    if m.shape != (b, n, t_q, n_heads) or l.shape != m.shape or hd > 256 \
            or n > 12288:
        raise ValueError(f"flash_merge: acc {tuple(acc.shape)}, m "
                         f"{tuple(m.shape)}, l {tuple(l.shape)} do not fit")
    out = torch.empty((b, t_q, n_heads, hd), dtype=torch.float32,
                      device=acc.device)
    out_m = out_l = None
    if raw:
        out_m = torch.empty((b, t_q, n_heads), dtype=torch.float32,
                            device=acc.device)
        out_l = torch.empty_like(out_m)
    err = _merge_entry()(
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(),
        None if out_m is None else out_m.data_ptr(),
        None if out_l is None else out_l.data_ptr(), b, n, t_q * n_heads,
        hd, torch.cuda.current_stream(acc.device).cuda_stream)
    cuda.check(err, "flash_merge")
    flash_merge.launches += 1
    return (out, out_m, out_l) if raw else out


flash_merge.launches = 0
