"""Speculative decoding by prompt lookup (self-drafting).

A single-stream decode step is bound by the weights it streams: a T = k+1
forward reads the same weight bytes as a T = 1 step, so verifying k drafted
tokens in one step multiplies the tokens per step by the acceptance rate at
little extra cost.  Drafts come from the token history, not from a second
model: the last bigram is matched against its latest earlier occurrence and
the k tokens that followed it become the draft.

Greedy decoding stays exact as far as a row's logits do not depend on how
many rows ran beside it: every emitted token is an argmax of the logits a
plain step would compute (an accepted draft is the argmax by construction;
the first mismatch emits the argmax in its place).  Cache rows written past
the accepted prefix hold the rejected continuation, but the causal mask
hides every row >= pos until a later step overwrites it.

Sampling (temperature > 0) speculates by rejection sampling against the
point-mass draft (Leviathan et al. 2023): draft token d_i is accepted with
probability p_i(d_i) under the sampler's exact distribution
(`ops.sampling.processed_probs`); the first rejection resamples from p_i
with d_i zeroed, and a fully accepted draft earns a bonus sample from row
k.  Every emitted token is distributed as the plain sampler's.

Counterpart of `lmrs_tpu/runtime/speculative.py`.  `spec_chunk` is its
`make_spec_chunk`: n_steps verify steps of one sequence, the scan written
as a Python loop over device tensors (the position and the output count
stay on the device, the forward takes its position from there), so the
caller reads the chunk's tokens once.  `spec_chunk_batched` is the
batched scheduler's form (the `vmap`ped draft and accept of
`lmrs_tpu/serve/scheduler.py:_spec_chunk_b` with the batch dimension
written out): all slots verify in one forward, and the host reads the
chunk's tokens once at its end.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from lmrs_tpu_torch.config import ModelConfig
from lmrs_tpu_torch.ops.sampling import processed_probs


def lookup_draft(h: torch.Tensor, p: int, k: int, vmax: int) -> torch.Tensor:
    """Prompt-lookup draft: the k tokens after the LATEST earlier occurrence
    of the bigram (h[p-1], h[p]), an occurrence starting at idx < p - 1.

    `h` is the (S,) integer token history, valid through index `p`; unknown
    rows hold -1, which matches no token, and drafts sliced from -1 regions
    are clamped to [0, vmax] before the embedding gather (the verify step
    rejects them).  Without a match the draft starts at index 1.  Runs on
    h's device without a host read; returns (k,) of h's dtype."""
    s_len = h.shape[0]
    n = max(p - 1, 0)                   # candidate starts idx in [0, p - 2]
    if n:
        m = (h[:n] == h[p - 1]) & (h[1:n + 1] == h[p])
        idx = torch.arange(n, device=h.device)
        j = torch.where(m, idx, -1).amax()
    else:
        j = torch.full((), -1, dtype=torch.long, device=h.device)
    start = (j + 2).clamp(0, s_len - k)
    return h[start + torch.arange(k, device=h.device)].clamp(0, vmax)


def first_miss(ok: torch.Tensor) -> torch.Tensor:
    """The number of leading True entries of `ok` (k,), a 0-d long tensor."""
    padded = torch.cat([ok, ok.new_zeros(1)]).to(torch.int8)
    return padded.argmin()      # the first of several minima


def rejection_accept(probs: torch.Tensor, draft: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     uniforms: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Speculative rejection sampling against a point-mass draft.

    probs: (k+1, V) target distributions (row i conditions on the first i
    draft tokens being emitted); draft: (k,) integer proposal.  Returns
    (ok (k,) bool acceptance tests, emitted (k+1,) long): the first
    n_acc = first_miss(ok) entries of `emitted` are accepted drafts and
    entry n_acc is the resample: a rejection draws from row n_acc with the
    draft token zeroed, a full acceptance draws the bonus token from row k.
    The entries past n_acc are the padded draft, for the caller to ignore.

    `uniforms` (k,) in [0, 1) are the acceptance draws; without them they
    come from `generator`, which also feeds the resample."""
    k = draft.shape[0]
    n_vocab = probs.shape[-1]
    dev = probs.device
    draft = draft.long()
    if uniforms is None:
        uniforms = torch.rand(k, device=dev, generator=generator)
    p_d = probs[:k].gather(1, draft[:, None])[:, 0]
    ok = uniforms.to(dev) < p_d
    n_acc = first_miss(ok)
    row = probs.index_select(0, n_acc.reshape(1))[0]
    d_at = draft[n_acc.clamp(0, k - 1)]
    bonus = n_acc == k
    zeroed = (torch.arange(n_vocab, device=dev) == d_at) & ~bonus
    row = torch.where(zeroed, 0.0, row)
    # 1e-30: a row whose whole mass was the zeroed token stays drawable
    repl = torch.multinomial(row + 1e-30, 1, generator=generator)[0]
    pad = torch.cat([draft, draft[-1:]])
    emitted = torch.where(torch.arange(k + 1, device=dev) == n_acc, repl, pad)
    return ok, emitted


def lookup_draft_batched(h: torch.Tensor, p: torch.Tensor, k: int,
                         vmax: int) -> torch.Tensor:
    """`lookup_draft` for every slot at once: h (B, S) histories, p (B,)
    positions on the device -> (B, k) drafts, without a host read."""
    b, s_len = h.shape
    p = p.long()
    idx = torch.arange(s_len - 1, device=h.device)
    a = h.gather(1, (p - 1).clamp(min=0)[:, None])
    c = h.gather(1, p.clamp(max=s_len - 1)[:, None])
    m = (h[:, :-1] == a) & (h[:, 1:] == c) & (idx[None] < (p - 1)[:, None])
    j = torch.where(m, idx[None], -1).amax(dim=1)
    start = (j + 2).clamp(0, s_len - k)
    take = start[:, None] + torch.arange(k, device=h.device)[None]
    return h.gather(1, take).clamp(0, vmax)


def spec_chunk_batched(run: Callable, cfg: ModelConfig, h: torch.Tensor,
                       tokens: torch.Tensor, pos: torch.Tensor, n_steps: int,
                       k: int, temperatures: Sequence[float],
                       top_ps: Sequence[float],
                       generator: Optional[torch.Generator] = None):
    """`n_steps` batched verify steps from tokens (B,) at positions pos (B,)
    (device tensors; h (B, S) is each slot's token history, updated in
    place).  Each step runs ONE forward of t_q = k+1 rows per slot,
    `run(token ids (B*(k+1),), pos, k + 1)` (the scheduler's batched
    forward, on one device or a mesh); greedy
    slots accept their longest draft prefix equal to the argmaxes, slots
    with temperature > 0 accept by rejection sampling against
    `processed_probs` (one `rejection_accept` each).  An all-greedy batch
    never forms a probability, decided on the host from `temperatures`.
    Cache rows past a slot's accepted prefix hold the rejected continuation,
    hidden by the causal mask until overwritten.

    Returns device tensors: out (B, n_steps*(k+1)) of each slot's emitted
    tokens, n_out (B,) how many, and accs (n_steps, B) the accepted drafts
    per step."""
    b = tokens.shape[0]
    dev = tokens.device
    s_len = h.shape[1]
    sampled = [i for i, t in enumerate(temperatures) if t > 0.0]
    ar = torch.arange(k + 1, device=dev)
    toks, p = tokens.long(), pos.clone()
    out = torch.zeros((b, n_steps * (k + 1)), dtype=torch.long, device=dev)
    n_out = torch.zeros((b,), dtype=torch.long, device=dev)
    accs = []
    for _ in range(n_steps):
        draft = lookup_draft_batched(h, p, k, cfg.vocab_size - 1)  # (B, k)
        tin = torch.cat([toks[:, None], draft], dim=1)
        logits = run(tin.reshape(-1), p, k + 1).reshape(b, k + 1, -1)
        emit = torch.argmax(logits, dim=-1)                       # (B, k+1)
        ok = draft == emit[:, :-1]
        for i in sampled:
            probs = processed_probs(logits[i], temperatures[i], top_ps[i])
            ok_i, emit_i = rejection_accept(probs, draft[i], generator)
            ok[i], emit[i] = ok_i, emit_i
        n_acc = torch.cat([ok, ok.new_zeros((b, 1))], 1).to(
            torch.int8).argmin(dim=1)                              # (B,)
        # dead lanes may run past the history's end: their clamped writes
        # are never read
        h.scatter_(1, (p.long()[:, None] + 1 + ar).clamp(max=s_len - 1),
                   emit.to(h.dtype))
        out.scatter_(1, n_out[:, None] + ar, emit)
        toks = emit.gather(1, n_acc[:, None])[:, 0]
        p = p + (n_acc + 1).to(p.dtype)
        n_out = n_out + n_acc + 1
        accs.append(n_acc)
    return out, n_out, torch.stack(accs)


def spec_chunk(run: Callable, cfg: ModelConfig, h: torch.Tensor, pos: int,
               n_steps: int, k: int, temperature: float, top_p: float,
               generator: Optional[torch.Generator] = None):
    """`n_steps` lookup -> verify -> accept steps of one sequence from
    position `pos` (cache rows < pos valid, h[pos] the known token not
    cached yet): the JAX `make_spec_chunk` body with its scan written as a
    Python loop.  The position p and the output count are carried on the
    device.  Each step drafts k tokens from the history
    (`lookup_draft_batched` on the device position), runs ONE T = k+1
    forward over [h[p], draft], `run(tokens, p, "all", pos_range)` (the
    engine's or a rank's forward with a device position and its host
    bounds), and accepts by argmax equality at temperature 0 or by
    `rejection_accept` otherwise.  As the JAX body writes them, all k+1
    emitted tokens go to h[p+1 : p+k+2] (in place; the history past the
    new position is never read as a match, only as a draft) and to the out
    buffer at n_out.

    Returns device tensors (out_buf (n_steps*(k+1),) long, n_out 0-d,
    accs (n_steps,) the accepted drafts per step, new_pos (1,) int32);
    nothing is read on the host.  The caller needs pos + n_steps*(k+1) + 1
    <= len(h) = seq_len."""
    dev = h.device
    vmax = cfg.vocab_size - 1
    p = torch.full((1,), pos, dtype=torch.int32, device=dev)
    bounds = (pos, pos + (n_steps - 1) * (k + 1))
    ar = torch.arange(k + 1, device=dev)
    out = torch.zeros(n_steps * (k + 1), dtype=torch.long, device=dev)
    n_out = torch.zeros(1, dtype=torch.long, device=dev)
    accs = []
    for _ in range(n_steps):
        draft = lookup_draft_batched(h[None], p, k, vmax)[0]
        tin = torch.cat([h[p.long()], draft])
        logits = run(tin, p, "all", bounds)
        if temperature == 0.0:
            emitted = torch.argmax(logits, dim=-1)
            ok = draft == emitted[:-1]
        else:
            probs = processed_probs(logits, temperature, top_p)
            ok, emitted = rejection_accept(probs, draft, generator)
        n_acc = first_miss(ok)
        h[p.long() + 1 + ar] = emitted.to(h.dtype)
        out[n_out + ar] = emitted
        p = p + (n_acc + 1).to(p.dtype)
        n_out = n_out + n_acc + 1
        accs.append(n_acc)
    return out, n_out[0], torch.stack(accs), p
