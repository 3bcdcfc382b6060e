"""The one traffic generator: a mix file's parameters and a seed -> each
client's turns, in order.

A mix (`traffic/<name>.json`) says:
- `loop`: "closed" (each client sends its next turn when the reply before
  it completes) or "open" (each client is one session; sessions arrive at
  `sessions_per_s`, one in each 1 / rate interval at a uniform place in
  it, and the window opens `ramp_seconds` after the load starts; the
  turns inside a session are closed);
- `clients`, `batch` (the server's slots), `rounds` (turns drawn per
  client: more than a run consumes);
- `shared_prefix` (optional): `count` documents of `tokens` [lo, hi],
  drawn by rank with Zipf(`zipf_s`) popularity; each turn's prompt is a
  document, then its own `prompt_tokens`;
- `session` (optional): `lease` (a conversation that keeps its cache
  across turns), `history_tokens` (the first conversation's history,
  sent as its first turn), `later_history_tokens` (each later
  conversation's, sent before its first turn's own tokens), `turns`
  (closed loop, optional: a conversation ends after this many turns, and
  client c's first one after `turns - c % turns`, so that the clients'
  conversations start in staggered rounds); a conversation also ends
  where its next turn would pass the context;
- `image` (optional): the first turn of a conversation carries an image
  of `long_side` [lo, hi] pixels at one of `aspects` (height : width),
  which takes `rows` rows of the context;
- `prompt_tokens`, `output_tokens` [lo, hi]: each turn's own prompt and
  its reply (a fixed `max_new_tokens`; no stop tokens);
- `greedy_share`: the share of turns decoded greedily (the rest sample at
  the server's temperature and top-p), which the output check reads.

What the seed changes is the order, not the mix: in each round (the r-th
turn of every client) the lengths are the same stratified quantiles of
their ranges, the documents are drawn in the same counts, and the same
number of turns are greedy; the seed permutes them over the clients,
jitters each value inside its stratum and draws the token ids.  In a
closed loop the first reply of every client is drawn from the equilibrium
distribution of a reply's remaining length, so that the replies in flight
when the window opens end at spread times, as in a loop that has run for
long.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TurnSpec:
    client: int
    index: int                  # the turn's place in its client's list
    prompt: List[int]
    max_new: int
    greedy: bool
    new_session: bool           # the first turn of a conversation
    doc: int = -1               # the shared document, if any
    image: Optional[Tuple[int, int, int]] = None   # (height, width, seed)


@dataclasses.dataclass
class Script:
    clients: List[List[TurnSpec]]
    arrivals: Optional[List[float]] = None   # open loop: session start times


def _rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), salt])


def stratified(rng: np.random.Generator, n: int, lo: int, hi: int,
               cdf_inv=None) -> np.ndarray:
    """n integers: one from each of n equal strata of [lo, hi] (of the
    distribution whose inverse CDF on [0, 1) is `cdf_inv`, uniform by
    default), jittered inside their stratum, in a random order."""
    u = (np.arange(n) + rng.random(n)) / n
    if cdf_inv is not None:
        v = cdf_inv(u)
    else:
        v = lo + u * (hi + 1 - lo)
    v = np.clip(np.floor(v), lo, hi).astype(np.int64)
    return rng.permutation(v)


def residual_inv(lo: int, hi: int, floor: int = 2):
    """Inverse CDF of the remaining length of a reply in flight, for
    replies uniform on [lo, hi]: density P(L > x) / E[L] on [0, hi]."""
    x = np.arange(0, hi + 1, dtype=np.float64)
    surv = np.where(x < lo, 1.0, (hi + 1 - x) / (hi + 1 - lo))
    cdf = np.cumsum(surv)
    cdf /= cdf[-1]

    def inv(u):
        return np.maximum(np.searchsorted(cdf, u), floor).astype(np.float64)

    return inv


def zipf_counts(n: int, count: int, s: float) -> np.ndarray:
    """How many of n draws fall on each of `count` ranks under Zipf(s):
    the expected counts, rounded by largest remainder."""
    p = 1.0 / np.arange(1, count + 1) ** s
    p /= p.sum()
    exp = n * p
    c = np.floor(exp).astype(np.int64)
    rest = n - c.sum()
    c[np.argsort(-(exp - c), kind="stable")[:rest]] += 1
    return c


def _doc_lengths(count: int, lo: int, hi: int) -> np.ndarray:
    """Fixed document lengths (no seed): the strata midpoints of [lo, hi],
    assigned to popularity ranks in a fixed interleaved order, so that
    every seed has the same documents with the same popularity."""
    mids = lo + (np.arange(count) + 0.5) / count * (hi - lo)
    order = np.argsort([int(f"{i:08b}"[::-1], 2) for i in range(count)],
                       kind="stable")
    return np.floor(mids[order]).astype(np.int64)


def make_script(mix: dict, seed: int, vocab: int, max_context: int,
                decode_chunk: int) -> Script:
    n = mix["clients"]
    rounds = mix["rounds"]
    rng = _rng(seed, 1)
    tok = lambda k: rng.integers(0, vocab, k).tolist()  # noqa: E731
    plo, phi = mix["prompt_tokens"]
    olo, ohi = mix["output_tokens"]
    n_greedy = int(round(mix["greedy_share"] * n))

    docs, doc_of = None, None
    if "shared_prefix" in mix:
        sp = mix["shared_prefix"]
        lens = _doc_lengths(sp["count"], *sp["tokens"])
        docs = [tok(int(k)) for k in lens]
        counts = zipf_counts(n, sp["count"], sp["zipf_s"])
        doc_of = [rng.permutation(np.repeat(np.arange(sp["count"]), counts))
                  for _ in range(rounds)]
    sess = mix.get("session", {})
    lease = bool(sess.get("lease"))
    image = mix.get("image")
    closed = mix["loop"] == "closed"
    per_conv = int(sess.get("turns", 0)) if closed else 0

    prompts = [stratified(rng, n, plo, phi) for _ in range(rounds)]
    outs = [stratified(rng, n, olo, ohi,
                       residual_inv(olo, ohi) if closed else None)]
    outs += [stratified(rng, n, olo, ohi) for _ in range(rounds - 1)]
    greedy = [rng.permutation(np.arange(n) < n_greedy) for _ in range(rounds)]
    hist0 = (stratified(rng, n, *sess["history_tokens"])
             if "history_tokens" in sess else None)
    later = ([stratified(rng, n, *sess["later_history_tokens"])
              for _ in range(rounds)]
             if "later_history_tokens" in sess else None)
    if image is not None:
        sides = [stratified(rng, n, *image["long_side"])
                 for _ in range(rounds)]
        aspects = [rng.permutation(np.arange(n) % len(image["aspects"]))
                   for _ in range(rounds)]

    clients = []
    for c in range(n):
        turns, ctx, n_sess = [], 0, 0
        for r in range(rounds):
            prompt: List[int] = []
            new = r == 0
            if lease and r == 0 and hist0 is not None:
                prompt = tok(int(hist0[c]))           # the history turn
            else:
                own = int(prompts[r][c])
                need = ctx + own + int(outs[r][c]) + decode_chunk + 1
                if lease and (r == 0 or need > max_context):
                    new = True
                if per_conv and (r + c % per_conv) % per_conv == 0:
                    new = True
                if new and later is not None:
                    prompt = tok(int(later[r][c]))
                prompt += tok(own)
            doc = -1
            if docs is not None:
                doc = int(doc_of[r][c])
                prompt = docs[doc] + prompt
            max_new = int(outs[r][c])
            if new:
                ctx, n_sess = 0, n_sess + 1
                if image is not None:
                    ctx = image["rows"]     # the image's rows come first
            # a reply's last token is never cached: the next turn starts
            # where it would have gone
            room = max_context - ctx - len(prompt) - decode_chunk - 1
            max_new = max(2, min(max_new, room))
            img = None
            if image is not None and new:
                h_w = image["aspects"][int(aspects[r][c])]
                side = int(sides[r][c])
                hh, ww = ((side, side * h_w[1] // h_w[0]) if h_w[0] >= h_w[1]
                          else (side * h_w[0] // h_w[1], side))
                img = (hh, ww, int(rng.integers(0, 1 << 31)))
            turns.append(TurnSpec(client=c, index=r, prompt=prompt,
                                  max_new=max_new, greedy=bool(greedy[r][c]),
                                  new_session=new, doc=doc, image=img))
            ctx = ctx + len(prompt) + max_new - 1 if lease else 0
        clients.append(turns)

    arrivals = None
    if not closed:
        # one session in each 1 / rate interval, at a uniform place in it:
        # the rate of a Poisson process without its bursts, whose TTFT and
        # TPOT tails swing with the seed's bursts far beyond any bound a
        # 51-s window can hold (PERF.md)
        u = _rng(seed, 2).random(n)
        arrivals = ((np.arange(n) + u) / mix["sessions_per_s"]).tolist()
    return Script(clients=clients, arrivals=arrivals)
