"""The output check that decides `correct`.

After the window, a sample drawn from the seed of the greedy turns that
finished inside it, the longest among them: the plain reference
(`reference/<model_type>.py`) runs once over each turn's whole sequence
(its conversation's cached tokens, its prompt, its served tokens) and
reads, at each row that produced a served token, how far that token's
logit lies below the reference's best.  Two numbers are compared with the
configuration's limits (`check.max_gap`, `check.max_mean_gap`, with the
readings each was set from): the widest gap, and, where the configuration
gives it a limit, the mean gap over the served tokens.  An error of the
served logits r times larger flips about r times as many near-ties by
gaps about r times larger, so the mean grows as r squared where the
widest grows as r: the mean is the number that tells a cache rounded to
int8 from a bf16 one.  The sample has to hold `check.min_tokens` served
tokens.
"""

from __future__ import annotations

import importlib
import random
from typing import Dict, List, Optional


def sample(recs, w0: float, w1: float, seed: int, tokens: int,
           most: int) -> List:
    """Greedy turns finished inside the window with every token served and
    their conversation intact: the one with the most served tokens, then
    others drawn from the seed until `tokens` served tokens or `most`
    turns."""
    ok = [r for r in recs
          if r.spec.greedy and r.done is not None and w0 <= r.done < w1
          and r.error is None and r.session_ok and len(r.out) >= 2]
    if not ok:
        return []
    ok.sort(key=lambda r: (-len(r.out), r.spec.client, r.spec.index))
    picked, rest = [ok[0]], ok[1:]
    random.Random(seed).shuffle(rest)
    n = len(ok[0].out)
    for r in rest:
        if n >= tokens or len(picked) >= most:
            break
        picked.append(r)
        n += len(r.out)
    return picked


def reference(conf: dict, weights, **kw):
    mod = importlib.import_module(f"portbench.reference.{conf['model_type']}")
    return mod.MODEL(conf, weights, **kw), mod


def gaps(conf: dict, weights, picked, device, **kw) -> List[float]:
    """Every served token's gap below the reference's best, over the
    sample."""
    model, mod = reference(conf, weights, **kw)
    out: List[float] = []
    for r in picked:
        g = mod.served_gaps(model, r.context, r.spec.prompt, r.out, device)
        out += g.tolist()
    return out


def verdict(conf: dict, served: List[float]) -> Dict[str, dict]:
    """The numbers compared, each with its limit; `ok` on each."""
    lim = conf.get("check", {})
    least = lim.get("min_tokens", 1)
    widest = max(served) if served else float("inf")
    max_gap: Optional[float] = lim.get("max_gap")
    out = {
        "served_tokens": {"value": len(served), "limit": least,
                          "ok": len(served) >= least,
                          "rule": "at least"},
        "widest_gap": {"value": widest, "limit": max_gap,
                       "ok": max_gap is not None and widest <= max_gap,
                       "rule": "at most"},
    }
    if "max_mean_gap" in lim:
        # a configuration whose readings give this number no upper end
        # leaves the key out: it is then not compared
        max_mean: Optional[float] = lim["max_mean_gap"]
        mean = sum(served) / len(served) if served else float("inf")
        out["mean_gap"] = {"value": mean, "limit": max_mean,
                           "ok": max_mean is not None and mean <= max_mean,
                           "rule": "at most"}
    return out
