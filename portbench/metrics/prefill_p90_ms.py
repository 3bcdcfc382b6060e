"""The prefill of a turn: the 90th percentile, over the requests whose
first token was sampled inside the unprofiled part of the traced window,
of the port's `first_time - admit_time` (staged into a slot to the first
token read on the host: prefix fork, prefill chunks at one a tick, the
first token's sampling), in ms."""

from portbench import spans as S
from portbench.readings import p90


def read(ctx):
    w = S.window(ctx)
    if w is None:
        return None
    fills = [1e3 * (r.first_time - r.admit_time) for r in w.requests
             if w.inside(getattr(r, "first_time", None))
             and r.admit_time is not None]
    return p90(fills)
