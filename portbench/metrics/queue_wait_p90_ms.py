"""The wait for a slot: the 90th percentile, over the requests staged into
a slot inside the unprofiled part of the traced window, of the port's
`admit_time - submit_time`, in ms (a wait for free lanes or, paged, for
free pages)."""

from portbench import spans as S
from portbench.readings import p90


def read(ctx):
    w = S.window(ctx)
    if w is None:
        return None
    waits = [1e3 * (r.admit_time - r.submit_time) for r in w.requests
             if w.inside(getattr(r, "admit_time", None))]
    return p90(waits)
