"""The model step's share of the card's peak over the traced stretch: the
summed least time of its forwards (decode steps and prefill chunks, each
costed by its architecture's `forward_cost`, `arch/<model_type>.py`; max of
bytes / bandwidth and operations / peak) over the stretch's seconds, in %."""

from portbench.readings import least_time_s, traced


def read(ctx):
    if not traced(ctx, "decode"):
        return None
    return 100.0 * least_time_s(ctx, ("decode", "prefill")) \
        / ctx.trace.window_s
