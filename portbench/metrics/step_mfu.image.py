"""The model step's share of the card's peak over the traced stretch,
image encodes included: the summed least time of its decode steps, prefill
chunks, image-row chunks and image encodes (the architecture's
`forward_cost`, `roofline.image_cost`) over the stretch's seconds, in %."""

from portbench.readings import least_time_s, traced


def read(ctx):
    if not traced(ctx, "decode"):
        return None
    kinds = ("decode", "prefill", "embeds", "image")
    return 100.0 * least_time_s(ctx, kinds) / ctx.trace.window_s
