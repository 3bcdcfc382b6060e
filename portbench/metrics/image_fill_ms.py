"""The image encoder's job: the median, over the image jobs that ended
inside the window, of the harness's host-clock span around each (host
preprocessing, the CLIP tower, the projector and the rows' prefill, on the
scheduler's thread, synchronised at its end), in ms."""

import statistics


def read(ctx):
    d = [1e3 * (b - a) for name, a, b in ctx.spans
         if name == "image.job" and ctx.w0 <= b < ctx.w1]
    return statistics.median(d) if d else None
