"""The device's idle share of the traced stretch: 1 - (union of its
operations' intervals) / (the stretch's host-clock seconds), in %."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
