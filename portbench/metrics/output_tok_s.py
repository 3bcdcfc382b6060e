"""Output tokens delivered inside the window, over the window's seconds
(host clock; every turn's tokens, whenever it was sent)."""


def read(ctx):
    n = sum(sum(1 for t in r.times if ctx.w0 <= t < ctx.w1)
            for r in ctx.recs)
    return n / ctx.window_s
