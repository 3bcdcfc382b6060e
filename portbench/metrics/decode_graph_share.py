"""The decode steps that replayed the port's CUDA graph: over the
unprofiled part of the traced window, the `n` of the port's
`sched.decode.graph` spans (a chunk's replays) over the `n` of its
`sched.decode.launch` spans (the chunk's steps), in %.  None from a
program that records no such span."""

from portbench import spans as S


def read(ctx):
    w = S.window(ctx)
    if w is None:
        return None
    graph = w.named("sched.decode.graph")
    steps = sum(r[S.N] for r in w.named("sched.decode.launch"))
    if not graph or steps <= 0:
        return None
    return 100.0 * sum(r[S.N] for r in graph) / steps
