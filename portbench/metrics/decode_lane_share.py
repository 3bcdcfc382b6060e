"""The decode steps' lanes that carried a request: over the port's
`sched.decode` spans of the unprofiled part of the traced window, the sum
of lanes holding a request x steps (the chunk's `sched.decode.launch`)
over steps x the batch, in %."""

from portbench import spans as S


def read(ctx):
    w = S.window(ctx)
    if w is None:
        return None
    lanes = steps = 0
    launch = None
    for r in w.records:                 # a child ends before its parent
        if r[S.NAME] == "sched.decode.launch":
            launch = r
        elif r[S.NAME] == "sched.decode" and launch is not None \
                and r[S.T0] <= launch[S.T0] and launch[S.T1] <= r[S.T1]:
            lanes += r[S.N] * launch[S.N]
            steps += launch[S.N]
    if steps <= 0:
        return None
    return 100.0 * lanes / (steps * w.batch)
