"""The host's launch of a decode step: the port's `sched.decode.launch`
spans (a decode chunk's uploads, forwards and samplings, up to its one
host read) summed over the unprofiled part of the traced window, over the
steps they launched, in ms.  Beside `decode_step_ms` (the whole chunk, its
read included) it splits a step into launch and wait on the device; a
launch that blocks on a full CUDA launch queue counts as launch."""

from portbench import spans as S


def read(ctx):
    w = S.window(ctx)
    if w is None:
        return None
    launches = w.named("sched.decode.launch")
    steps = sum(r[S.N] for r in launches)
    if steps <= 0:
        return None
    return 1e3 * sum(S.seconds(r) for r in launches) / steps
