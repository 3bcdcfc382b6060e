"""Kernels J and M on the decode steps of the traced stretch: the least
time of what their inputs need (the architecture's `attention_cost`:
for phi3 each KV row read once a step, shared prefix pages once, at
head_dim 96; q in, the output out) over their device time (each call from
the split pass's start to its merge's end), in %."""

from portbench import roofline as R
from portbench.readings import decode_attention_span_s, traced


def read(ctx):
    if not traced(ctx, "decode"):
        return None
    span = decode_attention_span_s(ctx)
    if span <= 0:
        return None
    arch, counts = ctx.arch, ctx.arch_counts()
    least = 0.0
    for f in ctx.recorder.forwards:
        if f["kind"] == "decode" and f["rows"]:
            c = arch.attention_cost(ctx.cfg, ctx.conf, f, counts)
            least += R.bound_s(c["bytes"], c["ops_bf16"], c["ops_int8"],
                               ctx.peak())
    return 100.0 * least / span
