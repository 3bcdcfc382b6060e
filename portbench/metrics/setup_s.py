"""Set-up: from the process's start to the window's opening (imports,
weights made on the card, the kernels loaded or built, warm-up, the
traffic's ramp)."""


def read(ctx):
    return ctx.setup_s
