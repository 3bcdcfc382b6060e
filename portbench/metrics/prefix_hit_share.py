"""The scheduler's admission prefix cache: prompt tokens it forked from a
resident slot (the port's `prefix_tokens_saved`) over the prompt tokens of
the requests admitted (counted around each admission, traced runs only),
both over the window, in %."""


def read(ctx):
    admitted = ctx.delta("admitted_prompt_tokens")
    if ctx.recorder is None or admitted <= 0:
        return None
    return 100.0 * ctx.delta("prefix_tokens_saved") / admitted
