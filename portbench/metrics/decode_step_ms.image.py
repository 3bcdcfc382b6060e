"""The image cell's scheduler time a decode step: `decode_step_ms`'s
arithmetic (the port's `decode_seconds` over its `decode_steps`, over the
window), in ms; split from it because this cell reports output_tok_s and
not tpot_p90_ms."""

from portbench.readings import decode_step_ms as read  # noqa: F401
