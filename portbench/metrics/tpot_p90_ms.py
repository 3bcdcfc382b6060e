"""90th percentile, over the turns completed inside the window, of (last
token - first token) / (tokens - 1), in ms (host clock); a turn that
failed counts as infinite."""

from portbench.readings import tpot_p90_ms as read  # noqa: F401
