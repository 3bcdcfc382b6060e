"""90th percentile, over the turns due inside the window, of (first token's
delivery - the turn's due time), in ms (host clock); a turn that failed or
never had a first token counts as infinite."""

from portbench.readings import ttft_p90_ms as read  # noqa: F401
