"""The image cell's time to first token: `ttft_p90_ms`'s arithmetic (the
90th percentile over the turns due inside the window of first token - due
time, a failed turn infinite), read in a traced run.  A tail of a closed
loop whose turns queue behind image jobs, reported beside the cell's
throughput."""

from portbench.readings import ttft_p90_ms as read  # noqa: F401
