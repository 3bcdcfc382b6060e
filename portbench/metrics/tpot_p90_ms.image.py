"""The image cell's time per output token: `tpot_p90_ms`'s arithmetic (the
90th percentile over the turns completed inside the window, a failed turn
infinite), read in a traced run; each image job stalls every stream."""

from portbench.readings import tpot_p90_ms as read  # noqa: F401
