"""The chat cell's time to first token: `ttft_p90_ms`'s arithmetic (the
90th percentile over the turns due inside the window of first token - due
time, a failed turn infinite), read in a traced run.  A closed loop's turn
waits for the prefill chunks that its tick runs before it, which the port
dispatches eagerly, so this tail follows the host's speed from run to run;
it stands beside the cell's throughput, which it moves."""

from portbench.readings import ttft_p90_ms as read  # noqa: F401
