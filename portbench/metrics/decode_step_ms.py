"""The scheduler's time a decode step: the port's `decode_seconds` (host
clock around each decode chunk, its one read included) over its
`decode_steps`, both over the window, in ms."""

from portbench.readings import decode_step_ms as read  # noqa: F401
