"""Serving: the continuous-batching scheduler and the WebSocket backend."""
