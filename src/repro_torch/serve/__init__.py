"""Serving: the continuous-batching event-stream engine."""
