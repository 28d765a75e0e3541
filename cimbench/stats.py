"""Exact order statistics and rates over a measured window."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-quantile (0 <= q <= 1) of all ``values``, exact: linear
    interpolation between the two order statistics around rank
    ``q (n - 1)`` (numpy's default), over every sample, no buckets."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no samples")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values) -> float:
    return percentile(values, 0.5)


class Window:
    """The host clock's readings of every call in a measured window: its
    start, its return (before the synchronise) and its end (after it),
    in seconds, and the units of work (streams, samples) each call
    completes."""

    def __init__(self, units_per_call: int):
        self.units_per_call = units_per_call
        self.starts: list[float] = []
        self.returns: list[float] = []
        self.ends: list[float] = []

    def add(self, start: float, returned: float, end: float) -> None:
        self.starts.append(start)
        self.returns.append(returned)
        self.ends.append(end)

    @property
    def calls(self) -> int:
        return len(self.ends)

    @property
    def seconds(self) -> float:
        """From the first call's start to the last call's end: stalls
        between calls count."""
        return self.ends[-1] - self.starts[0]

    def units_per_s(self) -> float:
        """All the work completed in the window over its seconds."""
        return self.calls * self.units_per_call / self.seconds

    def call_ms(self) -> list[float]:
        """Each call from its start to its synchronised result."""
        return [1e3 * (e - s) for s, e in zip(self.starts, self.ends)]

    def host_ms(self) -> list[float]:
        """Each call from its start to its return, before the
        synchronise."""
        return [1e3 * (r - s) for s, r in zip(self.starts, self.returns)]
