"""Process-local metrics: counters, gauges, fixed-bucket histograms.

A :class:`MetricsRegistry` holds labeled series — each series is keyed
by ``(name, sorted(labels))`` so ``terminal_total{state="completed"}``
and ``terminal_total{state="expired"}`` are independent counters under
one logical name.  Everything is stdlib-only and mergeable: histograms
use *fixed* bucket edges (``value <= edge``, Prometheus ``le``
semantics) so two registries from different runs can be summed
bucket-by-bucket without rebinning.

Exports: :meth:`MetricsRegistry.to_dict` (JSON-friendly) and
:meth:`MetricsRegistry.to_prometheus` (text exposition format, the
cumulative-``le`` flavor).  A copy of ``repro.obs.metrics``: the port
imports nothing of ``repro``.
"""

from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_MS_BUCKETS"]

# Latency-ish default edges (ms), wide enough for CPU and GPU rounds.
DEFAULT_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0)


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n

    def to_dict(self) -> dict:
        return {"type": "counter", "value": self.value}

    def merge(self, other: "Counter") -> None:
        self.value += other.value


class Gauge:
    """Point-in-time value (queue depth, slot occupancy)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n

    def to_dict(self) -> dict:
        return {"type": "gauge", "value": self.value}

    def merge(self, other: "Gauge") -> None:
        # Last-writer-wins has no meaning across runs; keep the max so a
        # merged report still answers "how deep did the queue ever get".
        self.value = max(self.value, other.value)


class Histogram:
    """Fixed-bucket histogram with ``value <= edge`` (le) semantics.

    ``counts[i]`` is the number of observations with
    ``value <= buckets[i]`` and ``> buckets[i-1]``; ``overflow`` counts
    observations above the last edge (Prometheus ``+Inf`` bucket).
    Fixed edges make two histograms mergeable by elementwise sum.
    """

    __slots__ = ("buckets", "counts", "overflow", "total", "sum",
                 "min", "max")

    def __init__(self, buckets=DEFAULT_MS_BUCKETS):
        edges = tuple(float(b) for b in buckets)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(f"bucket edges must be sorted/unique: {buckets}")
        self.buckets = edges
        self.counts = [0] * len(edges)
        self.overflow = 0
        self.total = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def observe(self, v: float) -> None:
        self.total += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                self.counts[i] += 1
                return
        self.overflow += 1

    def quantile(self, q: float) -> float | None:
        """Estimate the q-quantile from bucket edges (upper-edge bias).

        Returns the smallest bucket edge whose cumulative count covers
        rank ``ceil(q * total)``; ``max`` for observations beyond the
        last edge; ``None`` when empty.  Coarse by construction — the
        engine keeps exact samples where precision matters (slack
        estimation) and uses this for reporting.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0,1], got {q}")
        if self.total == 0:
            return None
        rank = max(1, int(q * self.total + 0.9999999))
        cum = 0
        for i, edge in enumerate(self.buckets):
            cum += self.counts[i]
            if cum >= rank:
                return edge
        return self.max

    def to_dict(self) -> dict:
        return {"type": "histogram", "buckets": list(self.buckets),
                "counts": list(self.counts), "overflow": self.overflow,
                "count": self.total, "sum": self.sum,
                "min": self.min, "max": self.max}

    def merge(self, other: "Histogram") -> None:
        if other.buckets != self.buckets:
            raise ValueError("cannot merge histograms with different edges")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.overflow += other.overflow
        self.total += other.total
        self.sum += other.sum
        if other.min is not None:
            self.min = other.min if self.min is None \
                else min(self.min, other.min)
        if other.max is not None:
            self.max = other.max if self.max is None \
                else max(self.max, other.max)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class MetricsRegistry:
    """Labeled series of counters/gauges/histograms, one per process
    component (each engine owns its own registry, so ledger/counter
    cross-checks compare like with like)."""

    def __init__(self):
        self._series: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, labels: dict, factory):
        key = (name, _label_key(labels))
        inst = self._series.get(key)
        if inst is None:
            with self._lock:
                inst = self._series.get(key)
                if inst is None:
                    inst = factory()
                    self._series[key] = inst
        return inst

    def counter(self, name: str, **labels) -> Counter:
        c = self._get(name, labels, Counter)
        if not isinstance(c, Counter):
            raise TypeError(f"{name} already registered as {type(c).__name__}")
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        g = self._get(name, labels, Gauge)
        if not isinstance(g, Gauge):
            raise TypeError(f"{name} already registered as {type(g).__name__}")
        return g

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        h = self._get(name, labels,
                      lambda: Histogram(buckets or DEFAULT_MS_BUCKETS))
        if not isinstance(h, Histogram):
            raise TypeError(f"{name} already registered as {type(h).__name__}")
        return h

    def value(self, name: str, **labels):
        """Current value of a counter/gauge series; 0 if never touched.

        The chaos cross-check reads counters it *expects* to exist; a
        scenario where nothing was shed must read ``shed_total == 0``
        without creating noise in the export, hence no registration.
        """
        inst = self._series.get((name, _label_key(labels)))
        if inst is None:
            return 0
        return inst.value

    def series(self) -> list[tuple[str, dict, object]]:
        """Snapshot: (name, labels-dict, instrument) sorted by name."""
        with self._lock:
            items = list(self._series.items())
        return sorted(((name, dict(lk), inst) for (name, lk), inst in items),
                      key=lambda t: (t[0], sorted(t[1].items())))

    def merge(self, other: "MetricsRegistry") -> None:
        for name, labels, inst in other.series():
            key = (name, _label_key(labels))
            mine = self._series.get(key)
            if mine is None:
                # Deep-copy via to_dict-free path: new instrument, merge in.
                if isinstance(inst, Counter):
                    mine = Counter()
                elif isinstance(inst, Gauge):
                    mine = Gauge()
                else:
                    mine = Histogram(inst.buckets)
                self._series[key] = mine
            mine.merge(inst)

    # -- export -------------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-friendly: {"metrics": [{name, labels, ...instrument}]}."""
        out = []
        for name, labels, inst in self.series():
            rec = {"name": name, "labels": labels}
            rec.update(inst.to_dict())
            out.append(rec)
        return {"metrics": out}

    def to_prometheus(self) -> str:
        """Prometheus text exposition (cumulative ``le`` histograms)."""
        lines = []
        typed: set[str] = set()
        for name, labels, inst in self.series():
            kind = ("counter" if isinstance(inst, Counter)
                    else "gauge" if isinstance(inst, Gauge) else "histogram")
            if name not in typed:
                lines.append(f"# TYPE {name} {kind}")
                typed.add(name)
            lbl = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
            if isinstance(inst, Histogram):
                cum = 0
                for edge, cnt in zip(inst.buckets, inst.counts):
                    cum += cnt
                    le = f'le="{edge:g}"'
                    inner = f"{lbl},{le}" if lbl else le
                    lines.append(f"{name}_bucket{{{inner}}} {cum}")
                inner = f'{lbl},le="+Inf"' if lbl else 'le="+Inf"'
                lines.append(f"{name}_bucket{{{inner}}} {inst.total}")
                suffix = f"{{{lbl}}}" if lbl else ""
                lines.append(f"{name}_sum{suffix} {inst.sum:g}")
                lines.append(f"{name}_count{suffix} {inst.total}")
            else:
                suffix = f"{{{lbl}}}" if lbl else ""
                lines.append(f"{name}{suffix} {inst.value:g}")
        return "\n".join(lines) + "\n"
