"""Lightweight span tracer with a Chrome/Perfetto ``trace_event`` exporter.

Design constraints, in priority order:

1. **Zero-cost when disabled.**  The serving engine calls into the
   tracer on every tick phase and every slot transition, so the disabled
   path allocates nothing.  ``span()`` on a disabled tracer
   returns a module-level singleton null context manager; ``begin()``
   returns ``None`` and ``end(None)`` is a single attribute check.
2. **Monotonic clocks.**  All timestamps come from
   ``time.perf_counter_ns()``; wall-clock never enters span math, so
   traces are immune to NTP steps.  Export normalizes to microseconds
   relative to the first recorded event (Perfetto renders absolute
   epoch offsets poorly).
3. **Thread-safe ring buffer.**  Completed spans land in a
   ``collections.deque(maxlen=capacity)`` under a lock — a long chaos
   run keeps the newest ``capacity`` spans instead of growing without
   bound.  Open span handles live on the caller's stack, not in shared
   state, so ``begin``/``end`` pairs may cross threads.

Tracks map to Perfetto threads: every distinct ``track`` string gets a
stable tid (insertion order) and a ``thread_name`` metadata event, so
the UI shows one named lane per slot / scheduler / transfer stream.

A copy of ``repro.obs.trace`` without the optional JAX profiler
passthrough: the port imports nothing of ``repro`` or JAX.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

__all__ = ["Tracer", "get_tracer", "set_tracer"]

_PID = 1  # single-process tool; Perfetto wants *a* pid, any constant works


class _NullSpan:
    """Shared no-op context manager returned by a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """An open span handle: ``with tracer.span(...)`` or begin/end."""

    __slots__ = ("tracer", "name", "track", "args", "t0_ns")

    def __init__(self, tracer, name, track, args):
        self.tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self.t0_ns = time.perf_counter_ns()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.tracer.end(self)
        return False


class Tracer:
    """Span recorder with a bounded buffer and a Perfetto JSON exporter.

    Parameters
    ----------
    enabled:
        When ``False`` every call is a no-op returning shared
        singletons; flip on via ``tracer.enabled = True`` at any time.
    capacity:
        Ring-buffer size in completed spans; the oldest spans are
        dropped first.
    """

    def __init__(self, enabled: bool = True, capacity: int = 65536):
        self.enabled = enabled
        self._events = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tracks: dict[str, int] = {}
        self._dropped = 0

    # -- recording ----------------------------------------------------

    def span(self, name: str, track: str | None = None, args=None):
        """Context manager covering a span; null singleton when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, track, args)

    def begin(self, name: str, track: str | None = None, args=None):
        """Explicit-API start: returns a handle for :meth:`end`.

        Returns ``None`` when disabled; ``end(None)`` is a no-op, so
        call sites never need their own enabled check.
        """
        if not self.enabled:
            return None
        return _Span(self, name, track, args)

    def end(self, handle, args=None) -> None:
        """Close a span handle; merges ``args`` into the span's args."""
        if handle is None or handle is _NULL_SPAN:
            return
        dur_ns = time.perf_counter_ns() - handle.t0_ns
        if args:
            merged = dict(handle.args) if handle.args else {}
            merged.update(args)
            handle.args = merged
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append(
                (handle.name, handle.track, handle.t0_ns, dur_ns,
                 handle.args))

    def instant(self, name: str, track: str | None = None, args=None) -> None:
        """Record a zero-duration marker event."""
        if not self.enabled:
            return
        now = time.perf_counter_ns()
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped += 1
            self._events.append((name, track, now, 0, args))

    # -- inspection / export ------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def dropped(self) -> int:
        """Spans evicted from the ring buffer since construction."""
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def spans(self) -> list[tuple]:
        """Snapshot of recorded spans as (name, track, t0_ns, dur_ns, args)."""
        with self._lock:
            return list(self._events)

    def _tid(self, track: str | None) -> int:
        # tid 0 is the default lane; named tracks get 1..N in first-seen
        # order so Perfetto's lane ordering matches program structure.
        if track is None:
            return 0
        tid = self._tracks.get(track)
        if tid is None:
            tid = len(self._tracks) + 1
            self._tracks[track] = tid
        return tid

    def to_chrome_trace(self) -> dict:
        """Render the buffer as a Chrome/Perfetto trace_event document.

        Complete ("X") events carry ``ts``/``dur`` in microseconds
        relative to the earliest recorded span; metadata ("M") events
        name the process and one thread per track.  The result loads
        directly in ui.perfetto.dev or chrome://tracing.
        """
        events = self.spans()
        t_base = min((e[2] for e in events), default=0)
        trace = []
        for name, track, t0_ns, dur_ns, args in events:
            ev = {
                "name": name,
                "cat": track or "default",
                "ph": "X",
                "ts": (t0_ns - t_base) / 1e3,
                "dur": dur_ns / 1e3,
                "pid": _PID,
                "tid": self._tid(track),
            }
            if args:
                ev["args"] = args
            trace.append(ev)
        meta = [{
            "name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
            "ts": 0, "args": {"name": "repro_torch"},
        }, {
            "name": "thread_name", "ph": "M", "pid": _PID, "tid": 0,
            "ts": 0, "args": {"name": "main"},
        }]
        for track, tid in sorted(self._tracks.items(), key=lambda kv: kv[1]):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
                "ts": 0, "args": {"name": track},
            })
        return {"traceEvents": meta + trace, "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write the Perfetto JSON document to ``path``; returns span count."""
        doc = self.to_chrome_trace()
        with open(path, "w") as f:
            json.dump(doc, f)
        return sum(1 for e in doc["traceEvents"] if e["ph"] == "X")


# -- module-global tracer ---------------------------------------------
#
# Library code (models/snn.py) that has no natural
# object to hang a tracer on reads the process-global here.  It starts
# disabled, so by default every library call site takes the null path.

_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process-global tracer (disabled unless someone enabled it)."""
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process-global; returns the previous one."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = tracer
    return prev
