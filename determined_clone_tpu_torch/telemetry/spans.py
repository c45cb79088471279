"""Span/Tracer — context-manager tracing; the port's own copy of
``determined_clone_tpu/telemetry/spans.py`` (pure Python there too).

Spans record *where time went on which thread*, with nesting; the
serving engine records its per-request events (admission, prefill
chunks, speculative rounds, copy-on-write forks, retirement) through
:meth:`Tracer.instant` and :meth:`Tracer.record_span`.

Design constraints:

- **Thread-safe**: spans may open/close concurrently on several threads.
  Completed records append under one lock; per-thread nesting depth lives
  in a ``threading.local``.
- **Monotonic clocks**: all timestamps are ``time.perf_counter`` offsets
  from the tracer's epoch — wall-clock steps (NTP) cannot produce negative
  durations. One wall-clock anchor is kept for cross-process alignment.
- **Cheap when off**: a disabled tracer hands out one shared no-op span
  (no allocation, no lock).
- **Bounded**: at ``max_events`` the tracer stops recording (keeping the
  head) and counts drops, so a long run cannot OOM the host.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional


class _NullSpan:
    """Shared no-op span: the disabled-path cost is one method call."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def set(self, **args: Any) -> None:
        return None


NULL_SPAN = _NullSpan()


def null_span(name: str, **args: Any) -> _NullSpan:
    """Drop-in for ``Tracer.span`` when no tracer is wired."""
    return NULL_SPAN


class Span:
    """One live span; records itself into the tracer on ``__exit__``.

    Not reentrant and single-thread by construction (a span belongs to the
    thread that opened it — cross-thread causality is expressed by the
    thread lanes in the exported trace, not by parent links).
    """

    __slots__ = ("_tracer", "name", "args", "_start", "_depth")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]) -> None:
        self._tracer = tracer
        self.name = name
        self.args = args
        self._start = 0.0
        self._depth = 0

    def set(self, **args: Any) -> None:
        """Attach/override args after entry (e.g. compile detection only
        known once the call returns)."""
        if self.args is None:
            self.args = {}
        self.args.update(args)

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self)
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        end = time.perf_counter()
        stack = self._tracer._stack()
        # tolerate exception-path misnesting: pop to (and including) self
        while stack:
            if stack.pop() is self:
                break
        self._tracer._record(self.name, self._start, end - self._start,
                             self._depth, self.args)


class Tracer:
    """Collects finished span records; thread-safe; monotonic timestamps.

    Records are plain dicts, ready for the Chrome-trace exporter::

        {"name", "ts_us", "dur_us", "tid", "tname", "depth", "args"}

    ``ts_us`` is microseconds since the tracer epoch (perf_counter based);
    ``wall_epoch`` maps it back to wall time when needed.
    """

    def __init__(self, *, enabled: bool = True,
                 max_events: int = 200_000,
                 trace_id: Optional[str] = None,
                 process_name: Optional[str] = None) -> None:
        self.enabled = enabled
        # cross-component identity (set lazily by the runner/trial entry):
        # records stay identity-free in memory; publish/export attach these
        self.trace_id = trace_id
        self.process_name = process_name
        self.max_events = int(max_events)
        self.dropped = 0
        self._events: List[Dict[str, Any]] = []
        self._sinks: List[Callable[[Dict[str, Any]], None]] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._epoch = time.perf_counter()
        self.wall_epoch = time.time()

    def add_sink(self, sink: Callable[[Dict[str, Any]], None]) -> None:
        """Register a per-record hook (e.g. the flight recorder). Sinks
        see every finished record — including ones past ``max_events``,
        where the in-memory ring keeps the head but a recorder wants the
        *tail* (the steps right before a crash)."""
        self._sinks.append(sink)

    # -- recording ----------------------------------------------------------

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **args: Any):
        """Open a span: ``with tracer.span("validate"): ...``"""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, args or None)

    def instant(self, name: str, **args: Any) -> None:
        """A zero-duration marker event (Chrome trace ph="i")."""
        if not self.enabled:
            return
        self._record(name, time.perf_counter(), 0.0,
                     len(self._stack()), args or None, instant=True)

    def record_span(self, name: str, start: float, duration_s: float,
                    **args: Any) -> None:
        """Record an explicitly-timed span (``start`` in perf_counter
        time) — used for derived events like ``xla_compile``."""
        if not self.enabled:
            return
        self._record(name, start, duration_s, 0, args or None)

    def _record(self, name: str, start: float, duration_s: float,
                depth: int, args: Optional[Dict[str, Any]],
                instant: bool = False) -> None:
        thread = threading.current_thread()
        rec: Dict[str, Any] = {
            "name": name,
            "ts_us": round((start - self._epoch) * 1e6, 1),
            "dur_us": round(duration_s * 1e6, 1),
            "tid": thread.ident or 0,
            "tname": thread.name,
            "depth": depth,
        }
        if instant:
            rec["ph"] = "i"
        if args:
            rec["args"] = args
        with self._lock:
            if len(self._events) >= self.max_events:
                # keep the head: startup + compile spans are unrepeatable,
                # steady-state step spans are statistically redundant
                self.dropped += 1
            else:
                self._events.append(rec)
        # sinks (flight recorder) see every record, including past the
        # in-memory cap — a black box wants the tail, not the head
        for sink in self._sinks:
            try:
                sink(rec)
            except Exception:  # noqa: BLE001 - sinks never break tracing
                pass

    # -- reading ------------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of all finished records (copy; safe to mutate)."""
        with self._lock:
            return list(self._events)

    def drain_since(self, index: int) -> tuple:
        """(new events after ``index``, next index) — for batched shipping."""
        with self._lock:
            return self._events[index:], len(self._events)

    def span_summary(self) -> Dict[str, Dict[str, float]]:
        """Aggregate per span name: count / total_s / mean_ms / max_ms.

        The table bench.py emits into the BENCH json, and the quick
        "where did the time go" answer without loading the full trace.
        """
        out: Dict[str, Dict[str, float]] = {}
        for rec in self.events():
            if rec.get("ph") == "i":
                continue
            agg = out.setdefault(rec["name"], {
                "count": 0, "total_s": 0.0, "max_ms": 0.0})
            agg["count"] += 1
            agg["total_s"] += rec["dur_us"] / 1e6
            agg["max_ms"] = max(agg["max_ms"], rec["dur_us"] / 1e3)
        for agg in out.values():
            agg["total_s"] = round(agg["total_s"], 6)
            agg["mean_ms"] = round(1e3 * agg["total_s"] / agg["count"], 3)
            agg["max_ms"] = round(agg["max_ms"], 3)
        return out
