"""Chrome trace-event (Perfetto-loadable) JSON export for tracer records —
the port's copy of ``determined_clone_tpu/telemetry/chrome_trace.py``.

Writes the Trace Event Format's JSON-object form::

    {"traceEvents": [...], "displayTimeUnit": "ms", "otherData": {...}}

with one "M" (metadata) event naming each thread lane and one "X" (complete)
event per finished span — the format ``ui.perfetto.dev`` and
``chrome://tracing`` load directly. Thread lanes carry the trial runtime's
threads: the consumer loop (MainThread), the prefetch producer(s)
("train-prefetch"/"eval-prefetch"), and the profiler threads.

The converter accepts both the in-process record shape (``Tracer.events()``)
and the samples a trial shipped to the master over the profiler channel
(``group == "span"`` rows from ``/api/v1/trials/{id}/profiler``) — they share
the ``name``/``ts_us``/``dur_us``/``tid``/``tname`` keys, so ``dct trace
export`` reuses this module.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional


def chrome_trace_events(records: Iterable[Dict[str, Any]], *,
                        pid: int = 1) -> List[Dict[str, Any]]:
    """Convert tracer records to Chrome trace events.

    Thread idents (python's arbitrary 64-bit values) are remapped to small
    stable ints in first-seen order so lanes sort deterministically; a
    metadata event names each lane after the python thread.
    """
    events: List[Dict[str, Any]] = []
    tid_map: Dict[Any, int] = {}
    for rec in records:
        raw_tid = rec.get("tid", 0)
        tid = tid_map.get(raw_tid)
        if tid is None:
            tid = tid_map[raw_tid] = len(tid_map) + 1
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": str(rec.get("tname", f"thread-{tid}"))},
            })
        event: Dict[str, Any] = {
            "ph": rec.get("ph", "X"),
            "name": str(rec.get("name", "?")),
            "cat": "trial",
            "pid": pid,
            "tid": tid,
            "ts": float(rec.get("ts_us", 0.0)),
        }
        if event["ph"] == "X":
            event["dur"] = float(rec.get("dur_us", 0.0))
        elif event["ph"] == "i":
            event["s"] = "t"  # instant scope: thread
        args = rec.get("args")
        if args:
            event["args"] = dict(args)
        events.append(event)
    return events


def to_chrome_trace(records: Iterable[Dict[str, Any]], *,
                    pid: int = 1,
                    other_data: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    trace: Dict[str, Any] = {
        "traceEvents": chrome_trace_events(records, pid=pid),
        "displayTimeUnit": "ms",
    }
    if other_data:
        trace["otherData"] = other_data
    return trace


def write_chrome_trace(path: str, records: Iterable[Dict[str, Any]], *,
                       pid: int = 1,
                       other_data: Optional[Dict[str, Any]] = None) -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(records, pid=pid, other_data=other_data), f)
    return path


def spans_from_profiler_samples(samples: Iterable[Dict[str, Any]]
                                ) -> List[Dict[str, Any]]:
    """Filter master profiler samples down to shipped span records
    (``Telemetry.publish`` marks them ``group: "span"``)."""
    return [s for s in samples if s.get("group") == "span"]


def stitch_chrome_trace(samples: Iterable[Dict[str, Any]], *,
                        other_data: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
    """Stitch span records from several processes into one Chrome trace.

    Input is the master's aggregated span store (``Telemetry.publish``
    output, possibly from many trials plus the runner): each record may
    carry ``process`` (lane name), ``trace_id``, and ``wall_epoch``.
    Records group into one Chrome *process* per ``process`` label (falling
    back to ``device:{device}`` for per-device lane records from
    telemetry/mesh.py — every simulated mesh device gets its own lane —
    then ``trial-{trial_id}``), each announced with a ``process_name``
    metadata event; per-process thread lanes keep their names. Timestamps
    are re-based onto a shared axis using each tracer's ``wall_epoch``
    anchor (``ts_us`` alone is relative to a private perf_counter epoch),
    so restart legs of one trial land after each other, not on top.
    """
    by_process: Dict[str, List[Dict[str, Any]]] = {}
    for rec in samples:
        if rec.get("group") not in (None, "span"):
            continue
        proc = rec.get("process")
        if not proc and rec.get("device"):
            proc = f"device:{rec['device']}"
        if not proc:
            tid = rec.get("trial_id")
            proc = f"trial-{tid}" if tid is not None else "unknown"
        by_process.setdefault(str(proc), []).append(rec)

    epochs = [float(r["wall_epoch"])
              for recs in by_process.values() for r in recs
              if isinstance(r.get("wall_epoch"), (int, float))]
    base_epoch = min(epochs) if epochs else 0.0

    events: List[Dict[str, Any]] = []
    trace_ids = set()
    for pid, proc in enumerate(sorted(by_process), start=1):
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": proc},
        })
        recs = by_process[proc]
        shifted = []
        for rec in recs:
            if rec.get("trace_id"):
                trace_ids.add(rec["trace_id"])
            epoch = rec.get("wall_epoch")
            shift_us = ((float(epoch) - base_epoch) * 1e6
                        if isinstance(epoch, (int, float)) else 0.0)
            shifted.append(
                {**rec, "ts_us": float(rec.get("ts_us", 0.0)) + shift_us})
        shifted.sort(key=lambda r: r["ts_us"])
        events.extend(chrome_trace_events(shifted, pid=pid))

    data = dict(other_data or {})
    data.setdefault("processes", sorted(by_process))
    if trace_ids:
        data.setdefault("trace_ids", sorted(trace_ids))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": data}


def validate_chrome_trace(trace: Any) -> List[str]:
    """Structural check of a loaded trace (tests + ``dct trace export``
    sanity): returns a list of problems, empty when valid."""
    errors: List[str] = []
    if not isinstance(trace, dict):
        return ["top level must be a JSON object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents must be an array"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M", "i", "B", "E", "C"):
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        for key in ("name", "pid", "tid"):
            if key not in ev:
                errors.append(f"{where}: missing {key!r}")
        if ph == "X":
            if not isinstance(ev.get("ts"), (int, float)):
                errors.append(f"{where}: X event needs numeric ts")
            if not isinstance(ev.get("dur"), (int, float)):
                errors.append(f"{where}: X event needs numeric dur")
            elif ev["dur"] < 0:
                errors.append(f"{where}: negative dur")
    return errors
