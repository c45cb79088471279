"""Flight recorder: a bounded on-disk ring of recent spans + snapshots —
the port's copy of ``determined_clone_tpu/telemetry/flight.py`` (pure
Python there too), with the request archive the serving fleet keeps.

A process killed mid-step loses the tracer's in-memory span ring, and
the most interesting steps (the ones right before the crash) with it.
The flight recorder is the black box: every finished span (and each
published metric snapshot) is appended as a JSONL line to the current
*segment* file, and the segment ring is bounded, so a crash leaves the
last N steps readable on disk.

Durability model, from cheapest to strongest:

- every record is written through Python's buffer immediately
  (line-buffered file): ``kill -9`` / ``os._exit`` keeps everything
  already handed to the kernel — the page cache belongs to the OS, not
  the process. This is the property the chaos tests rely on.
- at segment **rotation** the closing segment is ``fsync``\\ ed, so even a
  host power loss keeps all full segments. The live segment trades that
  last level of durability for not paying an fsync per span.

The ring: ``segment_events`` records per file, ``max_segments`` files
(oldest deleted), filenames strictly increasing (``flight-00001.jsonl``)
so a reader merges by name. Each segment opens with a ``meta`` line
(wall_epoch, trace_id, process, pid) — everything
:func:`flight_to_chrome_trace` needs to stitch segments from one or many
processes into a valid Chrome trace for ``dct debug flight``.

Failure policy: a write error (disk full, injected ``flight.write``
fault) disables nothing and raises nothing — it increments a drop counter
and moves on. The recorder observes training; it must never take it down.
"""
from __future__ import annotations

import collections
import json
import os
import random
import re
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from determined_clone_tpu_torch import faults

SEGMENT_RE = re.compile(r"flight-(\d+)\.jsonl$")


class FlightRecorder:
    """Appends tracer records + metric snapshots to a segment ring."""

    def __init__(self, directory: str, *,
                 segment_events: int = 256,
                 max_segments: int = 8,
                 registry: Optional[Any] = None,
                 identity: Optional[Dict[str, Any]] = None) -> None:
        self.directory = directory
        self.segment_events = max(1, int(segment_events))
        self.max_segments = max(2, int(max_segments))
        self._identity = dict(identity or {})
        self._lock = threading.Lock()
        self._file: Optional[Any] = None
        self._seq = 0
        self._events_in_segment = 0
        self._dropped = (registry.counter(
            "flight_records_dropped",
            "flight-recorder records lost to write errors")
            if registry is not None else None)
        self._dropped_total = 0
        os.makedirs(directory, exist_ok=True)
        # resume after existing segments (a restart leg appends new
        # segments rather than clobbering the previous leg's evidence)
        existing = _segment_paths(directory)
        if existing:
            self._seq = max(
                int(SEGMENT_RE.search(p).group(1)) for p in existing)

    # -- identity ----------------------------------------------------------

    def set_identity(self, **identity: Any) -> None:
        """Late-bound process identity (trace_id arrives after core.init);
        lands in the NEXT segment's meta line."""
        self._identity.update(
            {k: v for k, v in identity.items() if v is not None})

    # -- writing -----------------------------------------------------------

    def record_span(self, rec: Dict[str, Any]) -> None:
        """Tracer sink: one finished span record."""
        self._write({"kind": "span", **rec})

    def record_metrics(self, snapshot: Dict[str, Any], *,
                       batches_trained: Optional[int] = None) -> None:
        """One registry snapshot (called at the publish boundary)."""
        entry: Dict[str, Any] = {"kind": "metrics", "time": time.time(),
                                 "snapshot": snapshot}
        if batches_trained is not None:
            entry["batches_trained"] = int(batches_trained)
        self._write(entry)

    def _write(self, entry: Dict[str, Any]) -> None:
        try:
            line = json.dumps(entry, default=str)
        except (TypeError, ValueError):
            self._drop(1)
            return
        # fault point outside the lock (CONC003/4 lock hierarchy): a
        # delay-action fault stalls this writer only, not every thread
        # serializing on _lock; raise-action still counts as a drop
        try:
            faults.point("flight.write")
        except Exception:  # noqa: BLE001 - observer, never a dependency
            self._drop(1)
            return
        with self._lock:
            try:
                if self._file is None:
                    self._open_segment()
                self._file.write(line + "\n")
                self._events_in_segment += 1
                if self._events_in_segment >= self.segment_events:
                    self._rotate()
            except Exception:  # noqa: BLE001 - observer, never a dependency
                self._drop(1)

    def _open_segment(self) -> None:
        self._seq += 1
        path = os.path.join(self.directory, f"flight-{self._seq:05d}.jsonl")
        # buffering=1: line-buffered, every record reaches the kernel —
        # the kill -9 durability level (see module docstring)
        self._file = open(path, "w", buffering=1)
        self._events_in_segment = 0
        meta = {"kind": "meta", "segment": self._seq,
                "wall_epoch_write": time.time(), **self._identity}
        self._file.write(json.dumps(meta, default=str) + "\n")

    def _rotate(self) -> None:
        """fsync + close the full segment, open the next, trim the ring."""
        f, self._file = self._file, None
        if f is not None:
            f.flush()
            os.fsync(f.fileno())
            f.close()
        paths = _segment_paths(self.directory)
        while len(paths) > self.max_segments - 1:  # leave room for the next
            try:
                os.unlink(paths.pop(0))
            except OSError:
                break

    def _drop(self, n: int) -> None:
        self._dropped_total += n
        if self._dropped is not None:
            self._dropped.inc(n)

    @property
    def records_dropped(self) -> int:
        return self._dropped_total

    def close(self) -> None:
        """Clean-exit flush+fsync (a crash never gets here — by design
        it doesn't need to)."""
        with self._lock:
            f, self._file = self._file, None
        if f is not None:
            try:
                f.flush()
                os.fsync(f.fileno())
                f.close()
            except OSError:
                self._drop(1)


# -- reading ---------------------------------------------------------------


def _segment_paths(directory: str) -> List[str]:
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    return [os.path.join(directory, n)
            for n in sorted(names) if SEGMENT_RE.search(n)]


def read_flight(directory: str) -> Iterator[Dict[str, Any]]:
    """Yield every parseable record across segments, oldest first.

    A torn final line (the crash landed mid-write) is skipped, not
    fatal — that is the expected end state of a kill -9 run.
    """
    for path in _segment_paths(directory):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn write at the crash point
                    if isinstance(rec, dict):
                        yield rec
        except OSError:
            continue


def flight_summary(directory: str) -> Dict[str, Any]:
    """Counts + last-snapshot digest for the CLI's one-screen readout."""
    spans = 0
    snapshots = 0
    metas: List[Dict[str, Any]] = []
    last_snapshot: Optional[Dict[str, Any]] = None
    last_batches: Optional[int] = None
    span_names: Dict[str, int] = {}
    for rec in read_flight(directory):
        kind = rec.get("kind")
        if kind == "span":
            spans += 1
            name = str(rec.get("name", "?"))
            span_names[name] = span_names.get(name, 0) + 1
        elif kind == "metrics":
            snapshots += 1
            last_snapshot = rec.get("snapshot")
            if rec.get("batches_trained") is not None:
                last_batches = int(rec["batches_trained"])
        elif kind == "meta":
            metas.append(rec)
    return {
        "segments": len(_segment_paths(directory)),
        "spans": spans,
        "metric_snapshots": snapshots,
        "span_names": span_names,
        "last_batches_trained": last_batches,
        "last_snapshot": last_snapshot,
        "processes": sorted({str(m.get("process"))
                             for m in metas if m.get("process")}),
    }


def flight_to_chrome_trace(directory: str) -> Dict[str, Any]:
    """Merge a flight ring into one Chrome trace (stitched across any
    processes that shared the directory), ready for Perfetto and
    ``validate_chrome_trace``."""
    from determined_clone_tpu_torch.telemetry.chrome_trace import (
        stitch_chrome_trace,
        to_chrome_trace,
    )

    spans: List[Dict[str, Any]] = []
    ident: Dict[str, Any] = {}
    multi_process = False
    for rec in read_flight(directory):
        kind = rec.get("kind")
        if kind == "meta":
            new_ident = {k: rec[k] for k in
                         ("wall_epoch", "trace_id", "process") if k in rec}
            if (ident.get("process") and new_ident.get("process")
                    and new_ident["process"] != ident["process"]):
                multi_process = True
            ident.update(new_ident)
        elif kind == "span":
            span = {k: v for k, v in rec.items() if k != "kind"}
            for k, v in ident.items():
                span.setdefault(k, v)
            spans.append(span)
    summary = flight_summary(directory)
    other = {"source": "flight_recorder", "directory": directory,
             "span_counts": summary["span_names"],
             "last_batches_trained": summary["last_batches_trained"]}
    if multi_process or any(s.get("process") for s in spans):
        return stitch_chrome_trace(spans, other_data=other)
    return to_chrome_trace(spans, other_data=other)


# -- per-request trace archive ----------------------------------------------


class RequestArchive:
    """Flight-recorder-durable, tail-sampled archive of per-request spans.

    Two stores under one directory (docs/observability.md "Request tracing
    & SLOs"):

    - ``live/`` — a write-through :class:`FlightRecorder` ring. Every
      request-tagged span hits disk the moment it finishes, so a replica
      killed mid-request leaves its partial leg readable (the chaos
      property). Bounded like any flight ring: the oldest segments age
      out.
    - ``retained/`` — the curated archive, written once per *finished*
      request by the tail-sampling policy: errors are always kept, the
      slowest-N by latency are always kept, and everything else is kept
      with probability ``sample_rate``. Retained entries bundle the
      request's full span list, so they survive after the live ring has
      rotated past them.

    Span records arrive via :meth:`sink_for` hooks on each component
    tracer (front door, router, replicas); only records whose args carry a
    ``request_id`` are archived. Identity (process, wall_epoch, the
    request's trace_id) is attached per record at write time, so
    :func:`request_chrome_trace` can stitch one request's multi-process
    lanes without segment-order bookkeeping.
    """

    def __init__(self, directory: str, *,
                 segment_events: int = 512,
                 max_segments: int = 8,
                 slowest_n: int = 8,
                 sample_rate: float = 0.0,
                 max_open_requests: int = 512,
                 registry: Optional[Any] = None,
                 seed: int = 0) -> None:
        self.directory = directory
        self.slowest_n = max(0, int(slowest_n))
        self.sample_rate = float(sample_rate)
        self.max_open_requests = max(1, int(max_open_requests))
        self._rng = random.Random(seed)
        self._live = FlightRecorder(
            os.path.join(directory, "live"),
            segment_events=segment_events, max_segments=max_segments,
            registry=registry)
        self._retained = FlightRecorder(
            os.path.join(directory, "retained"),
            segment_events=segment_events, max_segments=max_segments)
        # per-request span buffers (completion writes the retained bundle
        # from here; a crash leaves only the live ring, by design)
        self._open: "collections.OrderedDict[str, List[Dict[str, Any]]]" = \
            collections.OrderedDict()
        # (latency_s, request_id) floor for the slowest-N policy
        self._slowest: List[Tuple[float, str]] = []
        self._lock = threading.Lock()
        self._retained_count = 0

    # -- ingest -------------------------------------------------------------

    def sink_for(self, tracer: Any) -> Any:
        """A tracer sink that archives request-tagged records with this
        tracer's identity attached."""
        def sink(rec: Dict[str, Any]) -> None:
            args = rec.get("args") or {}
            rid = args.get("request_id")
            if rid is None:
                return
            entry = {"wall_epoch": tracer.wall_epoch, **rec}
            process = getattr(tracer, "process_name", None)
            if process:
                entry["process"] = process
            trace_id = args.get("trace_id") or tracer.trace_id
            if trace_id:
                entry["trace_id"] = trace_id
            self.observe_span(str(rid), entry)
        return sink

    def observe_span(self, request_id: str,
                     rec: Dict[str, Any]) -> None:
        """One finished request-tagged span: durable immediately, and
        buffered for the completion-time sampling decision."""
        self._live.record_span(rec)
        with self._lock:
            buf = self._open.get(request_id)
            if buf is None:
                buf = self._open[request_id] = []
                while len(self._open) > self.max_open_requests:
                    # evict the oldest open request (its spans stay in the
                    # live ring; it just can't be retained as a bundle)
                    self._open.popitem(last=False)
            buf.append(rec)

    def note_result(self, request_id: str, *, ok: bool = True,
                    latency_s: Optional[float] = None,
                    error: Optional[str] = None) -> Optional[str]:
        """Completion hook: apply the tail-sampling policy.

        Returns the retention reason (``"error"``, ``"slowest"``,
        ``"sampled"``) or None when the request was let go.
        """
        with self._lock:
            spans = self._open.pop(request_id, [])
            reason: Optional[str] = None
            if not ok:
                reason = "error"
            elif latency_s is not None and self.slowest_n > 0:
                floor = (self._slowest[0][0]
                         if len(self._slowest) >= self.slowest_n else None)
                if floor is None or latency_s > floor:
                    self._slowest.append((float(latency_s), request_id))
                    self._slowest.sort()
                    del self._slowest[:-self.slowest_n]
                    reason = "slowest"
            if reason is None and self._rng.random() < self.sample_rate:
                reason = "sampled"
            if reason is None:
                return None
            self._retained_count += 1
        trace_id = next((s["trace_id"] for s in spans
                         if s.get("trace_id")), None)
        entry: Dict[str, Any] = {
            "kind": "request", "request_id": request_id, "ok": bool(ok),
            "reason": reason, "time": time.time(), "spans": spans,
        }
        if latency_s is not None:
            entry["latency_s"] = round(float(latency_s), 6)
        if error is not None:
            entry["error"] = str(error)[:500]
        if trace_id is not None:
            entry["trace_id"] = trace_id
        self._retained._write(entry)
        return reason

    @property
    def retained_count(self) -> int:
        return self._retained_count

    def close(self) -> None:
        self._live.close()
        self._retained.close()


def read_request_archive(directory: str) -> Iterator[Dict[str, Any]]:
    """Yield every record from both archive stores: live-ring span
    records first, then retained request bundles."""
    for rec in read_flight(os.path.join(directory, "live")):
        if rec.get("kind") == "span":
            yield rec
    for rec in read_flight(os.path.join(directory, "retained")):
        if rec.get("kind") == "request":
            yield rec


def request_archive_summary(directory: str) -> Dict[str, Any]:
    """Counts + retained-request digest for the CLI."""
    live_spans = 0
    live_requests = set()
    retained: List[Dict[str, Any]] = []
    for rec in read_request_archive(directory):
        if rec.get("kind") == "span":
            live_spans += 1
            rid = (rec.get("args") or {}).get("request_id")
            if rid:
                live_requests.add(str(rid))
        else:
            retained.append({
                "request_id": rec.get("request_id"),
                "ok": rec.get("ok"),
                "reason": rec.get("reason"),
                "latency_s": rec.get("latency_s"),
                "spans": len(rec.get("spans") or []),
            })
    return {
        "live_spans": live_spans,
        "live_request_ids": sorted(live_requests),
        "retained": retained,
    }


def request_records(directory: str,
                    request_id: str) -> List[Dict[str, Any]]:
    """All span records for one request, merged across the live ring and
    any retained bundle, deduplicated."""
    out: List[Dict[str, Any]] = []
    seen = set()

    def _add(rec: Dict[str, Any]) -> None:
        key = (rec.get("process"), rec.get("tid"), rec.get("name"),
               rec.get("ts_us"), rec.get("ph"))
        if key in seen:
            return
        seen.add(key)
        out.append(rec)

    for rec in read_request_archive(directory):
        if rec.get("kind") == "span":
            if str((rec.get("args") or {}).get("request_id")) == request_id:
                _add(rec)
        elif str(rec.get("request_id")) == request_id:
            for span in rec.get("spans") or []:
                if isinstance(span, dict):
                    _add(span)
    return out


def request_chrome_trace(directory: str,
                         request_id: str) -> Dict[str, Any]:
    """Stitch one request's spans (front door, router, every replica leg)
    into a single multi-process Chrome trace. Raises KeyError when the
    archive has no spans for the id."""
    from determined_clone_tpu_torch.telemetry.chrome_trace import (
        stitch_chrome_trace,
    )

    records = request_records(directory, request_id)
    if not records:
        raise KeyError(
            f"request {request_id!r} not found in archive {directory!r}")
    return stitch_chrome_trace(
        records,
        other_data={"source": "request_archive", "directory": directory,
                    "request_id": request_id})


__all__ = [
    "FlightRecorder",
    "RequestArchive",
    "flight_summary",
    "flight_to_chrome_trace",
    "read_flight",
    "read_request_archive",
    "request_archive_summary",
    "request_chrome_trace",
    "request_records",
]
