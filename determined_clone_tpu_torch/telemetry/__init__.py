"""Telemetry — the port of ``determined_clone_tpu/telemetry``: one
:class:`Telemetry` per trial (a span :class:`Tracer`, a
:class:`MetricsRegistry` with its Prometheus text, the goodput ledger and
the flight recorder), built from the ``observability:`` block by
:func:`telemetry_from_config`, and what the trainer's telemetry branch
reads:

- ``goodput.py`` — the wall-clock ledger and its journal (pure Python,
  the JAX package's);
- ``compile.py`` — the stand-in for ``xla.py``: a step program's first
  call captured as its compile (seconds, fingerprint, FLOPs by
  ``FlopCounterMode``), measured MFU, the step-time anomaly detector;
- ``device.py`` — device memory on ``torch.cuda`` and its watermark;
- ``flops.py`` — analytic FLOP counts, the H100 peak and NVLink rate;
- ``collectives.py`` — the recorder of a meshed step's collectives;
- ``mesh.py`` — per-rank step times, device lanes, the cross-device
  straggler detector and the MULTICHIP schema;
- ``metrics.py``, ``spans.py``, ``chrome_trace.py``, ``flight.py``,
  ``aggregate.py``, ``slo.py``, ``tsdb.py`` (the master's time-series
  store and its scrape loop), ``rules.py`` (alert rules over it) — the
  JAX package's, copied.

Metric and span names are the JAX package's, ``xla_compiles_total`` and
``xla_compile`` included, so the fleet's rollups and the aggregator read
both packages alike. In the port ``xla_compile`` (and the counter)
marks a step program's first call — the lazy kernel build, library
setup and allocator growth, to the device's completion.

Opt-in via ``observability: {enabled: true}`` (or ``DCT_OBSERVABILITY=1``);
disabled (the default) it creates nothing, and the trainer runs the
unwrapped step and feeder.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

from determined_clone_tpu_torch.telemetry.chrome_trace import (
    validate_chrome_trace,
    write_chrome_trace,
)
from determined_clone_tpu_torch.telemetry.flight import FlightRecorder
from determined_clone_tpu_torch.telemetry.goodput import (
    CATEGORIES as GOODPUT_CATEGORIES,
    GoodputJournal,
    GoodputLedger,
    check_conservation,
    format_goodput,
    merge_goodput,
    read_goodput,
)
from determined_clone_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    parse_prometheus_text,
)
from determined_clone_tpu_torch.telemetry.rules import (
    AlertRule,
    RuleEngine,
    format_alerts,
    stock_slo_rules,
)
from determined_clone_tpu_torch.telemetry.spans import (
    NULL_SPAN,
    Span,
    Tracer,
    null_span,
)
from determined_clone_tpu_torch.telemetry.tsdb import (
    TSDBScraper,
    TimeSeriesDB,
)

__all__ = [
    "AlertRule", "Counter", "FlightRecorder", "GOODPUT_CATEGORIES", "Gauge",
    "GoodputJournal", "GoodputLedger", "Histogram", "MetricsRegistry",
    "NULL_SPAN", "RuleEngine", "Span", "TSDBScraper", "Telemetry",
    "TimeSeriesDB", "Tracer", "check_conservation", "format_alerts",
    "format_goodput", "merge_goodput", "null_span", "parse_prometheus_text",
    "read_goodput", "stock_slo_rules", "telemetry_from_config",
    "validate_chrome_trace", "write_chrome_trace",
]


class _TracedFeeder:
    """Wraps a device feeder so each consumer pull is a ``dataload_wait``
    span + histogram observation. Only constructed when telemetry is
    enabled — the disabled hot loop consumes the raw feeder."""

    def __init__(self, feed: Any, telemetry: "Telemetry") -> None:
        self._feed = feed
        self._span = telemetry.tracer.span
        self._hist = telemetry.registry.histogram(
            "dataload_wait_seconds",
            "consumer-visible input stall per pull (overlap residue)")

    def __iter__(self) -> "_TracedFeeder":
        return self

    def __next__(self) -> Any:
        t0 = time.perf_counter()
        with self._span("dataload_wait"):
            batch = next(self._feed)
        self._hist.observe(time.perf_counter() - t0)
        return batch

    # the trainer-facing surface of DevicePrefetcher / SyncDeviceFeeder
    def take_queue_wait(self) -> float:
        return self._feed.take_queue_wait()

    def take_host_time(self) -> float:
        return self._feed.take_host_time()

    def close(self, timeout: float = 5.0) -> None:
        self._feed.close(timeout)


class Telemetry:
    """Facade bundling one Tracer + one MetricsRegistry per trial."""

    def __init__(self, *, enabled: bool = True, max_events: int = 200_000,
                 ship_spans: bool = False, ship_metrics: bool = True,
                 trace_path: Optional[str] = None,
                 trace_id: Optional[str] = None,
                 process_name: Optional[str] = None) -> None:
        self.enabled = enabled
        self.ship_spans = ship_spans
        self.ship_metrics = ship_metrics
        self.trace_path = trace_path
        self.tracer = Tracer(enabled=enabled, max_events=max_events,
                             trace_id=trace_id, process_name=process_name)
        self.registry = MetricsRegistry()
        self._ship_cursor = 0
        # crash black box (attach_flight) + anomaly-detector tuning the
        # trainer reads off this facade; both set by telemetry_from_config
        self.flight: Optional[FlightRecorder] = None
        self.anomaly_window = 64
        self.anomaly_threshold = 5.0
        self.anomaly_min_samples = 16
        # wall-clock attribution: the ledger rides the tracer sink hook,
        # so every finished span is bucketed with no extra work on the
        # hot path
        self.goodput: Optional[GoodputLedger] = None
        if enabled:
            self.goodput = GoodputLedger(registry=self.registry)
            self.tracer.add_sink(self.goodput.observe_span)

    @property
    def trace_id(self) -> Optional[str]:
        return self.tracer.trace_id

    @property
    def process_name(self) -> Optional[str]:
        return self.tracer.process_name

    def set_identity(self, *, trace_id: Optional[str] = None,
                     process_name: Optional[str] = None) -> None:
        """Late-bind the cross-component trace identity: shipped span
        records pick it up from here on."""
        if trace_id is not None:
            self.tracer.trace_id = trace_id
        if process_name is not None:
            self.tracer.process_name = process_name
        if self.flight is not None:
            self.flight.set_identity(trace_id=self.tracer.trace_id,
                                     process=self.tracer.process_name)
        if self.goodput is not None and trace_id is not None:
            self.goodput.set_identity(trace_id=trace_id)

    def attach_flight(self, recorder: FlightRecorder) -> None:
        """Wire the flight recorder: it becomes a tracer sink (every
        finished span hits disk) and inherits this trial's identity."""
        self.flight = recorder
        recorder.set_identity(
            wall_epoch=self.tracer.wall_epoch,
            trace_id=self.tracer.trace_id,
            process=self.tracer.process_name,
            pid=os.getpid())
        self.tracer.add_sink(recorder.record_span)

    def close(self) -> None:
        """Flush durable state (flight segment, goodput journal) on clean
        shutdown."""
        if self.goodput is not None:
            self.goodput.close()
        if self.flight is not None:
            self.flight.close()

    # -- instrumentation hooks ---------------------------------------------

    def wrap_jit(self, name: str, fn: Callable[..., Any], *,
                 sync: Optional[Callable[[Any], Any]] = None,
                 observe: Optional[Callable[[float], None]] = None,
                 ) -> Callable[..., Any]:
        """Wrap a step callable: every call is a ``name`` span feeding a
        ``{name}_seconds`` histogram, and compiles are recorded as
        ``xla_compile`` spans and counted in ``xla_compiles_total``.

        A callable with a ``_cache_size`` probe counts each growth as a
        compile (the JAX package's jitted functions); the port's steps
        have none, so — as the JAX wrapper does for such a callable — the
        first call is the compile: the span is marked ``compiled``, which
        the goodput ledger books as compile time. (The JAX wrapper sets the
        mark after the span has been recorded, so its record never
        carries it; here it is set inside the span.)

        ``sync`` (``telemetry.device.block_until_ready``) is applied to
        the output *inside* the span: the card runs the step
        asynchronously, so without it the span would time the host's
        dispatch, not the device's work. This is the tracing observer
        effect — dispatch pipelining is traded for attributable timings
        while telemetry is on.

        ``observe`` receives each steady-state duration (seconds);
        compile calls are excluded.
        """
        if not self.enabled:
            return fn
        tracer = self.tracer
        hist = self.registry.histogram(
            f"{name}_seconds", f"duration of each {name} call")
        compiles = self.registry.counter(
            "xla_compiles_total",
            "jitted-program compilations observed (first calls + retraces)")
        cache_size = getattr(fn, "_cache_size", None)
        state = {"calls": 0}

        def wrapped(*args: Any, **kwargs: Any) -> Any:
            before = cache_size() if cache_size is not None else None
            first = state["calls"] == 0
            state["calls"] += 1
            t0 = time.perf_counter()
            with tracer.span(name) as sp:
                out = fn(*args, **kwargs)
                if sync is not None:
                    sync(out)
                compiled = (cache_size() > before if before is not None
                            else first)
                if compiled:
                    # inside the span, so that its record (and the goodput
                    # ledger, which books it as compile) carries the flag
                    sp.set(compiled=True)
            dt = time.perf_counter() - t0
            hist.observe(dt)
            if compiled:
                compiles.inc()
                tracer.record_span("xla_compile", t0, dt, program=name)
            elif observe is not None:
                observe(dt)
            return out

        wrapped.__name__ = f"traced_{name}"
        if cache_size is not None:
            wrapped._cache_size = cache_size
        return wrapped

    def wrap_feeder(self, feed: Any) -> Any:
        """Wrap a device feeder in ``dataload_wait`` accounting."""
        if not self.enabled:
            return feed
        return _TracedFeeder(feed, self)

    def compile_count(self) -> int:
        return int(self.registry.counter("xla_compiles_total").value)

    # -- shipping + export --------------------------------------------------

    def publish(self, profiler: Any,
                batches_trained: Optional[int] = None) -> None:
        """Feed the profiler channel one registry snapshot (group
        ``telemetry``) and, when ``ship_spans``, the span records finished
        since the last publish (group ``span``). Called at the trainer's
        chunk boundary, so shipping is batched and off the hot path. The
        port's ``core.profiler`` contract asks only for
        ``record_batch_timing``; a profiler without ``record`` gets no
        samples."""
        if not self.enabled:
            return
        if self.goodput is not None:
            # land the wall-clock account in the registry before the
            # snapshot below; also journals a durable line
            self.goodput.publish_metrics()
        if self.flight is not None:
            self.flight.record_metrics(self.registry.snapshot(),
                                       batches_trained=batches_trained)
        if profiler is None or not hasattr(profiler, "record"):
            return
        now = time.time()
        if self.ship_metrics:
            sample: Dict[str, Any] = {
                "time": now, "group": "telemetry",
                "metrics": self.registry.snapshot(),
            }
            if batches_trained is not None:
                sample["batches_trained"] = int(batches_trained)
            profiler.record(sample)
        if self.ship_spans:
            new, self._ship_cursor = self.tracer.drain_since(
                self._ship_cursor)
            # identity + clock anchor ride every shipped record, so that
            # lanes of several processes stitch into one trace
            ident: Dict[str, Any] = {"wall_epoch": self.tracer.wall_epoch}
            if self.tracer.trace_id:
                ident["trace_id"] = self.tracer.trace_id
            if self.tracer.process_name:
                ident["process"] = self.tracer.process_name
            for rec in new:
                profiler.record(
                    {"time": now, "group": "span", **ident, **rec})

    def export_chrome_trace(self, path: Optional[str] = None) -> str:
        path = path or self.trace_path or "trace.json"
        return write_chrome_trace(
            path, self.tracer.events(),
            other_data={
                "wall_epoch": self.tracer.wall_epoch,
                "events_dropped": self.tracer.dropped,
                "span_summary": self.tracer.span_summary(),
            })

    def span_summary(self) -> Dict[str, Dict[str, float]]:
        return self.tracer.span_summary()


def telemetry_from_config(config: Any) -> Optional[Telemetry]:
    """Build from an experiment config's ``observability:`` block.

    Accepts an ``ExperimentConfig`` (reads ``.observability``) or a raw
    config dict. Returns None when disabled — callers keep a
    no-telemetry fast path. Environment switches, as in the JAX package:
    ``DCT_TELEMETRY_DISABLED=1`` wins over everything;
    ``DCT_OBSERVABILITY=1``, ``DCT_FLIGHT_DIR`` and ``DCT_GOODPUT_DIR``
    force it on; ``DCT_QUEUE_WAIT_S`` books scheduler queue wait and
    ``DCT_TRACE_ID`` names the trace.
    """
    from determined_clone_tpu_torch.config.experiment import (
        ObservabilityConfig,
    )

    if os.environ.get("DCT_TELEMETRY_DISABLED") == "1":
        return None
    obs = getattr(config, "observability", None)
    if obs is None and isinstance(config, dict):
        try:
            obs = ObservabilityConfig.from_dict(
                config.get("observability") or {})
        except Exception:
            obs = ObservabilityConfig()
    enabled = bool(obs is not None and obs.enabled)
    if os.environ.get("DCT_OBSERVABILITY") == "1":
        enabled = True
    # the flight recorder needs the tracer, so a flight dir implies enabled
    flight_dir = os.environ.get("DCT_FLIGHT_DIR") or (
        obs.flight_dir if obs is not None else None)
    if flight_dir:
        enabled = True
    # same contract for the goodput journal
    goodput_dir = os.environ.get("DCT_GOODPUT_DIR") or (
        getattr(obs, "goodput_dir", None) if obs is not None else None)
    if goodput_dir:
        enabled = True
    if not enabled:
        return None
    if obs is None:
        obs = ObservabilityConfig()
    tel = Telemetry(
        enabled=True,
        max_events=obs.max_events,
        ship_spans=obs.ship_spans,
        ship_metrics=obs.ship_metrics,
        trace_path=obs.trace_path,
        # every component of one experiment shares one trace id, exported
        # by the submitter through the trial's environment
        trace_id=os.environ.get("DCT_TRACE_ID") or None,
    )
    tel.anomaly_window = obs.anomaly_window
    tel.anomaly_threshold = obs.anomaly_threshold
    tel.anomaly_min_samples = obs.anomaly_min_samples
    if flight_dir:
        tel.attach_flight(FlightRecorder(
            flight_dir,
            segment_events=obs.flight_segment_events,
            max_segments=obs.flight_segments,
            registry=tel.registry))
    if goodput_dir and tel.goodput is not None:
        tel.goodput.attach_journal(goodput_dir)
    if tel.goodput is not None:
        # the master's submitted_at -> scheduled_at wait for this leg: it
        # happened before this process was born, so it extends the
        # accountable wall-clock (pre_wall)
        queue_wait = os.environ.get("DCT_QUEUE_WAIT_S")
        if queue_wait:
            try:
                tel.goodput.note("queue_wait", float(queue_wait),
                                 pre_wall=True)
            except (TypeError, ValueError):
                pass
    return tel
