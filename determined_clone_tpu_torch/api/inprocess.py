"""In-process master — the control-plane surface without the C++ binary;
the port's copy of ``determined_clone_tpu/api/inprocess.py``.

The observability plane needs a master that test harnesses and the
:class:`~determined_clone_tpu_torch.experiment.LocalExperimentRunner` can
embed in-process: something that speaks the same
``/api/v1/trials/{id}/profiler`` ingestion route and serves the
aggregated cluster view (``GET /metrics``, experiment traces) without a
build step. :class:`InProcessMaster` is that surface, built on the
port's :class:`~determined_clone_tpu_torch.telemetry.aggregate.ClusterMetricsAggregator`.

Three ways in, same routing table:

- direct calls (``master.ingest_trial(...)``) for same-process callers;
- :class:`InProcessSession` — a ``MasterSession``-shaped shim (same
  ``get``/``post``/``request`` signatures, the same :class:`MasterError`
  on failure);
- :func:`serve_http` — a stdlib ThreadingHTTPServer front-end on an
  ephemeral port, so real-HTTP round trips exercise the wire format.

With ``enable_timeseries`` the master grows the time-series layer: the
port's :class:`~determined_clone_tpu_torch.telemetry.tsdb.TimeSeriesDB`
scraped from the aggregator and a
:class:`~determined_clone_tpu_torch.telemetry.rules.RuleEngine`, served
as ``GET /api/v1/timeseries`` and ``GET /api/v1/alerts``; before it both
routes answer 404 "not enabled".
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs

from determined_clone_tpu_torch.api.client import MasterError
from determined_clone_tpu_torch.telemetry.aggregate import (
    ClusterMetricsAggregator,
)


class InProcessMaster:
    """Routes observability traffic into a cluster aggregator.

    With :meth:`enable_timeseries` the master also grows a history
    layer: a :class:`~determined_clone_tpu_torch.telemetry.tsdb.TimeSeriesDB`
    scraped from the aggregator plus a
    :class:`~determined_clone_tpu_torch.telemetry.rules.RuleEngine`, exposed
    as ``GET /api/v1/timeseries`` and ``GET /api/v1/alerts``. Tests
    drive :meth:`scrape_tick` deterministically; long-running callers
    start the ``dct-tsdb-scrape`` loop.
    """

    def __init__(self, *,
                 clock: Callable[[], float] = time.time) -> None:
        self._clock = clock
        self.aggregator = ClusterMetricsAggregator(clock=clock)
        self._lock = threading.Lock()
        self._trial_experiment: Dict[int, int] = {}
        self.tsdb: Any = None
        self.rules: Any = None
        self._scraper: Any = None

    # -- time-series layer --------------------------------------------------

    def enable_timeseries(self, config: Optional[Any] = None, *,
                          tsdb: Any = None, rules: Any = None) -> Any:
        """Attach the TSDB + rule engine. ``config`` is an
        ObservabilityConfig (or its mapping form): ``timeseries:`` sizes
        the store, ``rules:`` declares the alert rules, and
        ``stock_slo_rules: true`` adds the SLO engine's fast/slow burn pair.
        Returns the TSDB."""
        from determined_clone_tpu_torch.telemetry.rules import (
            RuleEngine,
            stock_slo_rules,
        )
        from determined_clone_tpu_torch.telemetry.tsdb import TimeSeriesDB

        raw: Dict[str, Any] = {}
        if config is not None:
            raw = (config.to_dict() if hasattr(config, "to_dict")
                   else dict(config))
        self.tsdb = tsdb if tsdb is not None else TimeSeriesDB.from_dict(
            raw.get("timeseries"), clock=self._clock)
        if rules is not None:
            self.rules = rules
        else:
            engine = RuleEngine.from_config(raw.get("rules"),
                                            clock=self._clock)
            if raw.get("stock_slo_rules"):
                for r in stock_slo_rules():
                    engine.add(r)
            self.rules = engine
        return self.tsdb

    def scrape_tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One deterministic history tick: scrape the aggregator into
        the TSDB, evaluate the rules against it, and publish firing
        states back into the master registry (so the *next* scrape
        stores the alert gauges too)."""
        if self.tsdb is None:
            raise RuntimeError("time-series layer not enabled "
                               "(call enable_timeseries first)")
        now = self._clock() if now is None else float(now)
        stored = self.tsdb.scrape(self.aggregator, now=now)
        states = (self.rules.evaluate(self.tsdb, now=now)
                  if self.rules is not None else [])
        if self.rules is not None:
            self.rules.publish(self.aggregator.registry)
        return {"stored": stored, "rules": states}

    def start_scraper(self, period_s: float = 5.0) -> None:
        """Start the ``dct-tsdb-scrape`` background loop."""
        from determined_clone_tpu_torch.telemetry.tsdb import TSDBScraper

        if self.tsdb is None:
            raise RuntimeError("time-series layer not enabled "
                               "(call enable_timeseries first)")
        if self._scraper is not None:
            raise RuntimeError("scraper already started")
        self._scraper = TSDBScraper(self.scrape_tick, period_s).start()

    def stop_scraper(self) -> None:
        if self._scraper is not None:
            self._scraper.close()
            self._scraper = None
        if self.tsdb is not None:
            self.tsdb.close()

    # -- direct (same-process) surface -------------------------------------

    def register_trial(self, trial_id: int, experiment_id: int) -> None:
        with self._lock:
            self._trial_experiment[int(trial_id)] = int(experiment_id)
        self.aggregator.register_trial(trial_id, experiment_id)

    def experiment_of(self, trial_id: int) -> Optional[int]:
        with self._lock:
            return self._trial_experiment.get(int(trial_id))

    def ingest_trial(self, trial_id: int, samples: List[Dict[str, Any]], *,
                     idempotency_key: Optional[str] = None) -> int:
        return self.aggregator.ingest(
            trial_id, samples, idempotency_key=idempotency_key,
            experiment_id=self.experiment_of(trial_id))

    def ingest_component(self, name: str, registry: Any) -> None:
        self.aggregator.ingest_component(name, registry)

    def ingest_component_spans(self, name: str,
                               samples: List[Dict[str, Any]], *,
                               experiment_id: Optional[int] = None) -> int:
        return self.aggregator.ingest_component_spans(
            name, samples, experiment_id=experiment_id)

    def metrics_text(self) -> str:
        return self.aggregator.dump()

    def summary(self, top_n: int = 10) -> Dict[str, Any]:
        return self.aggregator.summary(top_n)

    def spans(self, *, trial_id: Optional[int] = None,
              experiment_id: Optional[int] = None) -> List[Dict[str, Any]]:
        return self.aggregator.spans(trial_id=trial_id,
                                     experiment_id=experiment_id)

    # -- routing (shared by the session shim and the HTTP front-end) --------

    def handle(self, method: str, path: str,
               body: Optional[Dict[str, Any]] = None
               ) -> Tuple[int, Any, str]:
        """Dispatch one request; returns (status, payload, content_type).

        JSON payloads are dicts; ``/metrics`` returns Prometheus text.
        """
        path, _, query = path.partition("?")
        params = {k: v[-1] for k, v in parse_qs(query).items()}
        path = path.rstrip("/") or "/"
        parts = [p for p in path.split("/") if p]
        if method == "GET" and path == "/metrics":
            return 200, self.metrics_text(), "text/plain; version=0.0.4"
        if (method == "POST" and len(parts) == 5 and parts[:2] ==
                ["api", "v1"] and parts[2] == "trials"
                and parts[4] == "profiler"):
            body = body or {}
            samples = body.get("samples")
            if samples is None:
                return 400, {"error": "missing samples"}, "application/json"
            accepted = self.ingest_trial(
                int(parts[3]), samples,
                idempotency_key=body.get("idempotency_key"))
            return 200, {"accepted": accepted}, "application/json"
        if (method == "POST" and len(parts) == 5 and parts[:2] ==
                ["api", "v1"] and parts[2] == "components"
                and parts[4] == "profiler"):
            body = body or {}
            name = parts[3]
            accepted = 0
            metrics = body.get("metrics")
            if metrics is not None:
                self.ingest_component(name, metrics)
                accepted += 1
            spans = body.get("spans")
            if spans is not None:
                exp = body.get("experiment_id")
                accepted += self.ingest_component_spans(
                    name, spans,
                    experiment_id=int(exp) if exp is not None else None)
            return 200, {"accepted": accepted}, "application/json"
        if (method == "GET" and len(parts) == 4 and parts[:2] ==
                ["api", "v1"] and parts[2] == "cluster"
                and parts[3] == "metrics"):
            return 200, self.summary(), "application/json"
        if (method == "GET" and len(parts) == 4 and parts[:2] ==
                ["api", "v1"] and parts[2] == "cluster"
                and parts[3] == "goodput"):
            return 200, self.aggregator.goodput_rollup(), "application/json"
        if (method == "GET" and len(parts) == 4 and parts[:2] ==
                ["api", "v1"] and parts[2] == "cluster"
                and parts[3] == "slo"):
            return 200, {"slo": self.aggregator.slo_rollup()}, \
                "application/json"
        if (method == "GET" and len(parts) == 3 and parts[:2] ==
                ["api", "v1"] and parts[2] == "timeseries"):
            return self._handle_timeseries(params)
        if (method == "GET" and len(parts) == 3 and parts[:2] ==
                ["api", "v1"] and parts[2] == "alerts"):
            if self.rules is None:
                return 404, {"error": "alert rules not enabled on this "
                             "master"}, "application/json"
            return 200, self.rules.alerts(), "application/json"
        if (method == "GET" and len(parts) == 5 and parts[:2] ==
                ["api", "v1"] and parts[2] == "experiments"
                and parts[4] == "trace"):
            spans = self.spans(experiment_id=int(parts[3]))
            return 200, {"samples": spans}, "application/json"
        if (method == "GET" and len(parts) == 5 and parts[:2] ==
                ["api", "v1"] and parts[2] == "trials"
                and parts[4] == "trace"):
            spans = self.spans(trial_id=int(parts[3]))
            return 200, {"samples": spans}, "application/json"
        return 404, {"error": f"no route for {method} {path}"}, \
            "application/json"

    def _handle_timeseries(self, params: Dict[str, str]
                           ) -> Tuple[int, Any, str]:
        """``GET /api/v1/timeseries[?name=...&window=...&reduce=...&
        labels=k=v,k=v&q=...]`` — no ``name`` lists series + store
        stats; with one, runs a windowed query."""
        if self.tsdb is None:
            return 404, {"error": "time-series layer not enabled on "
                         "this master"}, "application/json"
        name = params.get("name")
        if not name:
            return 200, {"series": self.tsdb.series_names(),
                         "stats": self.tsdb.stats()}, "application/json"
        labels: Dict[str, str] = {}
        for part in (params.get("labels") or "").split(","):
            if not part:
                continue
            key, eq, value = part.partition("=")
            if not eq:
                return 400, {"error": f"bad labels matcher {part!r} "
                             "(want k=v,k2=v2)"}, "application/json"
            labels[key] = value
        try:
            payload = self.tsdb.query(
                name, labels or None,
                window_s=float(params.get("window", 300.0)),
                reduce=params.get("reduce", "raw"),
                q=float(params.get("q", 0.95)))
        except ValueError as e:
            return 400, {"error": str(e)}, "application/json"
        return 200, payload, "application/json"


class InProcessSession:
    """``MasterSession``-shaped handle onto an :class:`InProcessMaster`.

    Code written against the REST client (ProfilerAgent, CLI commands)
    runs against the in-process master unchanged; non-2xx responses raise
    :class:`MasterError` exactly like the HTTP client does.
    """

    def __init__(self, master: InProcessMaster) -> None:
        self.master = master
        self.host = "in-process"
        self.port = 0

    def request(self, method: str, path: str,
                body: Optional[Dict[str, Any]] = None, *,
                retryable: bool = False,
                idempotency_key: Optional[str] = None) -> Dict[str, Any]:
        if idempotency_key and body is not None:
            body = {**body, "idempotency_key": idempotency_key}
        status, payload, _ctype = self.master.handle(method, path, body)
        if status >= 400:
            msg = (payload.get("error", str(payload))
                   if isinstance(payload, dict) else str(payload))
            raise MasterError(status, msg)
        if isinstance(payload, str):
            return {"text": payload}
        return payload

    def get(self, path: str) -> Dict[str, Any]:
        return self.request("GET", path)

    def post(self, path: str, body: Optional[Dict[str, Any]] = None, *,
             retryable: bool = False,
             idempotency_key: Optional[str] = None) -> Dict[str, Any]:
        return self.request("POST", path, body, retryable=retryable,
                            idempotency_key=idempotency_key)


class _Handler(BaseHTTPRequestHandler):
    master: InProcessMaster  # set on the subclass by serve_http

    def _dispatch(self, method: str) -> None:
        body = None
        length = int(self.headers.get("Content-Length") or 0)
        if length:
            raw = self.rfile.read(length)
            try:
                body = json.loads(raw.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                self._reply(400, {"error": "invalid JSON body"},
                            "application/json")
                return
        try:
            status, payload, ctype = self.master.handle(
                method, self.path, body)
        except Exception as e:  # noqa: BLE001 - surface, don't kill server
            status, payload, ctype = 500, {"error": str(e)}, \
                "application/json"
        self._reply(status, payload, ctype)

    def _reply(self, status: int, payload: Any, ctype: str) -> None:
        data = (payload if isinstance(payload, str)
                else json.dumps(payload)).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        self._dispatch("GET")

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        self._dispatch("POST")

    def log_message(self, fmt: str, *args: Any) -> None:
        return None  # tests drive this at high rate; stay quiet


class MasterHTTPServer:
    """A running HTTP front-end; use as a context manager in tests."""

    def __init__(self, master: InProcessMaster, port: int = 0) -> None:
        handler = type("_BoundHandler", (_Handler,), {"master": master})
        self.master = master
        self._server = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self.host = "127.0.0.1"
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            name="dct-inprocess-master", daemon=True)

    def start(self) -> "MasterHTTPServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "MasterHTTPServer":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()


def serve_http(master: InProcessMaster, port: int = 0) -> MasterHTTPServer:
    """Expose an in-process master over real HTTP on an ephemeral port."""
    return MasterHTTPServer(master, port).start()
