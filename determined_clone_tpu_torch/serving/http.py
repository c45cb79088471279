"""Stdlib HTTP front-ends for serving — the port of
``determined_clone_tpu/serving/http.py``.

``ThreadingHTTPServer`` + JSON, no framework. The engine's scheduler
thread does all device work; request-handler threads only enqueue and
block on their handle, so concurrency is bounded by the engine's queue —
a full queue surfaces as HTTP 429 with a Retry-After hint, the wire form
of :class:`ServerOverloaded` backpressure.

Routes (:class:`ServingHTTPServer`):
  POST /v1/generate   {"prompt": [ids], "max_new_tokens": n,
                       "eos_token_id": optional, "request_id": optional,
                       "timeout_s": optional}
                      → 200 result | 400 bad request | 413 body too large
                        | 429 overloaded | 503 engine down | 504 timeout
  GET  /healthz       engine liveness + stats snapshot
  GET  /metrics       Prometheus exposition of the serving registry

Fleet routes (:class:`FleetHTTPServer`): the same ``/v1/generate``
contract (plus ``"deadline_s"``, a relative deadline propagated router →
engine; expiry is 504), dispatched through the least-loaded router, so a
429 from one replica fails over instead of reaching the client; a
request quarantined as a poison pill is 422 with crash diagnostics.
Plus the operations surface ``fleet`` drives:
  GET  /v1/fleet      fleet stats + per-replica states + health view
                      (breaker state, heartbeat age, last incident) and
                      the KV tier's counters
  GET  /v1/slo        the fleet's SLO evaluation (404 without one)
  POST /v1/scale      {"replicas": n} → drain-protected resize
  POST /v1/rollout    {"checkpoint": dir} → blue-green rollout
  GET  /metrics       fleet registry + per-replica series with
                      component=serving_replica_* labels (aggregated)
Status codes and fields are the JAX server's.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Tuple

from determined_clone_tpu_torch.serving.engine import (
    InferenceEngine,
    ServerOverloaded,
)

MAX_BODY_BYTES = 1 << 20  # generous for token-id prompts


def _make_handler(engine: InferenceEngine):
    class Handler(BaseHTTPRequestHandler):
        # one engine per server; bound via closure
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt: str, *args: Any) -> None:
            pass  # the metrics registry is the access log

        def _reply(self, code: int, payload: Any,
                   content_type: str = "application/json",
                   extra_headers: Tuple[Tuple[str, str], ...] = ()) -> None:
            body = (payload if isinstance(payload, bytes)
                    else json.dumps(payload).encode("utf-8"))
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra_headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
            if self.path == "/healthz":
                self._reply(200, {"ok": True,
                                  "stats": dataclasses.asdict(engine.stats())})
            elif self.path == "/metrics":
                self._reply(200, engine.registry.dump().encode("utf-8"),
                            content_type="text/plain; version=0.0.4")
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self) -> None:  # noqa: N802
            if self.path != "/v1/generate":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > MAX_BODY_BYTES:
                    self._reply(413, {"error": "request body too large"})
                    return
                req = json.loads(self.rfile.read(length) or b"{}")
                prompt = req.get("prompt")
                if not isinstance(prompt, list):
                    raise ValueError("'prompt' must be a list of token ids")
                handle = engine.submit(
                    prompt, int(req.get("max_new_tokens", 16)),
                    eos_token_id=req.get("eos_token_id"),
                    request_id=req.get("request_id"))
                result = handle.result(timeout=float(
                    req.get("timeout_s", 120.0)))
            except ServerOverloaded as e:
                self._reply(429, {"error": str(e)},
                            extra_headers=(("Retry-After", "1"),))
                return
            except (ValueError, TypeError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            except TimeoutError as e:
                self._reply(504, {"error": str(e)})
                return
            except RuntimeError as e:
                self._reply(503, {"error": str(e)})
                return
            self._reply(200, {
                "request_id": result.request_id,
                "tokens": result.tokens,
                "finish_reason": result.finish_reason,
                "prompt_len": result.prompt_len,
                "latency": {
                    "queue_wait_s": round(result.queue_wait_s, 6),
                    "prefill_s": round(result.prefill_s, 6),
                    "decode_s": round(result.decode_s, 6),
                    "total_s": round(result.total_s, 6),
                    # how much prefill the prefix cache skipped and how
                    # well the draft model did
                    "prefix_hit_blocks": result.prefix_hit_blocks,
                    "prefix_miss_blocks": result.prefix_miss_blocks,
                    "spec_proposed": result.spec_proposed,
                    "spec_accepted": result.spec_accepted,
                    "spec_acceptance": result.spec_acceptance,
                },
            })

    return Handler


class ServingHTTPServer:
    """Threaded HTTP server wrapping one :class:`InferenceEngine`.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    Serving runs on a daemon thread named ``serving-http`` that
    :meth:`close` joins.
    """

    def __init__(self, engine: InferenceEngine, *, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.engine = engine
        self._server = ThreadingHTTPServer((host, port),
                                           _make_handler(engine))
        # per-request handler threads die with their connection; daemon,
        # so a hung client can't block shutdown
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="serving-http", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "ServingHTTPServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def close(self, timeout: float = 10.0) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout)


def _make_fleet_handler(fleet: Any, aggregator: Any):
    from determined_clone_tpu_torch.serving.fleet import PoisonPillRequest
    from determined_clone_tpu_torch.serving.router import NoHealthyReplica

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt: str, *args: Any) -> None:
            pass

        def _send(self, code: int, payload: Any,
                  content_type: str = "application/json") -> None:
            body = (payload if isinstance(payload, bytes)
                    else json.dumps(payload).encode("utf-8"))
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> Dict[str, Any]:
            length = int(self.headers.get("Content-Length", "0"))
            if length > MAX_BODY_BYTES:
                raise ValueError("request body too large")
            return json.loads(self.rfile.read(length) or b"{}")

        def do_GET(self) -> None:  # noqa: N802
            if self.path == "/healthz":
                st = fleet.stats()
                self._send(200, {"ok": st.healthy > 0,
                                 "stats": dataclasses.asdict(st)})
            elif self.path == "/v1/fleet":
                slo = getattr(fleet, "slo", None)
                kv = getattr(fleet, "kv_stats", None)
                self._send(200, {
                    "name": fleet.name,
                    "stats": dataclasses.asdict(fleet.stats()),
                    "replicas": [{"id": r.replica_id, "state": r.state}
                                 for r in fleet.replicas()],
                    "excluded": fleet.router.excluded(),
                    "health": fleet.health_view(),
                    "kv_tier": kv() if callable(kv) else None,
                    "slo_verdict": (slo.evaluate()["verdict"]
                                    if slo is not None else None),
                })
            elif self.path == "/v1/slo":
                slo = getattr(fleet, "slo", None)
                if slo is None:
                    self._send(404, {"error": "no SLO engine configured"})
                else:
                    self._send(200, {"slo": slo.evaluate()})
            elif self.path == "/metrics":
                fleet.sample_telemetry()
                text = fleet.registry.dump() + aggregator.dump()
                self._send(200, text.encode("utf-8"),
                           content_type="text/plain; version=0.0.4")
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self) -> None:  # noqa: N802
            try:
                if self.path == "/v1/generate":
                    req = self._body()
                    prompt = req.get("prompt")
                    if not isinstance(prompt, list):
                        raise ValueError(
                            "'prompt' must be a list of token ids")
                    timeout = float(req.get("timeout_s", 120.0))
                    deadline_s = req.get("deadline_s")
                    handler = getattr(fleet, "handle_request", None)
                    if handler is not None:
                        # the front door proper: mints request_id/trace_id,
                        # records the frontdoor span, accounts SLO+archive
                        result, handle = handler(
                            prompt, int(req.get("max_new_tokens", 16)),
                            eos_token_id=req.get("eos_token_id"),
                            request_id=req.get("request_id"),
                            trace_id=req.get("trace_id"),
                            timeout=timeout,
                            deadline_s=(float(deadline_s)
                                        if deadline_s is not None
                                        else None))
                    else:  # minimal fleet fakes in tests
                        handle = fleet.submit(
                            prompt, int(req.get("max_new_tokens", 16)),
                            eos_token_id=req.get("eos_token_id"),
                            request_id=req.get("request_id"),
                            timeout=timeout)
                        result = handle.result(timeout=timeout)
                    self._send(200, {
                        "request_id": result.request_id,
                        "trace_id": getattr(result, "trace_id", None)
                        or req.get("trace_id"),
                        "replica_id": getattr(handle, "replica_id", ""),
                        "tokens": result.tokens,
                        "finish_reason": result.finish_reason,
                        "prompt_len": result.prompt_len,
                    })
                elif self.path == "/v1/scale":
                    req = self._body()
                    n = int(req.get("replicas", -1))
                    if n < 0:
                        raise ValueError("'replicas' must be >= 0")
                    fleet.scale_to(n)
                    self._send(200, {"replicas": fleet.replica_ids()})
                elif self.path == "/v1/rollout":
                    req = self._body()
                    ckpt = req.get("checkpoint")
                    if not ckpt:
                        raise ValueError("'checkpoint' dir is required")
                    from determined_clone_tpu_torch.core._serialization \
                        import load_pytree

                    new_params = load_pytree(ckpt, like=fleet._params)
                    report = fleet.rollout(new_params)
                    self._send(200, dataclasses.asdict(report))
                else:
                    self._send(404, {"error": f"no route {self.path}"})
            except (ServerOverloaded, NoHealthyReplica) as e:
                # only a fully-overloaded fleet surfaces 429: single-
                # replica 429s are absorbed by router failover
                self._send(429, {"error": str(e)})
            except (ValueError, TypeError, json.JSONDecodeError,
                    FileNotFoundError) as e:
                self._send(400, {"error": str(e)})
            except TimeoutError as e:
                self._send(504, {"error": str(e)})
            except PoisonPillRequest as e:
                # quarantined: the request's own fault, not the fleet's
                # — 4xx with the crash diagnostics, before the generic
                # RuntimeError → 503 (PoisonPillRequest IS a RuntimeError)
                self._send(422, {"error": str(e),
                                 "diagnostics": e.diagnostics})
            except RuntimeError as e:
                self._send(503, {"error": str(e)})

    return Handler


class FleetHTTPServer:
    """Threaded HTTP front door for a :class:`ServingFleet`.

    Requests fan out through the fleet's router; the operations routes
    (scale / rollout) run the drain-protected protocols inline in the
    handler thread (the server is threaded, so traffic keeps flowing
    through the other handler threads while one drains). ``/metrics``
    merges the fleet registry with per-replica series via the fleet's
    aggregator (one is created if the fleet has none). The serve thread
    is named ``fleet-http`` for the conftest thread-leak fixture.
    """

    def __init__(self, fleet: Any, *, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.fleet = fleet
        if fleet.aggregator is None:
            from determined_clone_tpu_torch.telemetry.aggregate import (
                ClusterMetricsAggregator,
            )

            fleet.aggregator = ClusterMetricsAggregator()
        slo = getattr(fleet, "slo", None)
        attach = getattr(fleet.aggregator, "attach_slo", None)
        if slo is not None and attach is not None:
            attach(slo)
        self._server = ThreadingHTTPServer(
            (host, port), _make_fleet_handler(fleet, fleet.aggregator))
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="fleet-http", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "FleetHTTPServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def close(self, timeout: float = 10.0) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout)


def generate_over_http(url: str, prompt: Any, max_new_tokens: int = 16,
                       timeout: float = 120.0) -> Dict[str, Any]:
    """Minimal client for tests and ``serve --selftest``."""
    import urllib.request

    body = json.dumps({"prompt": list(prompt),
                       "max_new_tokens": max_new_tokens}).encode("utf-8")
    req = urllib.request.Request(
        f"{url}/v1/generate", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))
