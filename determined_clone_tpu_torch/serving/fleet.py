"""Serving fleet: replica lifecycle, drain protocol, blue-green rollout —
the port of ``determined_clone_tpu/serving/fleet.py``.

One :class:`ServingFleet` owns N :class:`InferenceEngine` replicas behind
a :class:`LeastLoadedRouter` (router.py), all on one device. The pieces
that make N replicas a *fleet* rather than N servers:

- **one forward** — every replica runs the same paged forward
  (``fwd=``); each replica keeps its own pools and, after warmup, its own
  CUDA graphs (one graph memory pool per replica), captured while the
  other replicas keep serving;
- **drain protocol** — a replica is never torn down mid-request: it is
  marked DRAINING (the router stops selecting it), the engine's
  ``wait_idle()`` waits out every queued and in-flight sequence, and only
  then are its slots released. Scale-down and rollout both ride this.
- **blue-green rollout** — a new parameter version is proven on one
  drained canary replica (probe request under the new params) before the
  rest of the fleet is swapped, one drained replica at a time, so every
  request completes entirely under a single parameter version and the
  fleet never goes dark. With >= 2 replicas a rollout is invisible to
  clients; with 1 the router's own backoff (ROUTER_RETRY) bridges the
  swap window.
- **KV tiers** — with ``kv_store=`` every replica demotes evicted
  prefix blocks into one shared :class:`KVBlockStore` (host, then CAS),
  and flushes its resident blocks there before a rollout, stop or
  replacement, so a new replica starts with the fleet's prefixes warm.

:class:`MasterLink` runs the replicas as the C++ master's ``serving``
gang allocations, as the JAX fleet's does. The JAX fleet's
``exec_cache_summary`` waits with the XLA executable cache
(``ROADMAP.md``).

Telemetry: each replica keeps its own MetricsRegistry (the engine's
gauges/histograms); ``sample_telemetry()`` stamps a per-replica
``serving_tokens_per_sec`` gauge and feeds every registry to a
ClusterMetricsAggregator under ``component=serving_replica_<id>`` so
``dct metrics`` shows the fleet rollup (docs/serving.md).

Request tracing (docs/observability.md "Request tracing & SLOs"): when
tracing is on (the default; ``DCT_TELEMETRY_DISABLED=1`` turns the whole
plane off), the fleet keeps three tracer lanes — ``frontdoor`` (one span
per request, submit → result), ``router`` (dispatch + every failover
hop), and one ``serving_replica_<id>`` lane per engine (admission,
prefill chunks, speculative rounds, COW forks, retirement). Every lane
shares the per-request ``trace_id`` minted at the front door, so
``stitch_chrome_trace`` renders one request as one multi-process trace.
``archive_dir`` adds a :class:`RequestArchive`: a crash-durable live
ring of every request-tagged span plus a tail-sampled retained store
(errors + slowest-N always kept) that ``dct trace request <id>`` reads.
A fleet-level :class:`SLOEngine` accounts every front-door completion.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

from determined_clone_tpu_torch import faults
from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.models import gpt
from determined_clone_tpu_torch.serving.bucketing import BucketSpec
from determined_clone_tpu_torch.serving.engine import (
    InferenceEngine,
    ReplicaFailed,
)
from determined_clone_tpu_torch.serving.kv_cache import KVCacheConfig
from determined_clone_tpu_torch.serving.kv_store import KVBlockStore
from determined_clone_tpu_torch.serving.router import LeastLoadedRouter
from determined_clone_tpu_torch.telemetry.flight import RequestArchive
from determined_clone_tpu_torch.telemetry.metrics import MetricsRegistry
from determined_clone_tpu_torch.telemetry.slo import SLOEngine
from determined_clone_tpu_torch.telemetry.spans import Tracer

# Replica lifecycle. STARTING replicas exist but take no traffic (engine
# warming up); DRAINING replicas finish what they accepted but get
# nothing new; STOPPED replicas are awaiting removal.
STARTING = "starting"
HEALTHY = "healthy"
DRAINING = "draining"
STOPPED = "stopped"

# ring size for each serving tracer lane; archive sinks see every record
# regardless, so the ring only bounds what the aggregator can drain
_TRACE_EVENTS = 32_768


class PoisonPillRequest(RuntimeError):
    """This request crashed ``max_request_crashes`` replicas in a row
    and is quarantined: the front door refuses it outright (HTTP 422
    with diagnostics) instead of letting it take down a fourth replica.
    Requeue-after-crash is only safe for requests that are victims, not
    causes — N consecutive kills is the causal evidence."""

    def __init__(self, msg: str,
                 diagnostics: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(msg)
        self.diagnostics = dict(diagnostics or {})


def _request_key(request_id: Optional[str], prompt: Sequence[int],
                 max_new_tokens: int) -> str:
    """Stable ledger/quarantine key: the minted request id when there is
    one, else a digest of the work itself (tracing-off callers get no
    uuid, but an identical resubmission of a poison payload must still
    hit the quarantine)."""
    if request_id:
        return request_id
    h = hashlib.sha256()
    h.update(repr((tuple(prompt), int(max_new_tokens))).encode())
    return "p:" + h.hexdigest()[:16]


class RequestLedger:
    """Accepted-request ledger behind exactly-once failover.

    Every request the front door accepts is entered here and settled
    exactly once (completed / expired / failed / quarantined); a request
    orphaned by a replica crash stays OPEN across its requeue hops, so
    "zero lost accepted requests" is checkable as ``open_requests() ==
    []`` once traffic quiesces — the chaos conductor's first invariant.
    With a directory it also appends one JSON line per transition,
    line-buffered like the RequestArchive so a kill -9'd front door
    leaves a durable record of what it had accepted.
    """

    def __init__(self, path: Optional[str] = None) -> None:
        self._lock = threading.Lock()
        self._open: Dict[str, Dict[str, Any]] = {}
        self._accepted = 0
        self._file = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._file = open(path, "a", buffering=1)

    def accept(self, key: str, **info: Any) -> None:
        with self._lock:
            self._accepted += 1
            self._open[key] = {"hops": 0, **info}
            self._write_locked(key, "accepted", info)

    def event(self, key: str, kind: str, **info: Any) -> None:
        with self._lock:
            entry = self._open.get(key)
            if entry is not None:
                entry["hops"] += 1
            self._write_locked(key, kind, info)

    def settle(self, key: str, outcome: str, **info: Any) -> None:
        with self._lock:
            if self._open.pop(key, None) is None:
                return  # already settled (idempotent, like the handles)
            self._write_locked(key, outcome, info)

    def _write_locked(self, key: str, kind: str,
                      info: Dict[str, Any]) -> None:
        if self._file is None:
            return
        rec = {"request": key, "event": kind, "t": time.time(), **info}
        self._file.write(json.dumps(rec, sort_keys=True) + "\n")

    def accepted_total(self) -> int:
        with self._lock:
            return self._accepted

    def open_requests(self) -> List[str]:
        """Accepted but not yet settled — MUST be empty once traffic
        quiesces, or a request was lost."""
        with self._lock:
            return sorted(self._open)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


class _EngineTelemetry:
    """Minimal telemetry facade for an engine: the engine reads exactly
    ``.registry`` and ``.tracer`` off whatever it is handed."""

    def __init__(self, registry: MetricsRegistry, tracer: Tracer) -> None:
        self.registry = registry
        self.tracer = tracer


class Replica:
    """One engine behind the router: RoutablePort + lifecycle state."""

    def __init__(self, replica_id: str, engine: InferenceEngine, *,
                 tracer: Optional[Tracer] = None) -> None:
        self.replica_id = replica_id
        self.engine = engine
        self.registry: MetricsRegistry = engine.registry
        self.tracer = tracer
        self.state = STARTING

    # -- RoutablePort ------------------------------------------------------

    def admitting(self) -> bool:
        return self.state == HEALTHY

    def load(self) -> Tuple[int, int]:
        st = self.engine.stats()
        return (st.queue_depth, -st.free_blocks)

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16, *,
               eos_token_id: Optional[int] = None,
               request_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               deadline_t: Optional[float] = None) -> Any:
        return self.engine.submit(prompt, max_new_tokens,
                                  eos_token_id=eos_token_id,
                                  request_id=request_id,
                                  trace_id=trace_id,
                                  deadline_t=deadline_t)

    def prefix_inventory(self) -> Optional[Dict[str, Any]]:
        """Serialized PrefixInventory digest for router affinity (None
        when the engine runs without a prefix cache)."""
        return self.engine.prefix_inventory()

    # -- lifecycle ---------------------------------------------------------

    def drain(self, timeout: float = 60.0) -> float:
        """Stop admission (the router skips non-HEALTHY replicas) and
        wait out every queued and in-flight request. Returns the drain
        wall-time. The replica stays alive — rollout re-admits it."""
        self.state = DRAINING
        t0 = time.monotonic()
        self.engine.wait_idle(timeout)
        return time.monotonic() - t0

    def readmit(self) -> None:
        self.state = HEALTHY

    def close(self, timeout: float = 30.0) -> None:
        self.state = STOPPED
        self.engine.close(timeout)


@dataclasses.dataclass
class FleetStats:
    replicas: int
    healthy: int
    queue_depth: int          # summed over replicas
    free_blocks: int          # summed over replicas
    completed: int            # summed over replicas
    tokens_generated: int     # summed over replicas
    rejected: int             # engine-level 429s (absorbed by the router)
    max_p99_s: float          # worst replica request p99 (NaN when empty)


@dataclasses.dataclass
class RolloutReport:
    """What a blue-green rollout did (docs/serving.md rollout section)."""
    order: List[str]          # replica ids in swap order; [0] is the canary
    probe_output: List[int]   # canary probe tokens under the new params
    drain_s: Dict[str, float]  # per-replica drain wall-time
    duration_s: float


class ServingFleet:
    """N engine replicas + router + drain/rollout orchestration.

    ``iteration_floor_s`` is forwarded to every engine; single-host
    benches set it so per-replica capacity is floor-bound rather than
    bound by the one CPU all replicas share (docs/serving.md). With
    ``warmup`` (the default) each replica captures its program ladder as
    CUDA graphs before it joins the router (on the CPU: runs it once).
    ``params`` must be on ``device``; ``device`` defaults to the card
    and raises without one unless ``"cpu"`` is named.
    """

    def __init__(self, params: gpt.Params, model_cfg: gpt.GPTConfig, *,
                 name: str = "fleet",
                 buckets: Optional[BucketSpec] = None,
                 cache: Optional[KVCacheConfig] = None,
                 max_queue_depth: int = 256,
                 iteration_floor_s: float = 0.0,
                 warmup: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 aggregator: Any = None,
                 prefix_cache: bool = False,
                 kv_store: Any = None,
                 tracing: Optional[bool] = None,
                 archive_dir: Optional[str] = None,
                 slo: Any = None,
                 max_request_crashes: int = 3,
                 chunk_prefill_len: int = 0,
                 device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self.name = name
        # poison-pill strike budget: a request that was RUNNING on this
        # many consecutively-crashing replicas is quarantined instead of
        # requeued a further time
        self.max_request_crashes = max(1, int(max_request_crashes))
        self.model_cfg = model_cfg
        self.buckets = buckets
        self.cache = cache
        self.max_queue_depth = int(max_queue_depth)
        self.iteration_floor_s = float(iteration_floor_s)
        # per-replica COW prefix sharing (each replica owns its pool, so
        # each keeps its own prefix index; the router's least-loaded
        # spread means a hot shared prefix ends up cached everywhere)
        self.prefix_cache = bool(prefix_cache)
        # chunked prefill per replica (the port's addition: prompts longer
        # than the largest prefill bucket become servable)
        self.chunk_prefill_len = int(chunk_prefill_len)
        # fleet-shared KV memory hierarchy (serving/kv_store.py): pass a
        # KVBlockStore (possibly CAS-backed) to share across fleets /
        # restarts, or True for a default host-only tier. Evicted prefix
        # blocks demote into it and admission promotes them back, so
        # replacement replicas warm from the tier instead of
        # re-prefilling shared prefixes.
        if kv_store is True:
            kv_store = KVBlockStore()
        elif not kv_store:  # False / None / 0 all mean "off"
            kv_store = None
        if kv_store is not None and not self.prefix_cache:
            raise ValueError(
                "kv_store requires prefix_cache=True — the tier is keyed "
                "by the prefix cache's chain hashes")
        self.kv_store: Optional[KVBlockStore] = kv_store
        self.warmup = bool(warmup)
        self.registry = registry if registry is not None else MetricsRegistry()
        self.aggregator = aggregator
        # per-request tracing: on by default, DCT_TELEMETRY_DISABLED=1 is
        # the plane-wide off switch (same contract as telemetry_from_config)
        self.tracing = (bool(tracing) if tracing is not None
                        else os.environ.get("DCT_TELEMETRY_DISABLED") != "1")
        archive_dir = archive_dir or (
            os.environ.get("DCT_REQUEST_ARCHIVE_DIR") or None)
        self.archive: Optional[RequestArchive] = None
        if self.tracing and archive_dir:
            self.archive = RequestArchive(archive_dir,
                                          registry=self.registry)
        if isinstance(slo, SLOEngine):
            self.slo: Optional[SLOEngine] = slo
        elif slo is not None:
            self.slo = SLOEngine.from_dict(slo)
        else:
            self.slo = SLOEngine() if self.tracing else None
        self.frontdoor_tracer = self._make_tracer("frontdoor")
        self._router_tracer = self._make_tracer("router")
        self.router = LeastLoadedRouter(self.registry,
                                        tracer=self._router_tracer)
        # the fleet-shared forward
        self._fwd = gpt.forward_paged
        self._params = params
        self._lock = threading.RLock()   # membership + rollout serialization
        self._replicas: Dict[str, Replica] = {}
        self._next_seq = 1
        self._tps_last: Dict[str, Tuple[float, int]] = {}
        self._span_cursor: Dict[str, int] = {}
        self._g_replicas = self.registry.gauge(
            "fleet_replicas", "replicas in the fleet (any state)")
        self._c_rollouts = self.registry.counter(
            "fleet_rollouts_total", "blue-green parameter rollouts completed")
        self._h_drain = self.registry.histogram(
            "fleet_drain_seconds", "per-replica drain wall-time")
        self._h_frontdoor = self.registry.histogram(
            "fleet_frontdoor_seconds",
            "front-door request wall-time (submit → result, incl. routing)")
        self._h_scale_up = self.registry.histogram(
            "fleet_scale_up_seconds",
            "per-replica scale-up wall-time (engine build + warmup)")
        # per-replica scale-up latencies in arrival order — the bench's
        # cold-vs-warm replica-start A/B reads this directly
        self.scale_up_latencies_s: List[float] = []

        # -- self-healing state (docs/serving.md "Self-healing") ----------
        self._c_replacements = self.registry.counter(
            "fleet_replica_replacements_total",
            "failed replicas torn down and replaced")
        self._h_recovery = self.registry.histogram(
            "fleet_recovery_seconds",
            "failure declared → replacement serving (MTTR)")
        self._c_requeued = self.registry.counter(
            "fleet_requests_requeued_total",
            "orphaned requests requeued to a surviving replica")
        self._c_quarantined = self.registry.counter(
            "fleet_requests_quarantined_total",
            "poison-pill requests refused after crashing replicas")
        # the durable journal rides the archive gate: disabled telemetry
        # means zero on-disk work, but the in-memory exactly-once ledger
        # always runs — failover correctness is not an observability
        # feature
        ledger_path = (os.path.join(archive_dir, "ledger.jsonl")
                       if archive_dir and self.tracing else None)
        self.ledger = RequestLedger(ledger_path)
        self._quarantined: Dict[str, Dict[str, Any]] = {}
        self._incidents: List[Dict[str, Any]] = []
        # optional FleetSupervisor, attached by start_supervisor()
        self.supervisor: Any = None

    def _make_tracer(self, process_name: str) -> Optional[Tracer]:
        """One tracer lane of the stitched request trace; None (and zero
        per-request work anywhere downstream) when tracing is off."""
        if not self.tracing:
            return None
        t = Tracer(enabled=True, max_events=_TRACE_EVENTS,
                   process_name=process_name)
        if self.archive is not None:
            t.add_sink(self.archive.sink_for(t))
        return t

    # -- membership --------------------------------------------------------

    def __enter__(self) -> "ServingFleet":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def replica_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def replicas(self) -> List[Replica]:
        with self._lock:
            return [self._replicas[r] for r in sorted(self._replicas)]

    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values()
                       if r.state == HEALTHY)

    def scale_up(self, n: int = 1) -> List[str]:
        """Add ``n`` replicas; each warms up (captures its CUDA graphs
        while the other replicas keep serving), then joins the router."""
        added: List[str] = []
        for _ in range(max(0, int(n))):
            t0 = time.monotonic()
            with self._lock:
                rid = f"{self.name}-{self._next_seq}"
                self._next_seq += 1
            tracer = self._make_tracer(f"serving_replica_{rid}")
            telemetry: Any = MetricsRegistry()
            if tracer is not None:
                telemetry = _EngineTelemetry(telemetry, tracer)
            engine = InferenceEngine(
                self._params, self.model_cfg, buckets=self.buckets,
                cache=self.cache, max_queue_depth=self.max_queue_depth,
                telemetry=telemetry, fwd=self._fwd,
                iteration_floor_s=self.iteration_floor_s,
                prefix_cache=self.prefix_cache,
                chunk_prefill_len=self.chunk_prefill_len,
                kv_store=self.kv_store,
                fault_scope=rid, device=self.device)
            if self.kv_store is not None:
                # affinity keys must hash with the engines' actual block
                # size (the engine derives a default when cache is None),
                # so arm the router off the first built engine
                self.router.prefix_block_size = engine.cache.block_size
            rep = Replica(rid, engine, tracer=tracer)
            if self.warmup:
                engine.warmup()
            rep.state = HEALTHY
            with self._lock:
                self._replicas[rid] = rep
                self._g_replicas.set(len(self._replicas))
            self.router.add(rep)
            added.append(rid)
            dt = time.monotonic() - t0
            self._h_scale_up.observe(dt)
            with self._lock:
                self.scale_up_latencies_s.append(dt)
        return added

    def stop_replica(self, replica_id: str, timeout: float = 60.0) -> float:
        """Drain-protected removal of one replica: stop admission,
        finish in-flight work, release its blocks, then tear the engine
        down. Returns the drain wall-time. This is the only way a
        replica leaves the fleet — scale-down, autoscaler shrink, and
        MasterLink kill commands all land here."""
        with self._lock:
            rep = self._replicas.get(replica_id)
        if rep is None:
            raise KeyError(f"no replica {replica_id!r}")
        drain_s = rep.drain(timeout)
        self._h_drain.observe(drain_s)
        self.router.remove(replica_id)
        self._flush_kv(rep)
        rep.close()
        with self._lock:
            self._replicas.pop(replica_id, None)
            self._tps_last.pop(replica_id, None)
            self._span_cursor.pop(f"serving_replica_{replica_id}", None)
            self._g_replicas.set(len(self._replicas))
        return drain_s

    def replace_replica(self, replica_id: str, *, reason: str = "failed",
                        replacement: bool = True,
                        close_timeout: float = 30.0) -> List[str]:
        """Tear down a FAILED replica and bring up a fresh one — the
        self-healing counterpart of :meth:`stop_replica`, which drains
        politely and assumes the engine still works. Here the engine is
        dead or wedged: it is condemned (in-flight requests fail with
        ReplicaFailed so the front door requeues them), unrouted,
        closed, and replaced by a fresh replica (which warms its own
        graphs, and its prefixes from the KV tiers). MTTR lands in
        ``fleet_recovery_seconds``; the incident is recorded for
        ``dct fleet status``. Returns the replacement ids."""
        faults.point("fleet.replace")
        t0 = time.monotonic()
        with self._lock:
            rep = self._replicas.get(replica_id)
        if rep is None:
            return []
        rep.state = STOPPED
        self.router.remove(replica_id)
        # best-effort demotion of the condemned replica's resident prefix
        # blocks into the shared tier, BEFORE condemnation marks it dead.
        # Gated on a liveness snapshot: flushing a wedged engine would
        # wait out its stuck device call and stall the MTTR this method
        # exists to bound — a dead/wedged/busy replica degrades to a cold
        # teardown (the tier already holds whatever it evicted).
        live = rep.engine.liveness()
        if (live["thread_alive"] and live["fatal"] is None
                and not live["pending"]):
            self._flush_kv(rep)
        failed_n = rep.engine.fail_inflight(reason)
        rep.close(close_timeout)
        # after a clean join the crash teardown has run: anything still
        # held is a real leak, worth its own line in the incident
        leaked = rep.engine.kv_outstanding()
        with self._lock:
            self._replicas.pop(replica_id, None)
            self._tps_last.pop(replica_id, None)
            self._span_cursor.pop(f"serving_replica_{replica_id}", None)
            self._g_replicas.set(len(self._replicas))
        added = self.scale_up(1) if replacement else []
        dt = time.monotonic() - t0
        self._c_replacements.inc()
        self._h_recovery.observe(dt)
        self.note_incident({
            "replica": replica_id,
            "reason": str(reason),
            "failed_requests": failed_n,
            "leaked_blocks": leaked,
            "replacement": added,
            "recovery_s": round(dt, 6),
        })
        return added

    def _flush_kv(self, rep: Replica) -> int:
        """Demote a replica's resident prefix blocks into the shared KV
        tier before teardown (rollout / stop / replace), so the prefixes
        it was hot on survive the replica. Best-effort: a dead or wedged
        engine degrades to a cold teardown."""
        if self.kv_store is None:
            return 0
        try:
            return rep.engine.flush_kv_to_tier()
        except Exception:  # noqa: BLE001 — flushing a dying engine
            return 0

    def note_incident(self, incident: Dict[str, Any]) -> None:
        with self._lock:
            self._incidents.append(dict(incident))
            del self._incidents[:-32]  # bounded history

    def incidents(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(i) for i in self._incidents]

    def last_incident(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._incidents[-1]) if self._incidents else None

    def start_supervisor(self, **kw: Any) -> Any:
        """Attach a FleetSupervisor probing this fleet (serving/
        supervisor.py); stopped automatically by :meth:`close`."""
        from determined_clone_tpu_torch.serving.supervisor import (
            FleetSupervisor,
        )

        if self.supervisor is not None:
            raise RuntimeError("supervisor already running")
        self.supervisor = FleetSupervisor(self, **kw)
        return self.supervisor

    def scale_down(self, n: int = 1, timeout: float = 60.0) -> List[str]:
        """Remove the ``n`` newest replicas through the drain protocol
        (newest-first mirrors the master's shrink policy)."""
        with self._lock:
            victims = sorted(
                (r for r in self._replicas.values() if r.state != STOPPED),
                key=lambda rep: rep.replica_id, reverse=True)[:max(0, int(n))]
        removed = []
        for rep in victims:
            self.stop_replica(rep.replica_id, timeout)
            removed.append(rep.replica_id)
        return removed

    def scale_to(self, n: int, timeout: float = 60.0) -> None:
        cur = len(self.replica_ids())
        if n > cur:
            self.scale_up(n - cur)
        elif n < cur:
            self.scale_down(cur - n, timeout)

    def close(self, timeout: float = 30.0) -> None:
        """Tear the fleet down, draining politely first (bounded)."""
        if self.supervisor is not None:
            self.supervisor.close()
            self.supervisor = None
        for rid in sorted(self._replicas, reverse=True):
            rep = self._replicas.get(rid)
            if rep is None:
                continue
            try:
                rep.drain(timeout)
            except (TimeoutError, RuntimeError):
                pass  # tearing down anyway; close() joins the thread
            self.router.remove(rid)
            self._flush_kv(rep)
            rep.close()
        with self._lock:
            self._replicas.clear()
            self._g_replicas.set(0)
        if self.archive is not None:
            self.archive.close()
        self.ledger.close()

    # -- traffic -----------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16, *,
               eos_token_id: Optional[int] = None,
               request_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               timeout: Optional[float] = None,
               deadline_t: Optional[float] = None) -> Any:
        """Route one request to the least-loaded healthy replica."""
        return self.router.submit(prompt, max_new_tokens,
                                  eos_token_id=eos_token_id,
                                  request_id=request_id, trace_id=trace_id,
                                  timeout=timeout, deadline_t=deadline_t)

    def mint_ids(self, request_id: Optional[str] = None,
                 trace_id: Optional[str] = None
                 ) -> Tuple[Optional[str], Optional[str]]:
        """Front-door identity: keep caller-supplied ids, mint the rest.
        With tracing off both stay as given (possibly None) — the engine
        falls back to its cheap ``req-<seq>`` ids and no uuid is paid."""
        if not self.tracing:
            return request_id, trace_id
        rid = request_id or f"req-{uuid.uuid4().hex[:12]}"
        tid = trace_id or f"trace-{uuid.uuid4().hex[:16]}"
        return rid, tid

    def handle_request(self, prompt: Sequence[int],
                       max_new_tokens: int = 16, *,
                       eos_token_id: Optional[int] = None,
                       request_id: Optional[str] = None,
                       trace_id: Optional[str] = None,
                       timeout: float = 120.0,
                       deadline_s: Optional[float] = None) -> Tuple[Any, Any]:
        """Full front-door lifecycle for one request: mint the trace
        identity, enter the accepted-request ledger, dispatch through
        the router, block for the result, and account the outcome
        (front-door span, SLO ingest, archive retention decision).
        Returns ``(result, handle)``; raises exactly what :meth:`submit`
        / ``handle.result`` raise, after accounting the failure. The
        HTTP front door and in-process callers share this path so traces
        look identical either way.

        Failover is exactly-once from the client's view: a request
        orphaned by a replica crash (:class:`ReplicaFailed`) is requeued
        to a surviving replica — safe because greedy decode is
        deterministic, so the re-run emits bit-identical tokens — until
        it either completes, expires, or crashes
        ``max_request_crashes`` replicas in a row and is quarantined as
        a poison pill. ``deadline_s`` (relative seconds) propagates
        router → engine: an already-expired request never touches a
        replica (TimeoutError → HTTP 504), and mid-decode expiry aborts
        the work and frees its KV blocks."""
        rid, tid = self.mint_ids(request_id, trace_id)
        key = _request_key(rid, prompt, max_new_tokens)
        with self._lock:
            poison = self._quarantined.get(key)
        if poison is not None:
            raise PoisonPillRequest(
                f"request {key!r} is quarantined as a poison pill",
                diagnostics=poison)
        deadline_t = (time.monotonic() + float(deadline_s)
                      if deadline_s is not None else None)
        ft = self.frontdoor_tracer
        t0 = time.perf_counter()
        self.ledger.accept(key, prompt_len=len(prompt),
                           max_new_tokens=int(max_new_tokens))
        try:
            crashes = 0
            while True:
                if deadline_t is not None \
                        and time.monotonic() >= deadline_t:
                    raise TimeoutError(
                        f"request {key!r} expired before dispatch")
                handle = self.submit(prompt, max_new_tokens,
                                     eos_token_id=eos_token_id,
                                     request_id=rid, trace_id=tid,
                                     timeout=timeout,
                                     deadline_t=deadline_t)
                try:
                    result = handle.result(timeout=timeout)
                except ReplicaFailed as exc:
                    was_active = bool(getattr(exc, "active", False))
                    if was_active:
                        crashes += 1
                    self.ledger.event(
                        key, "orphaned", active=was_active,
                        replica=getattr(handle, "replica_id", ""))
                    if crashes >= self.max_request_crashes:
                        diag = {
                            "request_id": rid or key,
                            "crashes": crashes,
                            "last_replica": getattr(
                                handle, "replica_id", ""),
                            "last_error": str(exc),
                        }
                        with self._lock:
                            self._quarantined[key] = diag
                        self._c_quarantined.inc()
                        self.ledger.settle(key, "quarantined", **diag)
                        raise PoisonPillRequest(
                            f"request {rid or key!r} crashed {crashes} "
                            f"replicas in a row — quarantined, not "
                            f"requeued a {crashes + 1}th time",
                            diagnostics=diag) from exc
                    faults.point("fleet.requeue")
                    self._c_requeued.inc()
                    continue
                if result.finish_reason == "expired":
                    # surfaced as the same 504 an expired-before-dispatch
                    # request gets; its blocks were freed by the engine
                    raise TimeoutError(
                        f"request {key!r} deadline expired after "
                        f"{len(result.tokens)} tokens")
                break
        except Exception as exc:
            dt = time.perf_counter() - t0
            if ft is not None:
                ft.record_span("frontdoor_request", t0, dt,
                               request_id=rid, trace_id=tid,
                               error=type(exc).__name__)
            self.note_request(rid, ok=False, latency_s=None,
                              error=str(exc))
            # idempotent: the quarantine path settled its own outcome
            self.ledger.settle(key, "failed", error=type(exc).__name__)
            raise
        dt = time.perf_counter() - t0
        if ft is not None:
            ft.record_span(
                "frontdoor_request", t0, dt, request_id=rid, trace_id=tid,
                replica=getattr(handle, "replica_id", ""),
                tokens=len(result.tokens))
            self._h_frontdoor.observe(dt, exemplar=rid)
        else:
            self._h_frontdoor.observe(dt)
        self.note_request(rid, ok=True, latency_s=dt)
        self.ledger.settle(key, "completed", tokens=len(result.tokens))
        return result, handle

    def note_request(self, request_id: Optional[str], *, ok: bool = True,
                     latency_s: Optional[float] = None,
                     error: Optional[str] = None) -> Optional[str]:
        """Account one finished front-door request: SLO ingest plus the
        archive's keep/drop decision for its span bundle. Returns the
        archive retention reason (None = dropped or no archive)."""
        if self.slo is not None:
            self.slo.record_request(ok=ok, latency_s=latency_s)
        if self.archive is not None and request_id:
            return self.archive.note_result(
                request_id, ok=ok, latency_s=latency_s, error=error)
        return None

    # -- blue-green rollout ------------------------------------------------

    def rollout(self, new_params: gpt.Params, *,
                probe_prompt: Sequence[int] = (1, 2, 3),
                probe_tokens: int = 8,
                drain_timeout: float = 120.0) -> RolloutReport:
        """Install ``new_params`` fleet-wide, blue-green style.

        Replica by replica (lowest id first — the canary): stop its
        admission, drain it, queue the swap, then prove it with a probe
        request (the probe's prefill crosses the iteration boundary, so
        it runs — and its output is produced — entirely under the new
        params). Only after the canary's probe succeeds does the rest of
        the fleet swap; every later replica's probe must match the
        canary bit-for-bit (greedy decoding is deterministic, so any
        divergence means the swap installed different bytes). Because a
        drained replica has no in-flight sequences, no request ever
        spans a parameter change: every response is exactly old-version
        or exactly new-version tokens, which is what lets the rollout
        tests assert bit-identical outputs under load.
        """
        t0 = time.monotonic()
        with self._lock:
            order = sorted(self._replicas)
            reps = [self._replicas[r] for r in order]
        if not reps:
            raise RuntimeError("rollout on an empty fleet")
        probe_output: List[int] = []
        drain_s: Dict[str, float] = {}
        for i, rep in enumerate(reps):
            drain_s[rep.replica_id] = rep.drain(drain_timeout)
            self._h_drain.observe(drain_s[rep.replica_id])
            # demote resident blocks under the OLD fingerprint before the
            # swap flushes the prefix cache — a rollback warms from tier
            self._flush_kv(rep)
            rep.engine.hot_swap(new_params)
            out = rep.submit(tuple(probe_prompt), probe_tokens).result(
                drain_timeout).tokens
            if i == 0:
                probe_output = out
            elif out != probe_output:
                raise RuntimeError(
                    f"rollout parity violation: replica {rep.replica_id} "
                    f"probe {out} != canary {probe_output}")
            rep.readmit()
        with self._lock:
            self._params = new_params
        self._c_rollouts.inc()
        return RolloutReport(order=order, probe_output=probe_output,
                             drain_s=drain_s,
                             duration_s=time.monotonic() - t0)

    def rollout_from_storage(self, storage: Any, storage_id: str, *,
                             base_tmp: Optional[str] = None,
                             ckpt_subdir: str = "",
                             **kw: Any) -> RolloutReport:
        """Blue-green rollout of a stored checkpoint: the pytree is
        fetched and deserialized ONCE and the same tensors are
        hot-swapped into every replica — one fetch for N replicas, unlike
        per-engine ``hot_load``."""
        from determined_clone_tpu_torch.core._serialization import (
            load_pytree,
        )

        t0 = time.monotonic()
        with storage.restore_path(storage_id, base_tmp) as d:
            src = os.path.join(d, ckpt_subdir) if ckpt_subdir else d
            new_params = load_pytree(src, like=self._params)
        self.registry.histogram(
            "fleet_rollout_load_seconds",
            "checkpoint fetch + deserialize (once per rollout)"
        ).observe(time.monotonic() - t0)
        return self.rollout(new_params, **kw)

    # -- telemetry ---------------------------------------------------------

    def kv_stats(self) -> Optional[Dict[str, Any]]:
        """Shared KV-tier accounting (None when the hierarchy is off):
        the host store's entries/bytes/hit-rate plus nested CAS stats."""
        return self.kv_store.stats() if self.kv_store is not None else None

    def stats(self) -> FleetStats:
        reps = self.replicas()
        qd = fb = done = toks = rej = 0
        healthy = 0
        max_p99 = float("nan")
        for rep in reps:
            st = rep.engine.stats()
            qd += st.queue_depth
            fb += st.free_blocks
            done += st.completed
            toks += st.tokens_generated
            rej += st.rejected
            healthy += 1 if rep.state == HEALTHY else 0
            p99 = rep.registry.histogram(
                "serving_request_total_seconds",
                "submit → last token").percentile(99)
            if p99 == p99 and not (max_p99 == max_p99 and max_p99 >= p99):
                max_p99 = p99
        return FleetStats(replicas=len(reps), healthy=healthy,
                          queue_depth=qd, free_blocks=fb, completed=done,
                          tokens_generated=toks, rejected=rej,
                          max_p99_s=max_p99)

    def health_view(self) -> Dict[str, Any]:
        """Replica health + last-incident summary for ``/v1/fleet`` and
        ``dct fleet status``: per replica the lifecycle state, router
        breaker state, scheduler heartbeat age, and whether it died."""
        states = self.router.replica_states()
        reps: List[Dict[str, Any]] = []
        for rep in self.replicas():
            live = rep.engine.liveness()
            reps.append({
                "id": rep.replica_id,
                "state": rep.state,
                "breaker": states.get(rep.replica_id, "closed"),
                "beat_age_s": round(live["beat_age_s"], 3),
                "pending": live["pending"],
                "fatal": (repr(live["fatal"])
                          if live["fatal"] is not None else None),
            })
        with self._lock:
            quarantined = len(self._quarantined)
        return {
            "replicas": reps,
            "last_incident": self.last_incident(),
            "incidents": len(self.incidents()),
            "quarantined_requests": quarantined,
            "open_requests": len(self.ledger.open_requests()),
            "supervised": self.supervisor is not None,
        }

    def sample_telemetry(self) -> None:
        """Stamp per-replica ``serving_tokens_per_sec`` (from the token
        counter delta since the last sample) and feed every replica
        registry to the aggregator as ``component=serving_replica_<id>``
        — distinct component names, because ingest is latest-wins per
        component and identical names would clobber each other. The
        aggregator's serving rollup prefix-matches ``serving_replica``
        (telemetry/aggregate.py). With tracing on, also drains every
        tracer lane's new span records into the aggregator (so ``dct
        trace export`` stitches the fleet) and lands the SLO evaluation
        as ``dct_slo_*`` gauges in the fleet registry."""
        now = time.monotonic()
        for rep in self.replicas():
            st = rep.engine.stats()
            last = self._tps_last.get(rep.replica_id)
            tps = 0.0
            if last is not None and now > last[0]:
                tps = (st.tokens_generated - last[1]) / (now - last[0])
            self._tps_last[rep.replica_id] = (now, st.tokens_generated)
            rep.registry.gauge(
                "serving_tokens_per_sec",
                "decoded tokens per second since the last sample").set(tps)
            if self.aggregator is not None:
                self.aggregator.ingest_component(
                    f"serving_replica_{rep.replica_id}", rep.registry)
                self._ship_spans(
                    f"serving_replica_{rep.replica_id}", rep.tracer)
        if self.aggregator is not None:
            self._ship_spans("frontdoor", self.frontdoor_tracer)
            self._ship_spans("router", self._router_tracer)
        if self.slo is not None:
            self.slo.publish(self.registry)

    def _ship_spans(self, component: str,
                    tracer: Optional[Tracer]) -> None:
        """Drain one tracer lane's finished spans since the last sample
        into the aggregator, annotated with the clock anchor + process
        name ``stitch_chrome_trace`` needs (same identity contract as
        Telemetry.publish)."""
        if tracer is None or self.aggregator is None:
            return
        ship = getattr(self.aggregator, "ingest_component_spans", None)
        if ship is None:
            return
        with self._lock:
            cursor = self._span_cursor.get(component, 0)
        new, cursor = tracer.drain_since(cursor)
        with self._lock:
            self._span_cursor[component] = cursor
        if new:
            ident = {"wall_epoch": tracer.wall_epoch,
                     "process": tracer.process_name or component}
            ship(component, [{**ident, **rec} for rec in new])


# ---------------------------------------------------------------------------
# Master integration: the agent half of the `serving` allocation type.
# ---------------------------------------------------------------------------


def _master_req(port: int, method: str, path: str,
                body: Optional[dict] = None, timeout: float = 5.0) -> Any:
    """Minimal master client, same dialect as tools/loadgen.py (the
    master runs authless by default; rbac gates pass when auth is off)."""
    url = f"http://127.0.0.1:{port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        payload = resp.read()
    return json.loads(payload) if payload else {}


class MasterLink:
    """Runs a ServingFleet as the master's serving gang allocations.

    Registers as an agent (``fleet-<name>``), creates the fleet record
    via ``POST /api/v1/serving/fleets``, then heartbeats on a ``fleet-
    link`` thread. The master derives the commands: ``start`` commands
    (``task_type == "serving"``) spawn a replica and confirm it with a
    ``running`` task_event; ``kill`` commands (scale-down, fleet kill)
    run the drain protocol on a ``fleet-drain-<alloc>`` thread and
    report ``exited`` only once the replica's last request finished and
    its blocks are freed — the drain-protected slot reclaim the master's
    shrink comment promises.
    """

    def __init__(self, fleet: ServingFleet, master_port: int, *,
                 replicas: int = 1, resource_pool: str = "default",
                 slots_per_replica: int = 1, agent_slots: int = 16,
                 poll_s: float = 0.05, drain_timeout: float = 60.0) -> None:
        self.fleet = fleet
        self.port = int(master_port)
        self.poll_s = float(poll_s)
        self.drain_timeout = float(drain_timeout)
        self.agent_id = f"fleet-{fleet.name}"
        self._lock = threading.Lock()
        self._alloc_replica: Dict[str, str] = {}   # alloc id → replica id
        self._exited: List[str] = []               # drained, to report
        self._draining: Dict[str, threading.Thread] = {}
        self._stop = threading.Event()
        _master_req(self.port, "POST", "/api/v1/agents/register", {
            "id": self.agent_id, "slots": int(agent_slots),
            "topology": f"fleet-{agent_slots}", "address": "127.0.0.1:0",
            "resource_pool": resource_pool})
        _master_req(self.port, "POST", "/api/v1/serving/fleets", {
            "name": fleet.name, "replicas": int(replicas),
            "resource_pool": resource_pool,
            "slots_per_replica": int(slots_per_replica)})
        self._thread = threading.Thread(target=self._run, name="fleet-link",
                                        daemon=True)
        self._thread.start()

    # -- master-facing actions --------------------------------------------

    def scale(self, replicas: int) -> None:
        """Ask the master for a new replica count; the heartbeat loop
        applies the derived start/kill commands."""
        _master_req(self.port, "POST",
                    f"/api/v1/serving/fleets/{self.fleet.name}/scale",
                    {"replicas": int(replicas)})

    def fleet_status(self) -> Dict[str, Any]:
        return _master_req(
            self.port, "GET",
            f"/api/v1/serving/fleets/{self.fleet.name}")["fleet"]

    # -- agent loop --------------------------------------------------------

    def _heartbeat(self) -> List[Dict[str, Any]]:
        with self._lock:
            exited_ids = list(self._exited)
            # draining allocs still report running — the replica process
            # is alive until its last request finishes; the master just
            # re-derives the (idempotently skipped) kill meanwhile
            running = list(self._alloc_replica)
        body = {"exited": [{"allocation_id": a, "exit_code": 0}
                           for a in exited_ids],
                "running": running}
        resp = _master_req(
            self.port, "POST",
            f"/api/v1/agents/{self.agent_id}/heartbeat", body)
        with self._lock:
            # only forget exit reports the master actually received
            self._exited = [a for a in self._exited if a not in exited_ids]
        return resp.get("commands", [])

    def _start_replica(self, alloc_id: str) -> None:
        rid = self.fleet.scale_up(1)[0]
        with self._lock:
            self._alloc_replica[alloc_id] = rid
        _master_req(self.port, "POST",
                    f"/api/v1/agents/{self.agent_id}/task_event",
                    {"allocation_id": alloc_id, "event": "running"})

    def _drain_replica(self, alloc_id: str) -> None:
        """fleet-drain-* thread body: drain protocol, then queue the
        exit report for the next heartbeat."""
        with self._lock:
            rid = self._alloc_replica.get(alloc_id)
        try:
            if rid is not None and rid in self.fleet.replica_ids():
                self.fleet.stop_replica(rid, self.drain_timeout)
        except (TimeoutError, RuntimeError, KeyError):
            pass  # report the exit regardless; the engine is going away
        with self._lock:
            self._alloc_replica.pop(alloc_id, None)
            self._exited.append(alloc_id)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                commands = self._heartbeat()
            except (urllib.error.URLError, OSError, ValueError):
                if self._stop.wait(self.poll_s * 4):
                    return
                continue
            for cmd in commands:
                ctype = cmd.get("type")
                alloc_id = cmd.get("allocation_id", "")
                if (ctype == "start"
                        and cmd.get("task_type") == "serving"
                        and cmd.get("fleet") == self.fleet.name):
                    try:
                        self._start_replica(alloc_id)
                    except (urllib.error.URLError, OSError):
                        pass  # running event retried via next derive
                elif ctype == "kill" and alloc_id in self._alloc_replica:
                    with self._lock:
                        if alloc_id in self._draining:
                            continue
                        t = threading.Thread(
                            target=self._drain_replica, args=(alloc_id,),
                            name=f"fleet-drain-{alloc_id}", daemon=True)
                        self._draining[alloc_id] = t
                    t.start()
            with self._lock:
                done = [a for a, t in self._draining.items()
                        if not t.is_alive()]
                for a in done:
                    self._draining.pop(a)
            if self._stop.wait(self.poll_s):
                return

    def wait_replicas(self, n: int, timeout: float = 30.0) -> None:
        """Block until the local fleet has ``n`` replicas admitted."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.fleet.healthy_count() >= n:
                return
            time.sleep(0.02)
        raise TimeoutError(
            f"fleet {self.fleet.name!r} has {self.fleet.healthy_count()} "
            f"healthy replicas after {timeout}s, wanted {n}")

    def close(self, *, kill_fleet: bool = False, timeout: float = 30.0
              ) -> None:
        """Stop heartbeating (optionally killing the master-side fleet
        first so slots free) and join the drain threads."""
        if kill_fleet:
            try:
                _master_req(
                    self.port, "POST",
                    f"/api/v1/serving/fleets/{self.fleet.name}/kill", {})
                deadline = time.monotonic() + timeout
                while time.monotonic() < deadline:
                    with self._lock:
                        idle = not self._alloc_replica and not self._exited
                    if idle:
                        break
                    time.sleep(self.poll_s)
            except (urllib.error.URLError, OSError):
                pass
        self._stop.set()
        self._thread.join(timeout)
        with self._lock:
            drains = list(self._draining.values())
        for t in drains:
            t.join(timeout)


if __name__ == "__main__":  # pragma: no cover - the master's spec argv
    raise SystemExit(
        "determined_clone_tpu_torch.serving.fleet is a library; start a "
        "fleet with `dct fleet up` (the port's: `python -m "
        "determined_clone_tpu_torch.cli fleet up`; see docs/serving.md)")
