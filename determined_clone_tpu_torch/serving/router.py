"""Least-loaded request routing over a fleet of serving replicas — the
port's copy of ``determined_clone_tpu/serving/router.py``.

The front door of the serving fleet (fleet.py): every request is
dispatched to the healthy replica with the smallest admission queue,
using exactly the gauges each engine already exports (queue depth as the
primary key, free KV blocks as the tie-break — a replica with a short
queue but an exhausted pool will stall newcomers in admission, so the
pool is load too). This is the standard continuous-batching fleet
policy: iteration-level schedulers keep per-replica latency flat until
the queue grows, so queue depth is the earliest and cheapest congestion
signal.

Failover (the 429 story): when a replica rejects with
:class:`ServerOverloaded` — its HTTP face is a 429 — or a remote replica
drops the connection, the router *re-dispatches* to the next-least-
loaded replica and temporarily excludes the failing one from selection.
The client sees one submit call; the retry storm the naive design
produces (every client independently hammering the one overloaded
replica under its own backoff loop) never happens because the exclusion
is shared router state. Only when EVERY replica is excluded or draining
does the router itself back off, riding the repo-standard
:class:`RetryPolicy` (utils/retry.py) with full jitter. Every
re-dispatch is counted in ``router_redispatch_total{reason=...}``.

Exclusion is a per-replica **circuit breaker**, not a fixed cooldown: a
replica that keeps failing would otherwise get a slice of live traffic
every cooldown expiry forever. The first failure opens the breaker for
``exclude_cooldown_s``; each consecutive failure doubles the window (up
to ``exclude_max_s``). When the window lapses the breaker goes
**half-open** and admits exactly ONE probe request — concurrent picks
skip the replica until the probe resolves. Probe success closes the
breaker (backoff forgotten); probe failure re-opens it with the next
doubling. State is exported as ``router_replica_state{replica}``
(0=closed, 1=half-open, 2=open).

Replicas are anything implementing the small :class:`RoutablePort`
surface; fleet.py's ``Replica`` is the real one, tests use fakes.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from determined_clone_tpu_torch.serving.engine import (
    ReplicaFailed,
    ServerOverloaded,
)
from determined_clone_tpu_torch.serving.kv_store import (
    PrefixInventory,
    prompt_chain_keys,
)
from determined_clone_tpu_torch.telemetry.metrics import MetricsRegistry
from determined_clone_tpu_torch.utils.retry import RetryPolicy, retry_call


class NoHealthyReplica(RuntimeError):
    """Every replica is excluded, draining, or gone. Retryable — the
    router's own dispatch loop backs off on it (ROUTER_RETRY)."""


ROUTER_RETRY = RetryPolicy(
    name="router_dispatch", max_attempts=8, base_delay_s=0.05,
    multiplier=2.0, max_delay_s=1.0, retryable=(NoHealthyReplica,))

#: Exceptions that mean "this replica, right now" rather than "this
#: request is malformed": the router excludes the replica and re-
#: dispatches instead of surfacing them to the client.
_FAILOVER_ERRORS = (ServerOverloaded, ReplicaFailed, ConnectionError,
                    TimeoutError, OSError)

# router_replica_state gauge values
_STATE_CLOSED, _STATE_HALF_OPEN, _STATE_OPEN = 0, 1, 2


@dataclasses.dataclass
class _Breaker:
    """Per-replica circuit-breaker record. Exists only while the replica
    has unforgiven failures — a closed breaker is the absence of one."""
    failures: int = 0
    open_until: float = 0.0
    probing: bool = False  # the half-open single probe is in flight

    def state(self, now: float) -> str:
        if now < self.open_until:
            return "open"
        return "half_open"


class RoutablePort:
    """What the router needs from a replica. fleet.Replica implements
    this over an in-process engine; a remote replica port would
    implement it over HTTP (submit → POST /v1/generate, load → the
    scraped gauges)."""

    replica_id: str

    def admitting(self) -> bool:
        """False while draining/starting/stopped — never routed to."""
        raise NotImplementedError

    def load(self) -> tuple:
        """(queue_depth, -free_blocks): ascending == least loaded."""
        raise NotImplementedError

    def submit(self, prompt: Sequence[int], max_new_tokens: int, *,
               eos_token_id: Optional[int] = None,
               request_id: Optional[str] = None, **kwargs: Any) -> Any:
        """Engine-style submit: returns a handle with .result(timeout),
        raises ServerOverloaded on a full queue. A ``trace_id`` kwarg is
        forwarded only when the caller minted one, so minimal ports need
        not accept it."""
        raise NotImplementedError

    def prefix_inventory(self) -> Optional[Dict[str, Any]]:
        """Optional: serialized :class:`~determined_clone_tpu_torch.serving.
        kv_store.PrefixInventory` of the chain keys this replica can
        serve without re-prefilling (resident prefix cache + its KV
        tiers). None — the default — opts the replica out of
        prefix-affinity routing."""
        return None


class LeastLoadedRouter:
    """Thread-safe least-queue-depth dispatcher with circuit-breaker
    failover.

    ``exclude_cooldown_s`` is the breaker's BASE exclusion window (one
    failure opens it for exactly that long — the pre-breaker behavior);
    consecutive failures double it up to ``exclude_max_s``, and a lapsed
    window admits a single half-open probe before closing. The clock is
    injectable for deterministic tests.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 exclude_cooldown_s: float = 0.5,
                 exclude_max_s: float = 30.0,
                 policy: RetryPolicy = ROUTER_RETRY,
                 clock: Any = time.monotonic,
                 tracer: Any = None,
                 prefix_block_size: int = 0,
                 affinity_max_blocks: int = 8,
                 affinity_queue_slack: int = 2) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self.exclude_cooldown_s = float(exclude_cooldown_s)
        self.exclude_max_s = float(exclude_max_s)
        self.policy = policy
        self._clock = clock
        # -- prefix-affinity pre-filter (serving/kv_store.py) ------------
        # prefix_block_size > 0 (the fleet passes its KV block size)
        # turns it on: pick() hashes the prompt's first
        # ``affinity_max_blocks`` full blocks and prefers the replica
        # whose advertised inventory covers the deepest prefix — but
        # only among replicas within ``affinity_queue_slack`` requests
        # of the shortest queue, so affinity is a tie-shaper and never
        # overrides overload (the least-loaded contract stands).
        self.prefix_block_size = int(prefix_block_size)
        self.affinity_max_blocks = int(affinity_max_blocks)
        self.affinity_queue_slack = int(affinity_queue_slack)
        # per-request tracing lane ("router" process in the stitched
        # trace): dispatch decisions + every failover hop; None = off
        self._tracer = (tracer if tracer is not None
                        and getattr(tracer, "enabled", False) else None)
        self._lock = threading.Lock()
        self._replicas: Dict[str, RoutablePort] = {}
        self._breakers: Dict[str, _Breaker] = {}
        self._c_dispatch = self.registry.counter(
            "router_requests_total", "requests dispatched through the router")
        self._redispatch: Dict[str, Any] = {}
        self._dispatch_by_replica: Dict[str, Any] = {}
        self._state_by_replica: Dict[str, Any] = {}
        self._g_replicas = self.registry.gauge(
            "router_replicas", "replicas registered with the router")
        self._g_healthy = self.registry.gauge(
            "router_healthy_replicas",
            "replicas admitting and not excluded")
        self._g_excluded = self.registry.gauge(
            "router_excluded_replicas",
            "replicas currently in exclusion cooldown")
        self._c_affinity = self.registry.counter(
            "router_affinity_picks_total",
            "picks steered to a replica by prefix-inventory coverage")

    # -- membership (fleet-managed) ---------------------------------------

    def add(self, replica: RoutablePort) -> None:
        with self._lock:
            self._replicas[replica.replica_id] = replica
            self._g_replicas.set(len(self._replicas))

    def remove(self, replica_id: str) -> None:
        with self._lock:
            self._replicas.pop(replica_id, None)
            self._breakers.pop(replica_id, None)
            self._g_replicas.set(len(self._replicas))
            self._state_gauge_locked(replica_id).set(_STATE_CLOSED)

    def replica_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    # -- selection ---------------------------------------------------------

    def _redispatch_counter(self, reason: str) -> Any:
        c = self._redispatch.get(reason)
        if c is None:
            c = self.registry.counter(
                "router_redispatch_total",
                "dispatches retried on another replica",
                labels={"reason": reason})
            self._redispatch[reason] = c
        return c

    def _dispatch_counter(self, replica_id: str) -> Any:
        c = self._dispatch_by_replica.get(replica_id)
        if c is None:
            c = self.registry.counter(
                "router_dispatch_total",
                "successful dispatches per replica",
                labels={"replica": replica_id})
            self._dispatch_by_replica[replica_id] = c
        return c

    def _state_gauge_locked(self, replica_id: str) -> Any:
        g = self._state_by_replica.get(replica_id)
        if g is None:
            g = self.registry.gauge(
                "router_replica_state",
                "circuit-breaker state (0=closed, 1=half-open, 2=open)",
                labels={"replica": replica_id})
            self._state_by_replica[replica_id] = g
        return g

    def _set_excluded_locked(self, now: float) -> None:
        self._g_excluded.set(
            sum(1 for b in self._breakers.values() if now < b.open_until))

    def excluded(self) -> List[str]:
        """Replica ids whose breaker is open (observability). Half-open
        replicas are NOT excluded — they are probe-eligible."""
        now = self._clock()
        with self._lock:
            out = sorted(r for r, b in self._breakers.items()
                         if now < b.open_until)
            self._set_excluded_locked(now)
        return out

    def replica_states(self) -> Dict[str, str]:
        """Breaker state per registered replica:
        "closed" | "half_open" | "open"."""
        now = self._clock()
        with self._lock:
            return {rid: (self._breakers[rid].state(now)
                          if rid in self._breakers else "closed")
                    for rid in self._replicas}

    def _exclude(self, replica_id: str, reason: str) -> None:
        """One more failure: open (or re-open) the breaker with the
        next exponential window."""
        with self._lock:
            now = self._clock()
            br = self._breakers.get(replica_id)
            if br is None:
                br = self._breakers[replica_id] = _Breaker()
            br.failures += 1
            window = min(self.exclude_max_s,
                         self.exclude_cooldown_s
                         * (2.0 ** (br.failures - 1)))
            br.open_until = now + window
            br.probing = False
            self._set_excluded_locked(now)
            self._state_gauge_locked(replica_id).set(_STATE_OPEN)
        self._redispatch_counter(reason).inc()

    def _note_success(self, replica_id: str) -> None:
        """A dispatch landed: close the breaker, forgetting the backoff
        history (the probe proved the replica back)."""
        with self._lock:
            if self._breakers.pop(replica_id, None) is not None:
                self._state_gauge_locked(replica_id).set(_STATE_CLOSED)

    def _probe_release(self, replica_id: str) -> None:
        """The half-open probe resolved without saying anything about
        replica health (e.g. the request was malformed): re-arm the
        probe slot without touching the failure count."""
        with self._lock:
            br = self._breakers.get(replica_id)
            if br is not None:
                br.probing = False

    def pick(self, skip: Sequence[str] = (),
             prompt: Optional[Sequence[int]] = None
             ) -> Optional[RoutablePort]:
        """Least-loaded healthy replica, or None. Ties break on free
        blocks (more is better), then replica id (determinism). An
        open-breaker replica is skipped; a half-open one competes
        normally but at most one in-flight pick gets it (the probe) —
        claiming the probe slot happens here, so a standalone pick()
        counts as the probe until the next dispatch outcome resolves
        it.

        With prefix affinity on (``prefix_block_size > 0``) and a
        ``prompt`` given, replicas whose queue is within
        ``affinity_queue_slack`` of the shortest compete first on how
        deep their advertised prefix inventory covers the prompt's
        chain keys; zero coverage everywhere falls back to the plain
        least-loaded order. A replica with deep coverage but a long
        queue is outside the slack band and never chosen over a short
        queue — affinity shapes ties, never overrides overload."""
        now = self._clock()
        affinity_keys: List[str] = []
        if self.prefix_block_size > 0 and prompt is not None:
            affinity_keys = prompt_chain_keys(
                prompt, self.prefix_block_size, self.affinity_max_blocks)
        with self._lock:
            candidates = []
            healthy = 0
            for rid, rep in self._replicas.items():
                br = self._breakers.get(rid)
                if not rep.admitting():
                    continue
                if br is not None:
                    if now < br.open_until:
                        continue  # open: no traffic, period
                    if br.probing:
                        continue  # half-open: probe already in flight
                healthy += 1
                if rid in skip:
                    continue
                candidates.append((rep.load(), rid, rep))
            self._g_healthy.set(healthy)
            self._set_excluded_locked(now)
            if not candidates:
                return None
            candidates.sort(key=lambda c: (c[0], c[1]))
            chosen = candidates[0]
            if affinity_keys:
                min_depth = candidates[0][0][0]
                eligible = [c for c in candidates
                            if c[0][0] <= min_depth
                            + self.affinity_queue_slack]
                scored = []
                for load, rid, rep in eligible:
                    cov = 0
                    try:
                        doc = rep.prefix_inventory()
                        if doc:
                            cov = PrefixInventory.from_dict(
                                doc).coverage_depth(affinity_keys)
                    except Exception:  # noqa: BLE001 — a hint, never fatal
                        cov = 0
                    scored.append((-cov, load, rid, rep))
                scored.sort(key=lambda s: (s[0], s[1], s[2]))
                if scored and scored[0][0] < 0:
                    chosen = (scored[0][1], scored[0][2], scored[0][3])
                    self._c_affinity.inc()
            chosen_id = chosen[1]
            br = self._breakers.get(chosen_id)
            if br is not None:
                br.probing = True
                self._state_gauge_locked(chosen_id).set(_STATE_HALF_OPEN)
            return chosen[2]

    # -- dispatch ----------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16, *,
               eos_token_id: Optional[int] = None,
               request_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               timeout: Optional[float] = None,
               deadline_t: Optional[float] = None) -> Any:
        """Dispatch one request; returns the replica's handle (annotated
        with ``.replica_id``). One pass over the fleet per attempt:
        failing replicas are excluded and the next-least-loaded tried
        immediately (no sleep — that's the no-retry-storm property);
        only a fully excluded fleet backs off, under ``self.policy``.
        ``timeout`` bounds the total dispatch wait, mapping to the
        policy's deadline semantics. ``trace_id`` (minted at the front
        door) rides every failover hop into the chosen replica.
        ``deadline_t`` (absolute monotonic) propagates to the replica;
        a request already expired is refused HERE — TimeoutError, no
        replica touched — instead of burning a slot on doomed work."""
        if deadline_t is not None and time.monotonic() >= deadline_t:
            raise TimeoutError(
                f"request {request_id!r} expired before dispatch")
        policy = self.policy
        if timeout is not None:
            policy = dataclasses.replace(policy, deadline_s=timeout)
        return retry_call(self._dispatch_once, prompt, max_new_tokens,
                          eos_token_id=eos_token_id, request_id=request_id,
                          trace_id=trace_id, deadline_t=deadline_t,
                          policy=policy)

    def _trace_args(self, request_id: Optional[str],
                    trace_id: Optional[str],
                    **extra: Any) -> Dict[str, Any]:
        args: Dict[str, Any] = dict(extra)
        if request_id is not None:
            args["request_id"] = request_id
        if trace_id is not None:
            args["trace_id"] = trace_id
        return args

    def _dispatch_once(self, prompt: Sequence[int], max_new_tokens: int, *,
                       eos_token_id: Optional[int],
                       request_id: Optional[str],
                       trace_id: Optional[str] = None,
                       deadline_t: Optional[float] = None) -> Any:
        tried: List[str] = []
        pt0 = time.perf_counter() if self._tracer is not None else 0.0
        while True:
            target = self.pick(skip=tried, prompt=prompt)
            if target is None:
                raise NoHealthyReplica(
                    f"no healthy replica (tried {tried or 'none'}, "
                    f"excluded {self.excluded()})")
            try:
                kw: Dict[str, Any] = {"eos_token_id": eos_token_id,
                                      "request_id": request_id}
                if trace_id is not None:
                    # only when minted, so minimal RoutablePort fakes
                    # (tests) need not grow the kwarg
                    kw["trace_id"] = trace_id
                if deadline_t is not None:
                    # same forwarded-only-when-set contract as trace_id
                    kw["deadline_t"] = deadline_t
                handle = target.submit(prompt, max_new_tokens, **kw)
            except ValueError:
                # never-servable: not a replica's fault — a half-open
                # probe slot this pick claimed is re-armed, not judged
                self._probe_release(target.replica_id)
                raise
            except _FAILOVER_ERRORS as exc:
                reason = ("overloaded" if isinstance(exc, ServerOverloaded)
                          else "connection")
                tried.append(target.replica_id)
                self._exclude(target.replica_id, reason)
                if self._tracer is not None:
                    self._tracer.instant(
                        "router_redispatch", **self._trace_args(
                            request_id, trace_id,
                            replica=target.replica_id, reason=reason))
                continue
            handle.replica_id = target.replica_id
            self._note_success(target.replica_id)
            self._c_dispatch.inc()
            self._dispatch_counter(target.replica_id).inc()
            if self._tracer is not None:
                self._tracer.record_span(
                    "router_dispatch", pt0, time.perf_counter() - pt0,
                    **self._trace_args(
                        request_id, trace_id, replica=target.replica_id,
                        attempts=len(tried) + 1))
            return handle
