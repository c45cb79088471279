"""Queue-driven fleet autoscaling — the port's copy of
``determined_clone_tpu/serving/autoscale.py`` (docs/serving.md autoscaler
section), ``TimeSeriesSignals`` (the master's time-series store as the
signal source) included.

Scaling signal: the engine gauges the fleet already exports. Growth is
triggered by *sustained* congestion — per-replica queue depth or fleet
p99 over threshold for ``breach_ticks`` consecutive ticks — because a
single burst tick is exactly what the admission queue is for; reacting
to it thrashes. Shrink is stricter: the fleet must look idle for
``idle_ticks`` consecutive ticks, and the removal itself goes through
the drain protocol (``ServingFleet.stop_replica``): admission stops,
in-flight decodes finish, KV blocks free, and only then are the slots
released. A cooldown after every action absorbs the signal swing the
action itself causes (a grown fleet's queues drain; a shrunk fleet's
queues grow).

``tick()`` is deterministic and side-effect-explicit — tests drive it
directly with synthetic signals. The optional background thread
(``fleet-autoscaler``, registered with the conftest thread-leak
fixture) just calls ``tick()`` on a period.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Callable, Optional, Sequence

from determined_clone_tpu_torch.telemetry.metrics import MetricsRegistry

GROW = "grow"
SHRINK = "shrink"
HOLD = "hold"


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Thresholds for one fleet. The defaults suit the bench's paced
    tiny-GPT replicas; real deployments tune per model."""
    min_replicas: int = 1
    max_replicas: int = 4
    # grow when EITHER breaches for breach_ticks straight ticks:
    queue_high: float = 8.0        # waiting requests per healthy replica
    p99_high_s: float = 2.0        # worst replica request p99
    breach_ticks: int = 3
    # shrink when BOTH hold for idle_ticks straight ticks:
    queue_low: float = 0.5         # waiting requests per healthy replica
    idle_ticks: int = 10
    cooldown_ticks: int = 5        # after any action
    grow_step: int = 1
    shrink_step: int = 1


@dataclasses.dataclass
class AutoscaleSignals:
    """One tick's input, normally read off ``ServingFleet.stats()``."""
    healthy: int
    queue_depth: int               # fleet-wide waiting requests
    p99_s: float                   # worst replica p99 (NaN when no data)


class TimeSeriesSignals:
    """AutoscaleSignals read from the master TSDB instead of the
    fleet's instantaneous stats (docs/observability.md "Time series,
    queries & alert rules").

    Instantaneous stats make the autoscaler react to whatever the
    current tick happens to look like; the TSDB gives it *trends* —
    queue depth averaged over ``window_s``, the worst p99 seen in the
    window — and, optionally, alert-rule verdicts as overrides: while
    any named ``congestion_rule`` fires, the signals read as congested
    (p99 forced over any threshold) regardless of the raw numbers;
    while an ``idle_rule`` fires (and nothing is congested), they read
    as idle. Pass an instance as ``Autoscaler(signals_fn=...)``.
    """

    def __init__(self, tsdb: Any, *, window_s: float = 60.0,
                 rules: Any = None,
                 congestion_rules: Sequence[str] = (),
                 idle_rules: Sequence[str] = ()) -> None:
        self.tsdb = tsdb
        self.window_s = float(window_s)
        self.rules = rules
        self.congestion_rules = set(congestion_rules)
        self.idle_rules = set(idle_rules)

    def _reduced(self, name: str, reduce: str,
                 default: float) -> float:
        res = self.tsdb.query(name, window_s=self.window_s,
                              reduce=reduce)
        vals = [s["value"] for s in res["series"]
                if s.get("value") is not None
                and s["value"] == s["value"]]
        return vals[0] if vals else default

    def __call__(self) -> AutoscaleSignals:
        healthy = int(self._reduced("dct_fleet_replicas", "last", 1.0))
        queue = self._reduced("dct_fleet_queue_depth", "avg", 0.0)
        p99 = self._reduced("dct_fleet_max_replica_p99_seconds", "max",
                            float("nan"))
        if self.rules is not None:
            firing = set(self.rules.firing())
            if firing & self.congestion_rules:
                p99 = float("inf")
            elif firing & self.idle_rules:
                queue, p99 = 0.0, 0.0
        return AutoscaleSignals(healthy=max(1, healthy),
                                queue_depth=int(round(queue)),
                                p99_s=p99)


class Autoscaler:
    """Deterministic grow/shrink decisions over a ServingFleet.

    ``tick(signals=None)`` reads the fleet when no signals are passed;
    tests inject :class:`AutoscaleSignals` to script exact scenarios.
    Decisions are applied through the fleet (scale_up / scale_down →
    drain protocol) unless ``dry_run`` is set, in which case tick only
    returns what it *would* do.
    """

    def __init__(self, fleet: Any, policy: AutoscalePolicy = AutoscalePolicy(),
                 *, registry: Optional[MetricsRegistry] = None,
                 dry_run: bool = False,
                 signals_fn: Optional[Callable[[], AutoscaleSignals]]
                 = None) -> None:
        self.fleet = fleet
        self.policy = policy
        self.dry_run = bool(dry_run)
        # alternative signal source (e.g. TimeSeriesSignals); None reads
        # the fleet's instantaneous stats
        self.signals_fn = signals_fn
        self.registry = (registry if registry is not None
                         else getattr(fleet, "registry", None)
                         or MetricsRegistry())
        self._breach = 0
        self._idle = 0
        self._cooldown = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._c_grow = self.registry.counter(
            "autoscale_grow_total", "replicas added by the autoscaler")
        self._c_shrink = self.registry.counter(
            "autoscale_shrink_total",
            "replicas drained away by the autoscaler")
        self._g_breach = self.registry.gauge(
            "autoscale_breach_ticks", "consecutive congested ticks")
        self._g_idle = self.registry.gauge(
            "autoscale_idle_ticks", "consecutive idle ticks")

    # -- the decision ------------------------------------------------------

    def _read_signals(self) -> AutoscaleSignals:
        if self.signals_fn is not None:
            return self.signals_fn()
        st = self.fleet.stats()
        return AutoscaleSignals(healthy=st.healthy,
                                queue_depth=st.queue_depth,
                                p99_s=st.max_p99_s)

    def tick(self, signals: Optional[AutoscaleSignals] = None) -> str:
        """One autoscaling decision. Returns "grow" | "shrink" | "hold"."""
        p = self.policy
        s = signals if signals is not None else self._read_signals()
        with self._lock:
            if self._cooldown > 0:
                self._cooldown -= 1
                return HOLD
            healthy = max(1, s.healthy)
            per_replica_q = s.queue_depth / healthy
            p99 = s.p99_s if not math.isnan(s.p99_s) else 0.0
            congested = (per_replica_q > p.queue_high or p99 > p.p99_high_s)
            idle = per_replica_q <= p.queue_low and p99 <= p.p99_high_s
            if congested:
                self._breach += 1
                self._idle = 0
            elif idle:
                self._idle += 1
                self._breach = 0
            else:
                self._breach = 0
                self._idle = 0
            self._g_breach.set(self._breach)
            self._g_idle.set(self._idle)
            action = HOLD
            if (self._breach >= p.breach_ticks
                    and s.healthy < p.max_replicas):
                action = GROW
            elif (self._idle >= p.idle_ticks
                    and s.healthy > p.min_replicas):
                action = SHRINK
            if action == HOLD:
                return HOLD
            self._breach = 0
            self._idle = 0
            self._cooldown = p.cooldown_ticks
        # apply outside the lock: scale_down drains (can take seconds)
        if action == GROW:
            n = min(p.grow_step, p.max_replicas - s.healthy)
            if not self.dry_run:
                self.fleet.scale_up(n)
            self._c_grow.inc(n)
        else:
            n = min(p.shrink_step, s.healthy - p.min_replicas)
            if not self.dry_run:
                self.fleet.scale_down(n)
            self._c_shrink.inc(n)
        return action

    # -- optional background loop ------------------------------------------

    def start(self, interval_s: float = 1.0) -> None:
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except (RuntimeError, TimeoutError):
                    continue  # fleet mid-teardown; next tick re-reads

        self._thread = threading.Thread(target=run, name="fleet-autoscaler",
                                        daemon=True)
        self._thread.start()

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
