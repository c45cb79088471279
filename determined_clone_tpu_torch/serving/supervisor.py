"""Fleet self-healing: liveness supervision and automatic replacement —
the port's copy of ``determined_clone_tpu/serving/supervisor.py``.

The :class:`FleetSupervisor` is the recovery half of the robustness story
(docs/serving.md "Self-healing"): deterministic fault injection can kill
or wedge an :class:`InferenceEngine`, and the fleet's ``replace_replica``
can bring up a substitute — this module is the loop that notices the
failure and pulls the trigger without a human.

Liveness is judged from the engine's scheduler-loop heartbeat watermark
(:meth:`InferenceEngine.liveness`), which distinguishes three states a
plain is-the-thread-alive check cannot:

- **dead** — scheduler thread exited or ``_fatal`` is set. The engine
  will never make progress again.
- **wedged** — the thread is alive but has had pending work for longer
  than ``stale_after_s`` without completing a scheduler pass (heartbeat
  watermark stale *while work is queued*). A blocked device call, a
  deadlocked lock, an infinite loop — all look identical from outside,
  and all strand their requests forever if nobody intervenes.
- **parked** — stale heartbeat with *no* pending work is just an idle
  scheduler waiting on its condition variable: healthy, never flagged.

On a dead/wedged verdict the supervisor condemns the engine
(``fail_inflight`` — waiters get :class:`ReplicaFailed` immediately and
the front door requeues them to survivors) and calls
``fleet.replace_replica``, which records MTTR in
``fleet_recovery_seconds`` and the incident for ``dct fleet status``.
Replicas still warming (``STARTING``) are never probed: the fleet only
routes to them after warm-up, so a slow graph capture is not a failure.

The probe loop itself is a chaos target (``supervisor.probe``): a probe
pass that raises is counted in ``supervisor_probe_failures_total`` and
the loop carries on, so a supervisor+replica double fault delays
recovery by one interval instead of disabling it.

Threading: one daemon loop thread (``fleet-supervisor``, registered with
the conftest thread-leak allowlist). The supervisor holds **no** locks
across fleet or engine calls — it snapshots the replica list, probes
each engine (engine takes its own ``_cond`` briefly), and calls fleet
methods that do their own locking; its only synchronization is a stop
Event. Lives in the control tier of the CONC003 lock hierarchy, same as
the fleet it drives.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from determined_clone_tpu_torch import faults

# Probe verdicts, as recorded in Incident["reason"] / last_probe().
DEAD = "dead"
WEDGED = "wedged"
OK = "ok"


class FleetSupervisor:
    """Background liveness prober that replaces failed replicas.

    Parameters
    ----------
    fleet:
        The :class:`ServingFleet` to supervise (not owned; the fleet's
        ``close`` stops the supervisor before tearing down replicas).
    interval_s:
        Probe period. MTTR is bounded below by this plus the warm-start
        time, so chaos budgets assume one interval of detection lag.
    stale_after_s:
        The failure deadline: a replica with pending work whose
        scheduler heartbeat is older than this is declared wedged.
    replace:
        When False, failed replicas are condemned and removed but not
        replaced (shrinking fleet) — useful for tests and draining.
    start:
        Start the loop thread immediately (default). ``start=False``
        gives a passive supervisor driven by explicit
        :meth:`probe_once` calls — what the chaos conductor uses to
        keep scenarios deterministic.
    """

    def __init__(self, fleet: Any, *, interval_s: float = 0.25,
                 stale_after_s: float = 5.0, replace: bool = True,
                 start: bool = True) -> None:
        self.fleet = fleet
        self.interval_s = float(interval_s)
        self.stale_after_s = float(stale_after_s)
        self.replace = bool(replace)
        m = fleet.registry
        self._c_probe_failures = m.counter(
            "supervisor_probe_failures_total",
            "Supervisor probe passes that raised (double-fault chaos)")
        self._last_probe: Dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # -- probing -----------------------------------------------------------

    def verdict(self, live: Dict[str, Any]) -> str:
        """Classify one engine liveness snapshot (pure; unit-testable)."""
        if not live["thread_alive"] or live["fatal"] is not None:
            return DEAD
        if (live["pending"] and not live["warming"]
                and live["beat_age_s"] > self.stale_after_s):
            return WEDGED
        return OK

    def probe_once(self) -> List[Dict[str, Any]]:
        """One probe pass over the fleet. Returns the incidents it
        acted on (empty when everything is healthy). Raises whatever
        the ``supervisor.probe`` fault point injects — the loop thread
        absorbs that; direct callers (chaos conductor) see it."""
        faults.point("supervisor.probe")
        actions: List[Dict[str, Any]] = []
        last: Dict[str, str] = {}
        for rep in self.fleet.replicas():
            if not rep.admitting():
                continue
            v = self.verdict(rep.engine.liveness())
            last[rep.replica_id] = v
            if v == OK:
                continue
            added = self.fleet.replace_replica(
                rep.replica_id, reason=v, replacement=self.replace)
            actions.append({"replica": rep.replica_id, "verdict": v,
                            "replacement": added})
        self._last_probe = last
        return actions

    def last_probe(self) -> Dict[str, str]:
        """replica_id -> verdict from the most recent completed pass."""
        return dict(self._last_probe)

    # -- background loop ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("supervisor already started")
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.probe_once()
                except Exception:
                    # a failing probe (injected fault, fleet
                    # mid-teardown) must not kill supervision — count
                    # it and retry next interval
                    self._c_probe_failures.inc()

        self._thread = threading.Thread(target=run, name="fleet-supervisor",
                                        daemon=True)
        self._thread.start()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
