"""Deterministic fault injection: rules, plans, and injected exception
types — the port's copy of ``determined_clone_tpu/faults/core.py``.

A :class:`FaultPlan` is a seeded list of :class:`FaultRule`\\ s. Each rule
matches a named fault point (exact name or ``fnmatch`` pattern), counts how
often that point is hit, and *fires* — raises, sleeps, truncates, or hard-
exits — starting at the Nth hit, for a bounded number of times, optionally
gated by a seeded per-rule coin. Everything is deterministic for a given
(seed, rule order, hit sequence), which is what lets chaos tests assert
exact outcomes.

This module is import-light on purpose (stdlib only).
"""
from __future__ import annotations

import fnmatch
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional


class FaultInjected(RuntimeError):
    """Base for every injected failure (``exc: fault`` — non-retryable)."""


class InjectedIOError(FaultInjected, OSError):
    """Injected storage/filesystem failure (``exc: io`` — retryable)."""


class InjectedConnectionError(FaultInjected, ConnectionError):
    """Injected network failure (``exc: conn`` — retryable)."""


_EXC_TYPES = {
    "fault": FaultInjected,
    "io": InjectedIOError,
    "conn": InjectedConnectionError,
}

ACTIONS = ("error", "delay", "truncate", "exit")


class FaultRule:
    """One match rule. See docs/fault_tolerance.md for the field reference."""

    def __init__(self, raw: Dict[str, Any], seed: int, index: int) -> None:
        self.point = str(raw["point"])
        self.action = str(raw.get("action", "error"))
        if self.action not in ACTIONS:
            raise ValueError(
                f"fault rule {index}: unknown action {self.action!r} "
                f"(expected one of {ACTIONS})")
        self.exc = str(raw.get("exc", "fault"))
        if self.exc not in _EXC_TYPES:
            raise ValueError(
                f"fault rule {index}: unknown exc {self.exc!r} "
                f"(expected one of {tuple(_EXC_TYPES)})")
        self.nth = int(raw.get("nth", 1))
        self.times = int(raw.get("times", 1))  # 0 = unlimited
        self.probability = float(raw.get("probability", 1.0))
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(
                f"fault rule {index}: probability {self.probability} "
                f"outside [0, 1]")
        self.delay_s = float(raw.get("delay_s", 0.05))
        self.exit_code = int(raw.get("exit_code", 137))
        self.keep_bytes = int(raw.get("keep_bytes", 0))
        self.message = str(raw.get("message", ""))
        # per-rule RNG so adding/removing one rule doesn't shift the coin
        # sequence of its neighbors
        self._rng = random.Random(seed * 1_000_003 + index)
        self.hits = 0
        self.fires = 0

    def matches(self, name: str) -> bool:
        return self.point == name or fnmatch.fnmatchcase(name, self.point)

    def should_fire(self) -> bool:
        """Count a hit; decide (deterministically) whether this one fires."""
        self.hits += 1
        if self.hits < self.nth:
            return False
        if self.times and self.fires >= self.times:
            return False
        if self.probability < 1.0 and self._rng.random() >= self.probability:
            return False
        self.fires += 1
        return True


class FaultPlan:
    """A seeded set of rules, activated process-wide via the module API."""

    def __init__(self, rules: List[Dict[str, Any]], seed: int = 0) -> None:
        self.seed = seed
        self.rules = [FaultRule(r, seed, i) for i, r in enumerate(rules)]
        self.registry = None  # optional MetricsRegistry, set on activate()
        self._lock = threading.Lock()

    def hit(self, name: str) -> None:
        """Run every non-truncate rule matching ``name``. May raise/sleep/exit."""
        for rule in self.rules:
            if rule.action == "truncate" or not rule.matches(name):
                continue
            with self._lock:
                fire = rule.should_fire()
            if not fire:
                continue
            self._count(name)
            if rule.action == "delay":
                time.sleep(rule.delay_s)
            elif rule.action == "exit":
                # simulates kill -9 / node loss: no atexit hooks, no flushes
                os._exit(rule.exit_code)
            else:
                msg = rule.message or (
                    f"injected fault at {name!r} (hit {rule.hits})")
                raise _EXC_TYPES[rule.exc](msg)

    def truncate_bytes(self, name: str) -> Optional[int]:
        """Bytes to keep if a truncate rule fires at ``name``, else None."""
        for rule in self.rules:
            if rule.action != "truncate" or not rule.matches(name):
                continue
            with self._lock:
                fire = rule.should_fire()
            if fire:
                self._count(name)
                return rule.keep_bytes
        return None

    def _count(self, name: str) -> None:
        if self.registry is not None:
            self.registry.counter(
                "faults_injected_total",
                "fault-plan rules fired (all points)").inc()

    def stats(self) -> List[Dict[str, Any]]:
        """Per-rule hit/fire counters (for tests and debugging)."""
        with self._lock:
            return [{"point": r.point, "action": r.action,
                     "hits": r.hits, "fires": r.fires} for r in self.rules]
