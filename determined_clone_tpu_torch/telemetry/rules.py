"""Declarative alert rules evaluated against the time-series store — the
port's copy of ``determined_clone_tpu/telemetry/rules.py``.

The SLO engine (slo.py) hard-codes one alerting policy (multi-window burn
rate over two SLIs). This module generalizes it: any stored series can
drive an alert, the policy is data (the ``observability.rules:`` config
block), and every rule runs the same pending → firing → resolved state
machine with a ``for_s`` hold-down so a single noisy scrape can't page.

Rule kinds:

- ``threshold`` — a reduction (``avg``/``max``/``min``/``last``) of the
  series over ``window_s``, compared via ``op`` to ``value``;
- ``rate_of_change`` — same comparison over the windowed ``rate()`` of
  a counter;
- ``burn_rate`` — the SRE-workbook multi-window form. Either derive
  burn from a ``bad_series``/``total_series`` counter pair (``windows``
  in seconds, ``objective`` the SLO target) or read a precomputed burn
  gauge like ``dct_slo_burn_rate`` (``windows`` as the series' window
  label values). Fires only when *every* window burns past
  ``threshold`` — the short window gates "is it still happening", the
  long one "does it matter". :func:`stock_slo_rules` re-derives the SLO
  engine's fast/slow verdicts this way from stored series alone;
- ``absence`` — fires when the matched series has no sample newer than
  ``stale_s`` (or never existed). The TSDB's scrape skips sources the
  aggregator hasn't re-ingested, so a dead replica's series really do
  stop advancing and this catches it.

Evaluation runs on the scrape tick against an injectable clock; wall
time appears only in reported fields. Firing rules export as
``dct_alert_firing{rule,severity}`` gauges so the alert state itself is
scrapeable history.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

from determined_clone_tpu_torch.telemetry.metrics import _label_str

KINDS = ("threshold", "rate_of_change", "burn_rate", "absence")
STATES = ("inactive", "pending", "firing", "resolved")
SEVERITIES = ("page", "ticket")
_OPS: Dict[str, Callable[[float, float], bool]] = {
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
}
_REDUCES = ("avg", "max", "min", "last")


class AlertRule:
    """One declarative rule plus its alerting state machine."""

    def __init__(self, name: str, kind: str, *,
                 series: Optional[str] = None,
                 labels: Optional[Dict[str, str]] = None,
                 window_s: float = 300.0,
                 reduce: str = "avg",
                 op: str = "gt",
                 value: Optional[float] = None,
                 for_s: float = 0.0,
                 severity: str = "ticket",
                 stale_s: Optional[float] = None,
                 windows: Optional[Sequence[Union[str, float]]] = None,
                 threshold: Optional[float] = None,
                 objective: Optional[float] = None,
                 bad_series: Optional[str] = None,
                 total_series: Optional[str] = None) -> None:
        if kind not in KINDS:
            raise ValueError(f"rule {name!r}: unknown kind {kind!r} "
                             f"(one of {KINDS})")
        if severity not in SEVERITIES:
            raise ValueError(f"rule {name!r}: severity must be one of "
                             f"{SEVERITIES}, got {severity!r}")
        if op not in _OPS:
            raise ValueError(f"rule {name!r}: op must be one of "
                             f"{sorted(_OPS)}, got {op!r}")
        if reduce not in _REDUCES:
            raise ValueError(f"rule {name!r}: reduce must be one of "
                             f"{_REDUCES}, got {reduce!r}")
        if kind in ("threshold", "rate_of_change"):
            if not series or value is None:
                raise ValueError(
                    f"rule {name!r}: kind {kind!r} needs series + value")
        elif kind == "absence":
            if not series or stale_s is None or stale_s <= 0:
                raise ValueError(
                    f"rule {name!r}: absence needs series + stale_s > 0")
        else:  # burn_rate
            if threshold is None or not windows or len(windows) < 1:
                raise ValueError(
                    f"rule {name!r}: burn_rate needs windows + threshold")
            if bad_series:
                if not total_series or objective is None:
                    raise ValueError(
                        f"rule {name!r}: counter-pair burn_rate needs "
                        f"bad_series + total_series + objective")
                if not 0.0 < objective < 1.0:
                    raise ValueError(
                        f"rule {name!r}: objective must be in (0, 1), "
                        f"got {objective}")
            elif not series:
                raise ValueError(
                    f"rule {name!r}: burn_rate needs either series (a "
                    f"burn gauge) or bad_series/total_series counters")
        self.name = name
        self.kind = kind
        self.series = series
        self.labels = dict(labels or {})
        self.window_s = float(window_s)
        self.reduce = reduce
        self.op = op
        self.value = value
        self.for_s = float(for_s)
        self.severity = severity
        self.stale_s = float(stale_s) if stale_s is not None else None
        self.windows = list(windows or [])
        self.threshold = threshold
        self.objective = objective
        self.bad_series = bad_series
        self.total_series = total_series
        # state machine
        self.state = "inactive"
        self.since: Optional[float] = None
        self._pending_since: Optional[float] = None
        self.measured: Optional[float] = None
        self.detail = ""

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "AlertRule":
        if not isinstance(raw, dict):
            raise ValueError(f"alert rule must be a mapping, got {raw!r}")
        known = {"name", "kind", "series", "labels", "window_s", "reduce",
                 "op", "value", "for_s", "severity", "stale_s", "windows",
                 "threshold", "objective", "bad_series", "total_series"}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(
                f"alert rule {raw.get('name', '?')!r}: unknown keys "
                f"{sorted(unknown)}")
        if not raw.get("name") or not raw.get("kind"):
            raise ValueError(f"alert rule needs name + kind, got {raw!r}")
        kwargs = {k: v for k, v in raw.items()
                  if k not in ("name", "kind")}
        return AlertRule(str(raw["name"]), str(raw["kind"]), **kwargs)

    # -- condition ---------------------------------------------------------

    def _reduced(self, tsdb: Any, series: str, reduce: str,
                 now: float, window_s: Optional[float] = None,
                 extra_labels: Optional[Dict[str, str]] = None
                 ) -> List[Any]:
        labels = dict(self.labels)
        if extra_labels:
            labels.update(extra_labels)
        res = tsdb.query(series, labels,
                         window_s=window_s or self.window_s,
                         reduce=reduce, now=now)
        return res["series"]

    def _condition(self, tsdb: Any, now: float) -> bool:
        if self.kind in ("threshold", "rate_of_change"):
            reduce = ("rate" if self.kind == "rate_of_change"
                      else self.reduce)
            cmp = _OPS[self.op]
            breaches = [
                (s["labels"], s["value"])
                for s in self._reduced(tsdb, self.series, reduce, now)
                if s["value"] is not None
                and s["value"] == s["value"]
                and cmp(s["value"], self.value)]
            if not breaches:
                self.measured, self.detail = None, "no breach"
                return False
            worst = (max if self.op in ("gt", "ge") else min)(
                breaches, key=lambda kv: kv[1])
            self.measured = worst[1]
            self.detail = (f"{self.series}{_label_str(worst[0])} "
                           f"{reduce}={worst[1]:.6g} {self.op} "
                           f"{self.value:.6g} over {self.window_s:g}s")
            return True
        if self.kind == "absence":
            views = tsdb.series(self.series, self.labels)
            if not views:
                self.measured = None
                self.detail = (f"{self.series} absent (no samples "
                               f"stored)")
                return True
            stale = [(v["labels"], now - v["last_t"]) for v in views
                     if now - v["last_t"] > self.stale_s]
            if not stale:
                self.measured, self.detail = None, "reporting"
                return False
            worst = max(stale, key=lambda kv: kv[1])
            self.measured = worst[1]
            self.detail = (f"{self.series}{_label_str(worst[0])} "
                           f"last sample {worst[1]:.1f}s ago "
                           f"(> {self.stale_s:g}s)")
            return True
        # burn_rate: every window must burn past the threshold
        burns: List[str] = []
        for w in self.windows:
            burn = self._window_burn(tsdb, w, now)
            if burn is None or burn != burn or burn < self.threshold:
                self.measured = burn
                self.detail = (f"window {w}: burn "
                               f"{'n/a' if burn is None else format(burn, '.3g')}"
                               f" < {self.threshold:g}")
                return False
            burns.append(f"{w}={burn:.3g}x")
        self.measured = self.threshold
        self.detail = ("burning " + " ".join(burns)
                       + f" (>= {self.threshold:g}x)")
        return True

    def _window_burn(self, tsdb: Any, w: Union[str, float],
                     now: float) -> Optional[float]:
        if self.bad_series:
            window_s = float(w)
            bad = [s["value"] for s in self._reduced(
                tsdb, self.bad_series, "increase", now, window_s)]
            total = [s["value"] for s in self._reduced(
                tsdb, self.total_series, "increase", now, window_s)]
            bad_n = sum(v for v in bad if v is not None)
            total_n = sum(v for v in total if v is not None)
            if total_n <= 0:
                return None
            return (bad_n / total_n) / (1.0 - self.objective)
        # precomputed burn gauge: windows are the series' window label
        vals = [s["value"] for s in self._reduced(
            tsdb, self.series, "last", now,
            extra_labels={"window": str(w)})
            if s["value"] is not None]
        return vals[0] if vals else None

    # -- state machine -----------------------------------------------------

    def evaluate(self, tsdb: Any, now: float) -> Dict[str, Any]:
        active = self._condition(tsdb, now)
        if active:
            if self.state in ("inactive", "resolved"):
                self.state = "pending"
                self._pending_since = now
                self.since = now
            if (self.state == "pending"
                    and now - self._pending_since >= self.for_s):
                self.state = "firing"
                self.since = now
        else:
            if self.state == "firing":
                self.state = "resolved"
                self.since = now
            elif self.state in ("pending", "resolved"):
                self.state = "inactive"
                self.since = None
            self._pending_since = None
        return self.snapshot()

    def snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "kind": self.kind,
                "severity": self.severity, "state": self.state,
                "since": self.since, "for_s": self.for_s,
                "value": self.measured, "detail": self.detail}


class RuleEngine:
    """Owns the rule set; evaluated once per scrape tick."""

    def __init__(self, rules: Sequence[AlertRule] = (), *,
                 clock: Callable[[], float] = time.time) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self.rules: List[AlertRule] = list(rules)
        self._last_eval: Optional[float] = None

    @classmethod
    def from_config(cls, raw: Optional[Sequence[Dict[str, Any]]], *,
                    clock: Callable[[], float] = time.time
                    ) -> "RuleEngine":
        rules = [AlertRule.from_dict(r) for r in (raw or [])]
        names = [r.name for r in rules]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate alert rule names: "
                             f"{sorted(dupes)}")
        return cls(rules, clock=clock)

    def add(self, rule: AlertRule) -> None:
        with self._lock:
            if any(r.name == rule.name for r in self.rules):
                raise ValueError(f"duplicate alert rule {rule.name!r}")
            self.rules.append(rule)

    def evaluate(self, tsdb: Any,
                 now: Optional[float] = None) -> List[Dict[str, Any]]:
        now = self._clock() if now is None else float(now)
        with self._lock:
            self._last_eval = now
            return [r.evaluate(tsdb, now) for r in self.rules]

    def firing(self) -> List[str]:
        with self._lock:
            return [r.name for r in self.rules if r.state == "firing"]

    def alerts(self) -> Dict[str, Any]:
        """Structured state for ``/api/v1/alerts`` / ``dct alerts``.
        ``time_wall`` is a reported field (real wall clock); everything
        stateful rides the injectable clock."""
        with self._lock:
            snaps = [r.snapshot() for r in self.rules]
            last = self._last_eval
        return {"time_wall": time.time(), "evaluated_at": last,
                "rules": snaps,
                "firing": [s["name"] for s in snaps
                           if s["state"] == "firing"]}

    def publish(self, registry: Any) -> None:
        """Export rule states as gauges in the master registry so alert
        history is itself scrapeable."""
        with self._lock:
            rules = list(self.rules)
        for r in rules:
            registry.gauge(
                "dct_alert_firing", "1 while the alert rule fires",
                labels={"rule": r.name, "severity": r.severity}).set(
                    1.0 if r.state == "firing" else 0.0)
        registry.gauge(
            "dct_alerts_firing",
            "number of alert rules currently firing").set(
                float(sum(1 for r in rules if r.state == "firing")))


def stock_slo_rules(*, objective: str = "latency",
                    lookback_s: float = 900.0) -> List[AlertRule]:
    """The SLO engine's fast/slow burn verdicts as two stock rules over the
    stored ``dct_slo_burn_rate`` gauges (telemetry/slo.py publishes
    them; the scrape persists them). Thresholds are the SRE-workbook
    30-day-budget values the SLO engine itself uses."""
    from determined_clone_tpu_torch.telemetry.slo import (
        FAST_BURN_THRESHOLD,
        FAST_PAIR,
        SLOW_BURN_THRESHOLD,
        SLOW_PAIR,
    )

    return [
        AlertRule(f"slo-{objective}-fast-burn", "burn_rate",
                  series="dct_slo_burn_rate",
                  labels={"objective": objective},
                  windows=list(FAST_PAIR),
                  threshold=FAST_BURN_THRESHOLD,
                  window_s=lookback_s, severity="page"),
        AlertRule(f"slo-{objective}-slow-burn", "burn_rate",
                  series="dct_slo_burn_rate",
                  labels={"objective": objective},
                  windows=list(SLOW_PAIR),
                  threshold=SLOW_BURN_THRESHOLD,
                  window_s=lookback_s, severity="ticket"),
    ]


def format_alerts(payload: Dict[str, Any]) -> str:
    """Human rendering for ``dct alerts``."""
    rules = payload.get("rules") or []
    if not rules:
        return "no alert rules configured"
    firing = payload.get("firing") or []
    lines = [f"{len(rules)} rules, {len(firing)} firing"
             + (f": {', '.join(firing)}" if firing else "")]
    order = {"firing": 0, "pending": 1, "resolved": 2, "inactive": 3}
    for s in sorted(rules, key=lambda r: (order.get(r["state"], 9),
                                          r["name"])):
        mark = {"firing": "!!", "pending": " ~",
                "resolved": " v"}.get(s["state"], "  ")
        val = (f"  value={s['value']:.6g}"
               if s.get("value") is not None else "")
        detail = f"  ({s['detail']})" if s.get("detail") else ""
        lines.append(f"{mark} {s['name']} [{s['severity']}] "
                     f"{s['state']}{val}{detail}")
    return "\n".join(lines)
