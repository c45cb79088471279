"""Multi-window burn-rate SLO engine for the serving fleet — the port's
copy of ``determined_clone_tpu/telemetry/slo.py`` (pure Python there too).

The fleet's histograms answer "what is p99 right now"; an SLO answers the
operator question behind it — "are we eating error budget faster than the
objective allows". This module implements the Google-SRE-workbook
multi-window multi-burn-rate evaluation (docs/observability.md "Request
tracing & SLOs") over two SLIs:

- **availability**: fraction of requests that did not error;
- **latency**: fraction of (completed) requests under a threshold.

Burn rate is the budget-consumption speed: ``bad_fraction / (1 -
objective)``. 1.0 means the budget lands exactly at zero at period end; a
*fast* alert needs both the 5m and 1h windows above 14.4 (2% of a 30-day
budget gone in an hour), a *slow* alert needs both the 6h and 3d windows
above 1.0. Pairing a short window with a long one is what makes alerts
both fast to fire and fast to clear — the short window gates on "is it
still happening", the long window on "does it matter".

Requests land in coarse time buckets keyed off an injectable clock, so
tests (and the bench) drive days of simulated traffic in microseconds.
Everything is stdlib-only, thread-safe, and spawns no threads.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

# Evaluation windows (seconds). The fast pair pages, the slow pair tickets
# (SRE workbook ch. 5); thresholds below are the canonical 30-day-budget
# values.
WINDOWS: Dict[str, float] = {
    "5m": 300.0,
    "1h": 3600.0,
    "6h": 21_600.0,
    "3d": 259_200.0,
}
FAST_PAIR = ("5m", "1h")
SLOW_PAIR = ("6h", "3d")
FAST_BURN_THRESHOLD = 14.4
SLOW_BURN_THRESHOLD = 1.0

# verdict severity order, worst first (overall verdict = worst objective)
_VERDICT_ORDER = ("fast_burn", "slow_burn", "ok", "no_data")


class SLOEngine:
    """Time-bucketed SLI accounting + burn-rate evaluation.

    ``record_request`` is the single ingest point — the fleet front door
    calls it once per finished request, the bench and loadgen feed it
    directly. Buckets of ``bucket_s`` seconds hold ``[total, errors,
    latency_total, latency_slow]``; anything older than the longest
    window is pruned on write.
    """

    def __init__(self, *, availability_objective: float = 0.999,
                 latency_objective: float = 0.99,
                 latency_threshold_s: float = 0.5,
                 bucket_s: float = 60.0,
                 clock: Callable[[], float] = time.time) -> None:
        if not 0.0 < availability_objective < 1.0:
            raise ValueError(
                f"availability_objective must be in (0, 1), "
                f"got {availability_objective}")
        if not 0.0 < latency_objective < 1.0:
            raise ValueError(
                f"latency_objective must be in (0, 1), "
                f"got {latency_objective}")
        if latency_threshold_s <= 0:
            raise ValueError(
                f"latency_threshold_s must be > 0, "
                f"got {latency_threshold_s}")
        if bucket_s <= 0:
            raise ValueError(f"bucket_s must be > 0, got {bucket_s}")
        self.availability_objective = float(availability_objective)
        self.latency_objective = float(latency_objective)
        self.latency_threshold_s = float(latency_threshold_s)
        self.bucket_s = float(bucket_s)
        self._clock = clock
        self._buckets: Dict[int, List[float]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def from_dict(raw: Optional[Dict[str, Any]], *,
                  clock: Callable[[], float] = time.time) -> "SLOEngine":
        """Build from a config mapping (unknown keys ignored)."""
        raw = raw or {}
        return SLOEngine(
            availability_objective=float(
                raw.get("availability_objective", 0.999)),
            latency_objective=float(raw.get("latency_objective", 0.99)),
            latency_threshold_s=float(raw.get("latency_threshold_s", 0.5)),
            bucket_s=float(raw.get("bucket_s", 60.0)),
            clock=clock)

    # -- ingest -------------------------------------------------------------

    def record_request(self, *, ok: bool = True,
                       latency_s: Optional[float] = None,
                       n: int = 1, t: Optional[float] = None) -> None:
        """Account one finished request (or ``n`` identical ones).

        ``ok=False`` burns the availability budget; ``latency_s`` (when
        given — errored requests usually have none) is judged against the
        latency threshold. ``t`` overrides the clock for replayed traffic.
        """
        now = self._clock() if t is None else float(t)
        idx = int(now // self.bucket_s)
        horizon = idx - int(max(WINDOWS.values()) // self.bucket_s) - 1
        with self._lock:
            b = self._buckets.get(idx)
            if b is None:
                b = self._buckets[idx] = [0.0, 0.0, 0.0, 0.0]
                # prune on bucket creation: at most once per bucket_s
                for old in [i for i in self._buckets if i < horizon]:
                    del self._buckets[old]
            b[0] += n
            if not ok:
                b[1] += n
            if latency_s is not None:
                b[2] += n
                if latency_s > self.latency_threshold_s:
                    b[3] += n

    # -- evaluation ---------------------------------------------------------

    def _window_counts(self, now: float, window_s: float) -> List[float]:
        lo = now - window_s
        out = [0.0, 0.0, 0.0, 0.0]
        with self._lock:
            for idx, b in self._buckets.items():
                # include any bucket overlapping (now - window_s, now]
                if (idx + 1) * self.bucket_s > lo and idx * self.bucket_s <= now:
                    for k in range(4):
                        out[k] += b[k]
        return out

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Full multi-window evaluation of both objectives.

        Per objective, per window: total/bad counts, bad fraction, and
        burn rate (None when the window saw no traffic). ``burning_fast``
        / ``burning_slow`` require *both* windows of the pair over the
        pair's threshold. Verdicts: ``fast_burn`` > ``slow_burn`` > ``ok``
        > ``no_data``; the top-level ``verdict`` is the worst objective.
        """
        now = self._clock() if now is None else float(now)
        per_window = {name: self._window_counts(now, sec)
                      for name, sec in WINDOWS.items()}
        objectives: Dict[str, Any] = {}
        specs = (
            ("availability", self.availability_objective, 0, 1),
            ("latency", self.latency_objective, 2, 3),
        )
        for name, objective, den_i, bad_i in specs:
            budget = 1.0 - objective
            windows: Dict[str, Any] = {}
            for wname, counts in per_window.items():
                total, bad = counts[den_i], counts[bad_i]
                frac = (bad / total) if total else None
                burn = (frac / budget) if frac is not None else None
                windows[wname] = {
                    "total": int(total), "bad": int(bad),
                    "bad_fraction": (round(frac, 6)
                                     if frac is not None else None),
                    "burn_rate": (round(burn, 4)
                                  if burn is not None else None),
                }

            def _pair_burning(pair, threshold):
                return all(
                    windows[w]["burn_rate"] is not None
                    and windows[w]["burn_rate"] >= threshold for w in pair)

            burning_fast = _pair_burning(FAST_PAIR, FAST_BURN_THRESHOLD)
            burning_slow = _pair_burning(SLOW_PAIR, SLOW_BURN_THRESHOLD)
            if burning_fast:
                verdict = "fast_burn"
            elif burning_slow:
                verdict = "slow_burn"
            elif all(w["total"] == 0 for w in windows.values()):
                verdict = "no_data"
            else:
                verdict = "ok"
            entry: Dict[str, Any] = {
                "objective": objective,
                "windows": windows,
                "burning_fast": burning_fast,
                "burning_slow": burning_slow,
                "verdict": verdict,
            }
            if name == "latency":
                entry["threshold_s"] = self.latency_threshold_s
            objectives[name] = entry
        overall = min((o["verdict"] for o in objectives.values()),
                      key=_VERDICT_ORDER.index)
        return {"time": now, "verdict": overall, "objectives": objectives}

    # -- export -------------------------------------------------------------

    def publish(self, registry: Any,
                evaluation: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Land the evaluation as ``dct_slo_*`` gauges in ``registry``
        (windows with no traffic export NaN, matching Prometheus summary
        semantics for empty quantiles). Returns the evaluation."""
        ev = evaluation or self.evaluate()
        for name, obj in ev["objectives"].items():
            registry.gauge(
                "dct_slo_objective", "configured SLO target fraction",
                labels={"objective": name}).set(obj["objective"])
            for wname, w in obj["windows"].items():
                lbl = {"objective": name, "window": wname}
                registry.gauge(
                    "dct_slo_bad_fraction",
                    "bad-event fraction over the window",
                    labels=lbl).set(
                        w["bad_fraction"] if w["bad_fraction"] is not None
                        else float("nan"))
                registry.gauge(
                    "dct_slo_burn_rate",
                    "error-budget burn rate over the window "
                    "(1.0 = budget gone at period end)",
                    labels=lbl).set(
                        w["burn_rate"] if w["burn_rate"] is not None
                        else float("nan"))
            registry.gauge(
                "dct_slo_burning_fast",
                "1 when both fast windows (5m+1h) burn over 14.4x",
                labels={"objective": name}).set(
                    1.0 if obj["burning_fast"] else 0.0)
            registry.gauge(
                "dct_slo_burning_slow",
                "1 when both slow windows (6h+3d) burn over 1.0x",
                labels={"objective": name}).set(
                    1.0 if obj["burning_slow"] else 0.0)
        registry.gauge(
            "dct_slo_burning",
            "1 when any objective is burning (fast or slow)").set(
                1.0 if any(o["burning_fast"] or o["burning_slow"]
                           for o in ev["objectives"].values()) else 0.0)
        return ev


def format_slo(evaluation: Dict[str, Any]) -> str:
    """Human-readable rendering for ``dct slo``."""
    lines = [f"slo verdict: {evaluation['verdict']}"]
    for name, obj in sorted(evaluation["objectives"].items()):
        target = obj["objective"]
        extra = (f" (threshold {obj['threshold_s']}s)"
                 if "threshold_s" in obj else "")
        lines.append(
            f"  {name}: objective {target:.4%}{extra} "
            f"verdict {obj['verdict']}")
        for wname in WINDOWS:
            w = obj["windows"][wname]
            if w["burn_rate"] is None:
                lines.append(f"    {wname:>3}: no traffic")
            else:
                lines.append(
                    f"    {wname:>3}: {w['bad']}/{w['total']} bad "
                    f"({w['bad_fraction']:.4%}) burn {w['burn_rate']:.2f}x")
    return "\n".join(lines)
