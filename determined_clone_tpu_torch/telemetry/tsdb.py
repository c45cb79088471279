"""Embedded ring-buffer time-series store for the master — the port's
copy of ``determined_clone_tpu/telemetry/tsdb.py`` (pure Python there too).

The aggregator (telemetry/aggregate.py) answers "what is this gauge
*now*"; a trend-driven control loop asks "what was it ten minutes
ago". :class:`TimeSeriesDB` is the Monarch/Prometheus-style answer
scaled to an embedded master: per-series fixed-capacity rings of
``(t, value)`` samples, a staircase-downsampled coarse tier for the long
horizon, a total-memory budget with per-series accounting, and
optional flight-recorder-style JSONL segment persistence so history
survives a master restart.

Feeding it is a *scrape*: ``scrape(aggregator)`` renders the
aggregator's Prometheus exposition and parses it back through
``parse_prometheus_text`` — counters stored raw (so ``rate()`` and
``increase()`` stay computable), gauges and histogram quantiles stored
as-is. Because the aggregator is latest-wins per source, re-storing a
snapshot whose source never re-reported would fabricate data: the scrape
consults :meth:`ClusterMetricsAggregator.source_ingest_times` and skips
samples from sources that have not re-ingested since the previous
scrape, so a dead replica's series genuinely stop advancing (which is
what lets an absence rule in telemetry/rules.py fire on it).

All timestamps ride an injectable ``clock`` (tests replay days of
history in microseconds); wall time appears only in reported fields.
The scrape loop thread is named ``dct-tsdb-scrape`` (conftest's
thread-leak exemptions know it).
"""
from __future__ import annotations

import collections
import json
import os
import re
import threading
import time
from typing import (
    Any, Callable, Deque, Dict, FrozenSet, List, Optional, Tuple,
)

from determined_clone_tpu_torch.telemetry.metrics import (
    _label_str,
    parse_prometheus_text,
)

# Estimated live-memory cost of one stored sample / one series shell.
# Deliberately coarse (CPython tuples of floats plus deque slots): the
# budget bounds growth, it does not meter bytes exactly.
FINE_SAMPLE_BYTES = 64
COARSE_SAMPLE_BYTES = 96
SERIES_OVERHEAD_BYTES = 400

SEGMENT_RE = re.compile(r"tsdb-(\d+)\.jsonl$")

REDUCES = ("raw", "rate", "increase", "avg", "max", "min", "last",
           "quantile")


def _source_of(labels: Dict[str, str]) -> str:
    """Which aggregator source a sample belongs to (freshness domain).

    Trial snapshots carry ``trial_id``, component snapshots carry
    ``component``; everything else (master registry counters, the
    ``dct_fleet_*``/``dct_goodput_*`` rollups, alert gauges) is computed
    by the master itself and is always fresh.
    """
    tid = labels.get("trial_id")
    if tid is not None:
        return f"trial_{tid}"
    comp = labels.get("component")
    if comp is not None:
        return comp
    return "master"


def _positive_increase(points: List[Tuple[float, float]]) -> float:
    """Counter increase over the points, reset-tolerant: a drop means
    the process restarted from zero, so the post-reset value is all new
    increase (Prometheus semantics, minus extrapolation)."""
    inc = 0.0
    for (_, prev), (_, cur) in zip(points, points[1:]):
        inc += cur - prev if cur >= prev else cur
    return inc


def _quantile(values: List[float], q: float) -> float:
    vs = sorted(values)
    if len(vs) == 1:
        return vs[0]
    pos = max(0.0, min(1.0, q)) * (len(vs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] + (vs[hi] - vs[lo]) * (pos - lo)


class _Series:
    """One ``(name, labels)`` series: a fine ring plus a coarse tier.

    The fine ring holds raw samples; every ``coarse_step_s`` of series
    time, the finished step is folded into one coarse point ``(t_end,
    last, avg, max)`` — the staircase: a sample ages out of the fine
    ring but its step survives in the coarse tier, so long windows stay
    answerable at step resolution. Counters read ``last`` from a coarse
    point (cumulative value at step end keeps increase()/rate() exact
    across tiers); gauges read ``avg``.
    """

    __slots__ = ("name", "labels", "kind", "fine", "coarse", "last_t",
                 "_bucket", "_agg")

    def __init__(self, name: str, labels: Dict[str, str], kind: str,
                 capacity: int, coarse_capacity: int) -> None:
        self.name = name
        self.labels = labels
        self.kind = kind
        self.fine: Deque[Tuple[float, float]] = collections.deque(
            maxlen=capacity)
        self.coarse: Deque[Tuple[float, float, float, float]] = (
            collections.deque(maxlen=coarse_capacity))
        self.last_t = float("-inf")
        self._bucket: Optional[int] = None
        # open coarse step accumulator: [count, sum, max, last]
        self._agg: List[float] = [0.0, 0.0, float("-inf"), 0.0]

    def append(self, t: float, v: float, coarse_step_s: float) -> None:
        self.fine.append((t, v))
        self.last_t = max(self.last_t, t)
        b = int(t // coarse_step_s)
        if self._bucket is None:
            self._bucket = b
        elif b != self._bucket:
            self._seal(coarse_step_s)
            self._bucket = b
        a = self._agg
        a[0] += 1
        a[1] += v
        a[2] = max(a[2], v)
        a[3] = v

    def _seal(self, coarse_step_s: float) -> None:
        a = self._agg
        if self._bucket is not None and a[0]:
            t_end = (self._bucket + 1) * coarse_step_s
            self.coarse.append((t_end, a[3], a[1] / a[0], a[2]))
        self._agg = [0.0, 0.0, float("-inf"), 0.0]

    def window(self, lo: float, hi: float) -> List[Tuple[float, float]]:
        """Samples in ``(lo, hi]`` — coarse tier where the fine ring no
        longer reaches, fine samples from there on."""
        out: List[Tuple[float, float]] = []
        fine_lo = self.fine[0][0] if self.fine else float("inf")
        for t, last, avg, _mx in self.coarse:
            if lo < t < fine_lo and t <= hi:
                out.append((t, last if self.kind == "counter" else avg))
        out.extend((t, v) for t, v in self.fine if lo < t <= hi)
        return out

    def bytes_estimate(self) -> int:
        return (SERIES_OVERHEAD_BYTES
                + len(self.fine) * FINE_SAMPLE_BYTES
                + len(self.coarse) * COARSE_SAMPLE_BYTES)

    def sample_count(self) -> int:
        return len(self.fine) + len(self.coarse)


class TimeSeriesDB:
    """In-memory TSDB with a memory budget and optional persistence.

    ``record`` / ``scrape_text`` / ``scrape`` write; ``query`` reads;
    ``stats`` reports per-series accounting. Thread-safe; spawns no
    threads itself (:class:`TSDBScraper` owns the loop).
    """

    def __init__(self, *, capacity_per_series: int = 240,
                 coarse_step_s: float = 60.0,
                 coarse_capacity: int = 720,
                 max_series: int = 4096,
                 memory_budget_bytes: int = 16 * 1024 * 1024,
                 persist_dir: Optional[str] = None,
                 segment_scrapes: int = 120,
                 max_segments: int = 8,
                 replay: bool = True,
                 clock: Callable[[], float] = time.time) -> None:
        if capacity_per_series < 2:
            raise ValueError("capacity_per_series must be >= 2, "
                             f"got {capacity_per_series}")
        if coarse_step_s <= 0:
            raise ValueError(f"coarse_step_s must be > 0, got "
                             f"{coarse_step_s}")
        self.capacity_per_series = int(capacity_per_series)
        self.coarse_step_s = float(coarse_step_s)
        self.coarse_capacity = int(coarse_capacity)
        self.max_series = int(max_series)
        self.memory_budget_bytes = int(memory_budget_bytes)
        self.persist_dir = persist_dir
        self.segment_scrapes = max(1, int(segment_scrapes))
        self.max_segments = max(2, int(max_segments))
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, str], _Series] = {}
        self._bytes = 0
        self._evicted_total = 0
        self._scrapes_total = 0
        self._samples_stored_total = 0
        self._source_seen: Dict[str, float] = {}
        self._seg_file: Optional[Any] = None
        self._seg_seq = 0
        self._seg_lines = 0
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)
            existing = self._segment_paths()
            if existing:
                self._seg_seq = max(
                    int(SEGMENT_RE.search(p).group(1)) for p in existing)
                if replay:
                    self._replay(existing)

    @staticmethod
    def from_dict(raw: Optional[Dict[str, Any]], *,
                  clock: Callable[[], float] = time.time
                  ) -> "TimeSeriesDB":
        """Build from the ``observability.timeseries:`` config mapping
        (unknown keys ignored; ``memory_budget_mb`` is the config-facing
        unit)."""
        raw = raw or {}
        return TimeSeriesDB(
            capacity_per_series=int(raw.get("capacity_per_series", 240)),
            coarse_step_s=float(raw.get("coarse_step_s", 60.0)),
            coarse_capacity=int(raw.get("coarse_capacity", 720)),
            max_series=int(raw.get("max_series", 4096)),
            memory_budget_bytes=int(
                float(raw.get("memory_budget_mb", 16.0)) * 1024 * 1024),
            persist_dir=raw.get("persist_dir"),
            segment_scrapes=int(raw.get("segment_scrapes", 120)),
            max_segments=int(raw.get("max_segments", 8)),
            clock=clock)

    # -- writing -----------------------------------------------------------

    def record(self, name: str, value: float, *,
               labels: Optional[Dict[str, str]] = None,
               kind: str = "gauge", t: Optional[float] = None) -> None:
        """Store one sample. ``kind`` is sticky per series: the first
        writer decides whether coarse points read last (counter) or avg
        (gauge)."""
        now = self._clock() if t is None else float(t)
        with self._lock:
            self._record_locked(name, dict(labels or {}), float(value),
                                kind, now)

    def _record_locked(self, name: str, labels: Dict[str, str],
                       value: float, kind: str, t: float) -> None:
        key = (name, _label_str(labels))
        s = self._series.get(key)
        if s is None:
            if len(self._series) >= self.max_series:
                self._evict_one_locked(exclude=None)
            s = self._series[key] = _Series(
                name, labels, kind, self.capacity_per_series,
                self.coarse_capacity)
        before = s.bytes_estimate()
        s.append(t, value, self.coarse_step_s)
        self._bytes += s.bytes_estimate() - before
        self._samples_stored_total += 1
        while (self._bytes > self.memory_budget_bytes
               and len(self._series) > 1):
            if not self._evict_one_locked(exclude=key):
                break

    def _evict_one_locked(self, exclude: Optional[Tuple[str, str]]
                          ) -> bool:
        """Drop the stalest series (oldest newest-sample) whole —
        history for something that stopped reporting is the cheapest
        thing to shed when the budget is hit."""
        candidates = [(k, s) for k, s in self._series.items()
                      if k != exclude]
        if not candidates:
            return False
        key, s = min(candidates, key=lambda kv: kv[1].last_t)
        self._bytes -= s.bytes_estimate()
        del self._series[key]
        self._evicted_total += 1
        return True

    def scrape_text(self, text: str, *, t: Optional[float] = None,
                    stale_sources: FrozenSet[str] = frozenset(),
                    persist: bool = True) -> int:
        """Fold one Prometheus exposition snapshot into the store.

        Counter-typed samples (and summary ``_sum``/``_count`` children)
        are stored raw as counters; everything else — gauges, summary
        quantiles, untyped — as gauges. NaN samples (empty-summary
        quantiles) are skipped. Samples whose source is in
        ``stale_sources`` are skipped: no re-ingest means no new
        observation. Returns the number of samples stored.
        """
        now = self._clock() if t is None else float(t)
        try:
            parsed = parse_prometheus_text(text)
        except ValueError:
            return 0
        types = parsed["types"]
        stored: List[Tuple[str, Dict[str, str], float, str]] = []
        with self._lock:
            for name, labels, value in parsed["samples"]:
                if value != value:  # NaN: no observation to store
                    continue
                if _source_of(labels) in stale_sources:
                    continue
                kind = "gauge"
                if types.get(name) == "counter":
                    kind = "counter"
                else:
                    for suffix in ("_sum", "_count"):
                        stem = name[: -len(suffix)]
                        if (name.endswith(suffix)
                                and types.get(stem) == "summary"):
                            kind = "counter"
                            break
                self._record_locked(name, labels, value, kind, now)
                stored.append((name, labels, value, kind))
            self._scrapes_total += 1
            if persist and self.persist_dir and stored:
                self._persist_locked(now, stored)
        return len(stored)

    def scrape(self, aggregator: Any, *,
               now: Optional[float] = None) -> int:
        """One scrape tick against a ClusterMetricsAggregator: render
        its exposition, skip sources that have not re-ingested since the
        previous tick, store the rest."""
        now = self._clock() if now is None else float(now)
        stale: FrozenSet[str] = frozenset()
        get_times = getattr(aggregator, "source_ingest_times", None)
        if callable(get_times):
            times = dict(get_times())
            stale = frozenset(
                src for src, ts in times.items()
                if self._source_seen.get(src) == ts)
            self._source_seen = times
        return self.scrape_text(aggregator.dump(), t=now,
                                stale_sources=stale)

    # -- persistence -------------------------------------------------------

    def _segment_paths(self) -> List[str]:
        try:
            names = os.listdir(self.persist_dir)
        except OSError:
            return []
        return sorted(
            (os.path.join(self.persist_dir, n) for n in names
             if SEGMENT_RE.search(n)),
            key=lambda p: int(SEGMENT_RE.search(p).group(1)))

    def _persist_locked(self, t: float,
                        stored: List[Tuple[str, Dict[str, str], float,
                                           str]]) -> None:
        try:
            if self._seg_file is None or (
                    self._seg_lines >= self.segment_scrapes):
                if self._seg_file is not None:
                    self._seg_file.close()
                self._seg_seq += 1
                self._seg_lines = 0
                path = os.path.join(self.persist_dir,
                                    f"tsdb-{self._seg_seq:06d}.jsonl")
                self._seg_file = open(path, "a")
                for old in self._segment_paths()[: -self.max_segments]:
                    try:
                        os.unlink(old)
                    except OSError:
                        pass
            line = json.dumps(
                {"t": t, "samples": [[n, lb, v, k]
                                     for n, lb, v, k in stored]})
            self._seg_file.write(line + "\n")
            self._seg_file.flush()
            self._seg_lines += 1
        except (OSError, TypeError, ValueError):
            # persistence is best-effort: the in-memory store is intact
            self._seg_file = None

    def _replay(self, paths: List[str]) -> None:
        """Reload surviving segments into the rings (restart leg)."""
        for path in paths:
            try:
                with open(path) as f:
                    lines = f.readlines()
            except OSError:
                continue
            for line in lines:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail of a killed writer
                t = rec.get("t")
                samples = rec.get("samples")
                if t is None or not isinstance(samples, list):
                    continue
                with self._lock:
                    for item in samples:
                        try:
                            name, labels, value, kind = item
                            self._record_locked(
                                str(name), dict(labels), float(value),
                                str(kind), float(t))
                        except (TypeError, ValueError):
                            continue

    def close(self) -> None:
        with self._lock:
            if self._seg_file is not None:
                self._seg_file.close()
                self._seg_file = None

    # -- reading -----------------------------------------------------------

    def _match_locked(self, name: str,
                      labels: Optional[Dict[str, str]]) -> List[_Series]:
        want = labels or {}
        out = []
        for (n, _), s in self._series.items():
            if n != name:
                continue
            if all(s.labels.get(k) == str(v) for k, v in want.items()):
                out.append(s)
        return out

    def series(self, name: str,
               labels: Optional[Dict[str, str]] = None
               ) -> List[Dict[str, Any]]:
        """Lightweight views of matching series (label-subset match)."""
        with self._lock:
            return [{"labels": dict(s.labels), "kind": s.kind,
                     "last_t": s.last_t, "n": s.sample_count()}
                    for s in self._match_locked(name, labels)]

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted({n for n, _ in self._series})

    def query(self, name: str,
              labels: Optional[Dict[str, str]] = None, *,
              window_s: float = 300.0, reduce: str = "raw",
              q: float = 0.95,
              now: Optional[float] = None) -> Dict[str, Any]:
        """Windowed read of every matching series.

        ``reduce``: ``raw`` returns ``[[t, v], ...]`` per series; the
        rest return one value per series — ``rate``/``increase`` are
        counter-reset-tolerant positive-delta sums (rate per second),
        ``avg``/``max``/``min``/``last`` are over sample values,
        ``quantile`` takes ``q`` over sample values. A series with too
        few samples in the window reduces to None, never an error.
        """
        if reduce not in REDUCES:
            raise ValueError(
                f"unknown reduce {reduce!r} (one of {REDUCES})")
        now = self._clock() if now is None else float(now)
        lo = now - float(window_s)
        with self._lock:
            matched = [(dict(s.labels), s.kind, s.window(lo, now))
                       for s in self._match_locked(name, labels)]
        out_series: List[Dict[str, Any]] = []
        for lbls, kind, pts in matched:
            entry: Dict[str, Any] = {"labels": lbls, "kind": kind,
                                     "n": len(pts)}
            if reduce == "raw":
                entry["samples"] = [[t, v] for t, v in pts]
            else:
                entry["value"] = self._reduce(reduce, pts, q)
            out_series.append(entry)
        return {"name": name, "window_s": float(window_s),
                "reduce": reduce, "now": now, "series": out_series}

    @staticmethod
    def _reduce(reduce: str, pts: List[Tuple[float, float]],
                q: float) -> Optional[float]:
        if not pts:
            return None
        values = [v for _, v in pts]
        if reduce == "last":
            return values[-1]
        if reduce == "avg":
            return sum(values) / len(values)
        if reduce == "max":
            return max(values)
        if reduce == "min":
            return min(values)
        if reduce == "quantile":
            return _quantile(values, q)
        # rate / increase need a delta
        if len(pts) < 2:
            return None
        inc = _positive_increase(pts)
        if reduce == "increase":
            return inc
        span = pts[-1][0] - pts[0][0]
        return inc / span if span > 0 else None

    # -- accounting --------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            per_series = sorted(
                ((f"{n}{ls}" if ls else n, s.bytes_estimate())
                 for (n, ls), s in self._series.items()),
                key=lambda kv: -kv[1])
            return {
                "series": len(self._series),
                "samples": sum(s.sample_count()
                               for s in self._series.values()),
                "samples_stored_total": self._samples_stored_total,
                "bytes_estimate": self._bytes,
                "memory_budget_bytes": self.memory_budget_bytes,
                "within_budget": self._bytes <= self.memory_budget_bytes,
                "series_evicted_total": self._evicted_total,
                "scrapes_total": self._scrapes_total,
                "top_series_bytes": [list(kv) for kv in per_series[:5]],
                "persist": ({"dir": self.persist_dir,
                             "segments": len(self._segment_paths())}
                            if self.persist_dir else None),
            }


class TSDBScraper:
    """Background scrape loop: ``tick_fn()`` on a period, thread named
    ``dct-tsdb-scrape``. The tick itself (scrape + rule evaluation) is
    owned by the master so tests drive it deterministically."""

    def __init__(self, tick_fn: Callable[[], Any],
                 period_s: float = 5.0) -> None:
        self._tick = tick_fn
        self.period_s = float(period_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TSDBScraper":
        if self._thread is not None:
            raise RuntimeError("scraper already started")

        def run() -> None:
            while not self._stop.wait(self.period_s):
                try:
                    self._tick()
                except Exception:  # noqa: BLE001 - keep scraping
                    continue

        self._thread = threading.Thread(
            target=run, name="dct-tsdb-scrape", daemon=True)
        self._thread.start()
        return self

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
