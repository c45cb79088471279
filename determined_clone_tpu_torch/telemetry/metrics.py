"""Metrics registry: Counter / Gauge / Histogram with Prometheus exposition
— the port's own copy of ``determined_clone_tpu/telemetry/metrics.py``
(pure Python there too; the port imports nothing of the JAX package).

The serving engine's counters, gauges and histograms live in one
registry, which renders the Prometheus text exposition format via
:meth:`MetricsRegistry.dump` (the HTTP server's ``/metrics``) and
structured snapshots via :meth:`MetricsRegistry.snapshot`.

Histograms keep a bounded uniform reservoir (Vitter's algorithm R) plus exact
count/sum/min/max, so streaming p50/p95/p99 are exact until ``reservoir_size``
observations and statistically unbiased after. Quantiles interpolate linearly
— the same estimator as ``numpy.percentile``'s default — so tests can compare
directly against numpy.

Everything here is stdlib-only and thread-safe (one lock per metric; the
registry lock only guards the name table), and nothing spawns threads.
"""
from __future__ import annotations

import bisect
import collections
import random
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple


def _valid_name(name: str) -> str:
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _escape_label_value(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP-line escaping: backslash and newline only (quotes are legal)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(labels: Optional[Dict[str, str]],
               extra: Optional[Dict[str, str]] = None) -> str:
    """``{k="v",...}`` rendered sorted (deterministic dumps), or ``""``."""
    merged: Dict[str, str] = dict(labels or {})
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(f'{_valid_name(k)}="{_escape_label_value(v)}"'
                     for k, v in sorted(merged.items()))
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing count (Prometheus counter)."""

    prom_type = "counter"

    def __init__(self, name: str, help: str = "", *,
                 labels: Optional[Dict[str, str]] = None) -> None:
        self.name = _valid_name(name)
        self.help = help
        self.labels = dict(labels) if labels else {}
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def sample_lines(self) -> List[str]:
        return [f"{self.name}{_label_str(self.labels)} {_fmt(self.value)}"]

    def expose(self) -> List[str]:
        return [f"# TYPE {self.name} counter"] + self.sample_lines()

    def sample(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"type": "counter", "value": self.value}
        if self.labels:
            out["labels"] = dict(self.labels)
        return out


class Gauge:
    """A value that goes up and down (Prometheus gauge)."""

    prom_type = "gauge"

    def __init__(self, name: str, help: str = "", *,
                 labels: Optional[Dict[str, str]] = None) -> None:
        self.name = _valid_name(name)
        self.help = help
        self.labels = dict(labels) if labels else {}
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def sample_lines(self) -> List[str]:
        return [f"{self.name}{_label_str(self.labels)} {_fmt(self.value)}"]

    def expose(self) -> List[str]:
        return [f"# TYPE {self.name} gauge"] + self.sample_lines()

    def sample(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"type": "gauge", "value": self.value}
        if self.labels:
            out["labels"] = dict(self.labels)
        return out


class Histogram:
    """Streaming distribution with reservoir-sampled quantiles.

    Exposed as a Prometheus *summary* (quantile labels + _sum/_count): the
    trial side wants p50/p95/p99 directly, not cumulative buckets that need
    a server-side quantile estimator.

    Observations may carry an *exemplar* — a short identity string (a
    request_id) naming the thing that produced the value. The histogram
    keeps a small ring of recent exemplars plus the exemplar of the
    all-time max, so an aggregate like "p99 doubled" can be traded for a
    concrete trace id (``dct metrics`` → ``dct trace request <id>``).
    Exemplars ride :meth:`sample` snapshots and a ``# EXEMPLAR`` comment
    line in the exposition text (comments, so every existing scraper
    still parses the family).
    """

    QUANTILES = (0.5, 0.95, 0.99)
    EXEMPLAR_RING = 8

    prom_type = "summary"

    def __init__(self, name: str, help: str = "", *,
                 reservoir_size: int = 4096, seed: int = 0,
                 labels: Optional[Dict[str, str]] = None) -> None:
        self.name = _valid_name(name)
        self.help = help
        self.labels = dict(labels) if labels else {}
        self.reservoir_size = int(reservoir_size)
        self._rng = random.Random(seed)  # deterministic for reproducibility
        self._sample: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._exemplars: collections.deque = collections.deque(
            maxlen=self.EXEMPLAR_RING)
        self._max_exemplar: Optional[Tuple[float, str]] = None
        self._lock = threading.Lock()

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if exemplar is not None:
                self._exemplars.append((v, str(exemplar)))
                if (self._max_exemplar is None
                        or v >= self._max_exemplar[0]):
                    self._max_exemplar = (v, str(exemplar))
            if len(self._sample) < self.reservoir_size:
                bisect.insort(self._sample, v)
            else:
                # algorithm R: replace a uniform victim with prob k/n
                # (the reservoir is kept sorted, but a uniform index into
                # it is still a uniform victim)
                j = self._rng.randrange(self._count)
                if j < self.reservoir_size:
                    self._sample.pop(j)
                    bisect.insort(self._sample, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def exemplars(self) -> List[Tuple[float, str]]:
        """Recent (value, id) bucket occupants, oldest first."""
        with self._lock:
            return list(self._exemplars)

    def max_exemplar(self) -> Optional[Tuple[float, str]]:
        """(value, id) of the all-time max observation, if any carried an
        exemplar."""
        with self._lock:
            return self._max_exemplar

    def percentile(self, q: float) -> float:
        """q in [0, 100]; numpy-default linear interpolation over the
        reservoir (exact while count <= reservoir_size)."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        with self._lock:
            xs = list(self._sample)
        if not xs:
            return float("nan")
        pos = (len(xs) - 1) * (q / 100.0)
        lo = int(pos)
        frac = pos - lo
        if lo + 1 < len(xs):
            return xs[lo] * (1.0 - frac) + xs[lo + 1] * frac
        return xs[lo]

    def sample_lines(self) -> List[str]:
        base = _label_str(self.labels)
        lines = []
        for q in self.QUANTILES:
            lines.append(
                f"{self.name}{_label_str(self.labels, {'quantile': str(q)})} "
                f"{_fmt(self.percentile(100 * q))}")
        lines.append(f"{self.name}_sum{base} {_fmt(self.sum)}")
        lines.append(f"{self.name}_count{base} {self.count}")
        ex = self.max_exemplar()
        if ex is not None:
            lines.append(
                f"# EXEMPLAR {self.name}"
                f"{_label_str(self.labels, {'request_id': ex[1]})} "
                f"{_fmt(ex[0])}")
        return lines

    def expose(self) -> List[str]:
        return [f"# TYPE {self.name} summary"] + self.sample_lines()

    def sample(self) -> Dict[str, Any]:
        with self._lock:
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
        out: Dict[str, Any] = {"type": "histogram", "count": count,
                               "sum": round(total, 6)}
        if self.labels:
            out["labels"] = dict(self.labels)
        if count:
            out.update(
                min=round(mn, 6), max=round(mx, 6),
                p50=round(self.percentile(50), 6),
                p95=round(self.percentile(95), 6),
                p99=round(self.percentile(99), 6),
            )
        ex = self.max_exemplar()
        if ex is not None:
            out["max_exemplar"] = {"value": round(ex[0], 6), "id": ex[1]}
            out["exemplars"] = [
                {"value": round(v, 6), "id": i} for v, i in self.exemplars()]
        return out


class MetricsRegistry:
    """(Name, labels) → metric table with get-or-create accessors.

    Accessors are idempotent (same name + labels returns the same instance)
    and type-checked: registering ``foo`` as both a counter and a gauge is a
    bug worth failing loudly on. Labeled children of the same name (e.g. one
    gauge per trial) share one HELP/TYPE header in :meth:`dump` — the
    Prometheus exposition format requires at most one per metric family.
    """

    def __init__(self, prefix: str = "") -> None:
        self.prefix = prefix
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Optional[Dict[str, str]] = None, **kw) -> Any:
        name = self.prefix + name
        key = _valid_name(name) + _label_str(labels)
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise TypeError(
                        f"metric {key!r} already registered as "
                        f"{type(existing).__name__}, not {cls.__name__}")
                return existing
            metric = cls(name, help, labels=labels, **kw)
            self._metrics[key] = metric
            return metric

    def counter(self, name: str, help: str = "", *,
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", *,
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", *,
                  reservoir_size: int = 4096,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   reservoir_size=reservoir_size)

    def metrics(self) -> List[Any]:
        with self._lock:
            return list(self._metrics.values())

    def dump(self) -> str:
        """Prometheus text exposition (text/plain; version=0.0.4)."""
        lines: List[str] = []
        by_name: Dict[str, List[Any]] = {}
        for metric in self.metrics():
            by_name.setdefault(metric.name, []).append(metric)
        for name in sorted(by_name):
            family = sorted(by_name[name],
                            key=lambda m: _label_str(m.labels))
            help_text = next((m.help for m in family if m.help), "")
            if help_text:
                lines.append(f"# HELP {name} {_escape_help(help_text)}")
            lines.append(f"# TYPE {name} {family[0].prom_type}")
            for metric in family:
                lines.extend(metric.sample_lines())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Structured state for shipping through the profiler channel.

        Keyed by name + rendered label string (labels, when present, also
        ride inside the sample), so labeled children never collide.
        """
        with self._lock:
            items = list(self._metrics.items())
        return {key: m.sample() for key, m in items}


def parse_prometheus_text(text: str) -> Dict[str, Any]:
    """Parse the text exposition format back into structured samples.

    Returns ``{"samples": [(name, labels_dict, value)], "types": {name:
    type}, "help": {name: help}, "exemplars": [(name, labels_dict,
    value)]}``. Understands the escaping rules :meth:`MetricsRegistry.dump`
    applies, so tests (and ``dct metrics``) can round-trip the ``/metrics``
    endpoint output; ``# EXEMPLAR`` comment lines (histogram exemplars)
    are collected separately rather than skipped.
    """
    samples: List[Any] = []
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    exemplars: List[Any] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) == 4:
                types[parts[2]] = parts[3]
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) >= 3:
                raw = parts[3] if len(parts) == 4 else ""
                helps[parts[2]] = (raw.replace("\\n", "\n")
                                   .replace("\\\\", "\\"))
            continue
        if line.startswith("# EXEMPLAR "):
            body = line[len("# EXEMPLAR "):].strip()
            try:
                sub = parse_prometheus_text(body)
                exemplars.extend(sub["samples"])
            except (ValueError, IndexError):
                pass
            continue
        if line.startswith("#"):
            continue
        # <name>{k="v",...} <value>  |  <name> <value>
        labels: Dict[str, str] = {}
        if "{" in line:
            name, _, rest = line.partition("{")
            body, _, tail = rest.rpartition("}")
            value_str = tail.strip()
            i = 0
            while i < len(body):
                eq = body.index("=", i)
                key = body[i:eq].strip().lstrip(",").strip()
                if body[eq + 1] != '"':
                    raise ValueError(f"unquoted label value in {line!r}")
                j = eq + 2
                buf = []
                while j < len(body):
                    c = body[j]
                    if c == "\\" and j + 1 < len(body):
                        nxt = body[j + 1]
                        buf.append({"n": "\n", '"': '"', "\\": "\\"}
                                   .get(nxt, "\\" + nxt))
                        j += 2
                        continue
                    if c == '"':
                        break
                    buf.append(c)
                    j += 1
                labels[key] = "".join(buf)
                i = j + 1
        else:
            name, _, value_str = line.partition(" ")
            value_str = value_str.strip()
        value = float(value_str)
        samples.append((name.strip(), labels, value))
    return {"samples": samples, "types": types, "help": helps,
            "exemplars": exemplars}


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)
