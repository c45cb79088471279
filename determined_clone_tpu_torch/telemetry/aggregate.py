"""Master-side telemetry aggregation: the cluster-wide metrics plane.

Trials already ship registry snapshots and span records over the profiler
channel (``POST /api/v1/trials/{id}/profiler``, groups ``telemetry`` /
``span`` / ``timing``); until now the master only appended them to a
JSONL file. :class:`ClusterMetricsAggregator` turns those batches into a
live cluster view:

- **per-trial series** — the latest registry snapshot per trial is
  re-exposed with a ``trial_id`` label (gauges/counters as-is, histograms
  as Prometheus summaries built from the shipped p50/p95/p99);
- **cluster rollups** — ``dct_cluster_<name>``: counters summed across
  trials, gauges summed (plus a ``_avg`` series, since "sum" is right for
  throughput and wrong for ratios like MFU), histogram quantiles merged
  by count-weighted average (an approximation — exact cluster quantiles
  would need the raw reservoirs, which we deliberately don't ship);
- **ingestion hygiene** — malformed/oversized batches are rejected,
  counted (``dct_master_ingest_rejected_total{reason=...}``) and warned
  about at most once a minute, mirroring the trial-side
  ``profiler_samples_dropped`` shedding counter so loss is observable on
  both ends; duplicate batches are dropped via their idempotency keys.

The aggregator is transport-agnostic: the in-process master feeds it
directly, an HTTP front-end feeds it parsed JSON bodies. ``dump()`` is
the ``GET /metrics`` payload; ``summary()`` backs ``dct metrics``.
"""
from __future__ import annotations

import collections
import json
import logging
import statistics
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from determined_clone_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    _escape_help,
    _label_str,
    _valid_name,
)

log = logging.getLogger("dct.telemetry.aggregate")

# Mirrors the trial-side profiler shedding thresholds (profiler.py):
# the agent batches at most 100 samples and sheds past 10x that, so a
# well-behaved client can never legitimately exceed these.
MAX_INGEST_BATCH = 1000
MAX_SAMPLE_BYTES = 64 * 1024
REJECT_WARN_PERIOD_SEC = 60.0
SEEN_KEYS_MAX = 8192
SPANS_PER_TRIAL_MAX = 20_000

_KNOWN_GROUPS = ("telemetry", "span", "timing", "system")

# a source (trial or component) whose last ingest is older than this is
# flagged stale in `dct metrics` — its latest-wins gauges would otherwise
# render as frozen-healthy forever
STALE_SOURCE_AFTER_SEC = 60.0


def _fmt(v: Any) -> str:
    """A sample value in the Prometheus text format. NaN and the
    infinities are written ``NaN``, ``+Inf`` and ``-Inf``, as the format
    spells them (a fleet's ``dct_slo_*`` gauges are NaN before its first
    request); the JAX copy raises on them."""
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _TrialState:
    __slots__ = ("snapshot", "batches_trained", "last_time", "last_ingest",
                 "spans", "experiment_id")

    def __init__(self) -> None:
        self.snapshot: Dict[str, Dict[str, Any]] = {}
        self.batches_trained: Optional[int] = None
        self.last_time: float = 0.0
        # master-clock stamp of the last ingest for this trial; the
        # sample's own `time` field is the trial's claim, this is ours
        self.last_ingest: Optional[float] = None
        self.spans: Deque[Dict[str, Any]] = collections.deque(
            maxlen=SPANS_PER_TRIAL_MAX)
        self.experiment_id: Optional[int] = None


class ClusterMetricsAggregator:
    """Ingests trial/component telemetry into one cluster-level view."""

    def __init__(self, *, clock: Callable[[], float] = time.time) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._trials: Dict[int, _TrialState] = {}
        # non-trial components (runner, master) keyed by component name
        self._components: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self._component_ingest: Dict[str, float] = {}
        self._component_spans: Dict[
            str, Deque[Tuple[Optional[int], Dict[str, Any]]]] = {}
        self._seen_keys: "collections.OrderedDict[str, None]" = (
            collections.OrderedDict())
        self._last_reject_warn = 0.0
        self._rejected_since_warn = 0
        self.registry = MetricsRegistry()
        self._batches = self.registry.counter(
            "dct_master_ingest_batches_total",
            "telemetry batches accepted by the master")
        self._samples = self.registry.counter(
            "dct_master_ingest_samples_total",
            "telemetry samples accepted by the master")
        self._duplicates = self.registry.counter(
            "dct_master_ingest_duplicates_total",
            "batches dropped as idempotency-key duplicates")
        # fleet-level SLO engine (telemetry/slo.py), attached by whoever
        # owns the request stream (FleetHTTPServer); evaluated on demand
        self._slo: Any = None

    def attach_slo(self, slo: Any) -> None:
        """Attach the fleet's SLOEngine so ``slo_rollup()`` (and the
        master's ``/api/v1/cluster/slo`` route) can evaluate it."""
        self._slo = slo

    def slo_rollup(self) -> Optional[Dict[str, Any]]:
        """Multi-window burn-rate evaluation of the attached SLO engine,
        landing ``dct_slo_*`` gauges in the master registry as a side
        effect (so ``dump()`` exports them). None when no engine is
        attached — serving (and its SLOs) are optional lanes."""
        if self._slo is None:
            return None
        return self._slo.publish(self.registry)

    # -- ingestion ---------------------------------------------------------

    def _reject(self, n: int, reason: str) -> None:
        self.registry.counter(
            "dct_master_ingest_rejected_total",
            "telemetry samples rejected at ingestion, by reason",
            labels={"reason": reason}).inc(n)
        now = time.monotonic()
        with self._lock:
            self._rejected_since_warn += n
            if now - self._last_reject_warn < REJECT_WARN_PERIOD_SEC:
                return
            self._last_reject_warn = now
            pending, self._rejected_since_warn = self._rejected_since_warn, 0
        log.warning(
            "master rejected %d telemetry samples (latest reason: %s); "
            "see dct_master_ingest_rejected_total", pending, reason)

    def ingest(self, trial_id: int, samples: Any, *,
               idempotency_key: Optional[str] = None,
               experiment_id: Optional[int] = None) -> int:
        """Ingest one profiler batch for a trial. Returns samples accepted.

        Validation is per-batch for structural problems (not a list, too
        long, duplicate key) and per-sample for content problems
        (non-dict, no usable group, oversized) — a single bad sample never
        discards its siblings, matching the lossy-but-counted contract of
        the trial-side channel.
        """
        if not isinstance(samples, list):
            self._reject(1, "not_a_list")
            return 0
        if len(samples) > MAX_INGEST_BATCH:
            self._reject(len(samples), "batch_too_large")
            return 0
        if idempotency_key:
            with self._lock:
                if idempotency_key in self._seen_keys:
                    self._duplicates.inc()
                    return 0
                self._seen_keys[idempotency_key] = None
                while len(self._seen_keys) > SEEN_KEYS_MAX:
                    self._seen_keys.popitem(last=False)
        accepted = 0
        for sample in samples:
            if not isinstance(sample, dict):
                self._reject(1, "malformed")
                continue
            try:
                size = len(json.dumps(sample, default=str))
            except (TypeError, ValueError):
                self._reject(1, "malformed")
                continue
            if size > MAX_SAMPLE_BYTES:
                self._reject(1, "oversized")
                continue
            group = sample.get("group")
            if group is not None and not isinstance(group, str):
                self._reject(1, "malformed")
                continue
            self._ingest_one(int(trial_id), sample, experiment_id)
            accepted += 1
        if accepted:
            self._batches.inc()
            self._samples.inc(accepted)
        return accepted

    def _ingest_one(self, trial_id: int, sample: Dict[str, Any],
                    experiment_id: Optional[int]) -> None:
        with self._lock:
            st = self._trials.setdefault(trial_id, _TrialState())
            if experiment_id is not None:
                st.experiment_id = int(experiment_id)
            st.last_time = float(sample.get("time") or time.time())
            st.last_ingest = self._clock()
            group = sample.get("group")
            if group == "telemetry":
                metrics = sample.get("metrics")
                if isinstance(metrics, dict):
                    # latest-wins: snapshots are cumulative on the trial
                    # side, so the newest one supersedes older ones
                    st.snapshot = metrics
                if sample.get("batches_trained") is not None:
                    st.batches_trained = int(sample["batches_trained"])
            elif group == "span":
                st.spans.append(dict(sample))
            # timing/system/unknown groups: presence updates last_time
            # only — the JSONL sink (or file-based tooling) keeps them

    def register_trial(self, trial_id: int,
                       experiment_id: Optional[int] = None) -> None:
        with self._lock:
            st = self._trials.setdefault(int(trial_id), _TrialState())
            if experiment_id is not None:
                st.experiment_id = int(experiment_id)

    def ingest_component(self, component: str, registry: Any) -> None:
        """Fold a non-trial component's registry (runner, master, bench
        parent) into the cluster view. Accepts a MetricsRegistry or a
        ``snapshot()``-shaped dict; latest-wins per component."""
        snap = (registry.snapshot() if hasattr(registry, "snapshot")
                else dict(registry))
        if not isinstance(snap, dict):
            self._reject(1, "malformed")
            return
        with self._lock:
            self._components[str(component)] = snap
            self._component_ingest[str(component)] = self._clock()

    def ingest_prometheus_text(self, component: str, text: str) -> int:
        """Fold a component's raw Prometheus exposition (e.g. the C++
        master's ``GET /metrics``) into the cluster view, so the
        ``dct_master_sched_*`` families join ``summary()`` next to the
        trial-shipped series. Summary families are re-folded into the
        snapshot histogram shape (count/sum/p50/p95/p99); counters and
        gauges pass through. Returns the number of snapshot entries."""
        from determined_clone_tpu_torch.telemetry.metrics import (
            parse_prometheus_text,
        )

        try:
            parsed = parse_prometheus_text(text)
        except ValueError:
            self._reject(1, "malformed")
            return 0
        types = parsed["types"]
        snap: Dict[str, Dict[str, Any]] = {}
        summaries: Dict[Tuple[str, str], Dict[str, Any]] = {}
        for name, labels, value in parsed["samples"]:
            base, part = name, ""
            for suffix in ("_sum", "_count"):
                stem = name[: -len(suffix)]
                if name.endswith(suffix) and types.get(stem) == "summary":
                    base, part = stem, suffix
                    break
            if types.get(base) == "summary":
                child = {k: v for k, v in labels.items() if k != "quantile"}
                rec = summaries.setdefault(
                    (base, _label_str(child)),
                    {"type": "histogram", "labels": child,
                     "count": 0, "sum": 0.0})
                if part == "_count":
                    rec["count"] = int(value)
                elif part == "_sum":
                    rec["sum"] = value
                else:
                    key = {"0.5": "p50", "0.95": "p95",
                           "0.99": "p99"}.get(labels.get("quantile", ""))
                    if key and value == value:  # skip NaN (empty summary)
                        rec[key] = value
                continue
            mtype = "counter" if types.get(name) == "counter" else "gauge"
            snap[name + (_label_str(labels) if labels else "")] = {
                "type": mtype, "value": value, "labels": labels}
        for (base, label_s), rec in summaries.items():
            snap[base + label_s] = rec
        self.ingest_component(component, snap)
        return len(snap)

    def ingest_component_spans(self, component: str, samples: Any, *,
                               experiment_id: Optional[int] = None) -> int:
        """Span records from a non-trial component (runner, master)."""
        if not isinstance(samples, list):
            self._reject(1, "not_a_list")
            return 0
        accepted = 0
        with self._lock:
            dq = self._component_spans.setdefault(
                str(component),
                collections.deque(maxlen=SPANS_PER_TRIAL_MAX))
            for rec in samples:
                if not isinstance(rec, dict):
                    continue
                dq.append((experiment_id, dict(rec)))
                accepted += 1
            if accepted:  # spans count as liveness too
                self._component_ingest[str(component)] = self._clock()
        return accepted

    # -- views -------------------------------------------------------------

    def source_ingest_times(self) -> Dict[str, float]:
        """Master-clock stamp of the last ingest per source (``trial_<id>``
        / component name). The TSDB scrape diffs these against its
        previous tick so it never re-stores a snapshot whose source went
        quiet — a latest-wins gauge that nobody re-sent is not a new
        observation."""
        with self._lock:
            out = {f"trial_{tid}": st.last_ingest
                   for tid, st in self._trials.items()
                   if st.last_ingest is not None}
            out.update(self._component_ingest)
        return out

    def source_ages(self, now: Optional[float] = None) -> Dict[str, float]:
        """Seconds since each source last ingested anything."""
        now = self._clock() if now is None else float(now)
        return {src: max(0.0, now - ts)
                for src, ts in self.source_ingest_times().items()}

    def _staleness_lines(self) -> List[str]:
        ages = self.source_ages()
        if not ages:
            return []
        lines = ["# TYPE dct_master_source_age_seconds gauge"]
        for src in sorted(ages):
            lines.append(
                f"dct_master_source_age_seconds"
                f"{_label_str({'source': src})} {_fmt(round(ages[src], 3))}")
        return lines

    def trial_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._trials)

    def spans(self, *, trial_id: Optional[int] = None,
              experiment_id: Optional[int] = None) -> List[Dict[str, Any]]:
        """Span samples (shape of ``spans_from_profiler_samples`` input),
        each annotated with its ``trial_id``; filterable by trial or by
        experiment for ``dct trace export --experiment``."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for tid, st in sorted(self._trials.items()):
                if trial_id is not None and tid != trial_id:
                    continue
                if (experiment_id is not None
                        and st.experiment_id != experiment_id):
                    continue
                for rec in st.spans:
                    out.append({**rec, "trial_id": tid})
            if trial_id is None:
                for comp, dq in sorted(self._component_spans.items()):
                    for exp_id, rec in dq:
                        if (experiment_id is not None
                                and exp_id != experiment_id):
                            continue
                        out.append({"process": comp, **rec})
        return out

    def _families(self) -> Dict[str, Dict[str, Any]]:
        """name → {type, help, children: [(labels, sample)]} across every
        trial snapshot and component snapshot."""
        fams: Dict[str, Dict[str, Any]] = {}

        def add(owner_labels: Dict[str, str],
                snap: Dict[str, Dict[str, Any]]) -> None:
            for key, s in snap.items():
                if not isinstance(s, dict) or "type" not in s:
                    continue
                name = _valid_name(key.split("{", 1)[0])
                fam = fams.setdefault(
                    name, {"type": s["type"], "children": []})
                labels = dict(owner_labels)
                labels.update(s.get("labels") or {})
                fam["children"].append((labels, s))

        with self._lock:
            trials = {tid: st.snapshot for tid, st in self._trials.items()}
            comps = dict(self._components)
        for tid, snap in sorted(trials.items()):
            add({"trial_id": str(tid)}, snap)
        for comp, snap in sorted(comps.items()):
            add({"component": comp}, snap)
        return fams

    def dump(self) -> str:
        """Prometheus text: master counters + per-trial series + rollups."""
        lines = [self.registry.dump().rstrip("\n")] if (
            self.registry.metrics()) else []
        fams = self._families()
        for name in sorted(fams):
            fam = fams[name]
            mtype = fam["type"]
            prom_type = {"counter": "counter", "gauge": "gauge",
                         "histogram": "summary"}.get(mtype, "untyped")
            lines.append(f"# TYPE {name} {prom_type}")
            for labels, s in fam["children"]:
                if mtype == "histogram":
                    lines.extend(self._summary_lines(name, labels, s))
                else:
                    lines.append(
                        f"{name}{_label_str(labels)} {_fmt(s['value'])}")
            lines.extend(self._rollup_lines(name, fam))
        lines.extend(self._goodput_lines(fams))
        lines.extend(self._serving_fleet_lines(fams))
        lines.extend(self._mesh_lines(fams))
        lines.extend(self._exec_cache_lines(fams))
        lines.extend(self._staleness_lines())
        text = "\n".join(ln for ln in lines if ln)
        return text + ("\n" if text else "")

    def goodput_rollup(self, fams: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
        """Per-trial + cluster goodput from the shipped ledger gauges
        (``goodput_seconds_total{category=...}`` / ``goodput_wall_seconds``
        / ``goodput_fraction``). The cluster fraction is *time-weighted*
        (Σ productive / Σ wall) — an idle tiny trial must not drag down a
        busy big one the way a plain average of fractions would."""
        fams = fams if fams is not None else self._families()
        by_trial: Dict[str, Dict[str, Any]] = {}

        def trial_acct(tid: str) -> Dict[str, Any]:
            return by_trial.setdefault(
                tid, {"wall_s": 0.0, "goodput_fraction": None,
                      "categories": {}, "experiment_id": None})

        for labels, s in fams.get("goodput_wall_seconds",
                                  {}).get("children", []):
            tid = labels.get("trial_id")
            if tid is not None:
                trial_acct(tid)["wall_s"] = float(s.get("value", 0))
        for labels, s in fams.get("goodput_fraction",
                                  {}).get("children", []):
            tid = labels.get("trial_id")
            if tid is not None:
                trial_acct(tid)["goodput_fraction"] = float(
                    s.get("value", 0))
        for labels, s in fams.get("goodput_seconds_total",
                                  {}).get("children", []):
            tid, cat = labels.get("trial_id"), labels.get("category")
            if tid is not None and cat:
                trial_acct(tid)["categories"][cat] = float(
                    s.get("value", 0))
        with self._lock:
            for tid_s, acct in by_trial.items():
                st = self._trials.get(int(tid_s)) if tid_s.isdigit() else None
                if st is not None:
                    acct["experiment_id"] = st.experiment_id
        wall_total = sum(a["wall_s"] for a in by_trial.values())
        productive_total = sum(
            a["categories"].get("productive", 0.0)
            for a in by_trial.values())
        return {
            "by_trial": by_trial,
            "wall_total_s": wall_total,
            "cluster_fraction": (productive_total / wall_total
                                 if wall_total > 0 else None),
        }

    def serving_fleet_rollup(self, fams: Optional[Dict[str, Any]] = None
                             ) -> Optional[Dict[str, Any]]:
        """Fleet view over every ``component=serving_replica_*`` snapshot
        (ServingFleet.sample_telemetry feeds one per replica): aggregate
        decode throughput and free KV blocks are sums — capacity adds up
        — but the latency figure is the *max* replica p99, because a
        fleet is as slow as the replica the router is currently landing
        you on, and a count-weighted average would let one congested
        replica hide behind its idle peers. None when no replica has
        reported (the serving lanes are optional)."""
        fams = fams if fams is not None else self._families()

        def per_replica(name: str, key: str = "value"
                        ) -> Dict[str, float]:
            out: Dict[str, float] = {}
            for labels, s in fams.get(name, {}).get("children", []):
                comp = labels.get("component", "")
                if comp.startswith("serving_replica") and key in s:
                    out[comp] = float(s[key])
            return out

        tps = per_replica("serving_tokens_per_sec")
        free = per_replica("serving_free_kv_blocks")
        queue = per_replica("serving_queue_depth")
        p99 = per_replica("serving_request_total_seconds", "p99")
        completed = per_replica("serving_requests_completed_total")
        replicas = (set(tps) | set(free) | set(queue) | set(p99)
                    | set(completed))
        if not replicas:
            return None
        # raw-speed ratios are fleet-wide sums over sums (a per-replica
        # average would let an idle replica's 0/0 skew the ratio)
        proposed = sum(per_replica(
            "serving_spec_tokens_proposed_total").values())
        accepted = sum(per_replica(
            "serving_spec_tokens_accepted_total").values())
        hits = sum(per_replica("prefix_cache_hit_blocks_total").values())
        misses = sum(per_replica("prefix_cache_miss_blocks_total").values())
        # KV memory-hierarchy tier split (serving/kv_store.py): blocks a
        # replica promoted from host RAM / CAS instead of re-prefilling
        kv_host = sum(per_replica("kv_tier_host_hit_blocks_total").values())
        kv_cas = sum(per_replica("kv_tier_cas_hit_blocks_total").values())
        kv_miss = sum(per_replica("kv_tier_miss_blocks_total").values())
        kv_promoted = sum(per_replica(
            "kv_tier_promoted_blocks_total").values())
        kv_spilled = sum(per_replica(
            "kv_tier_spilled_blocks_total").values())
        kv_looked = kv_host + kv_cas + kv_miss
        # slowest request across the fleet: the latency histogram's
        # max exemplar carries the request_id (telemetry/metrics.py)
        slowest: Optional[Dict[str, Any]] = None
        for labels, s in fams.get("serving_request_total_seconds",
                                  {}).get("children", []):
            comp = labels.get("component", "")
            ex = s.get("max_exemplar")
            if (comp.startswith("serving_replica")
                    and isinstance(ex, dict) and ex.get("id")):
                v = float(ex.get("value", 0.0))
                if slowest is None or v > slowest["latency_s"]:
                    slowest = {"request_id": str(ex["id"]),
                               "latency_s": v, "replica": comp}
        return {
            "replicas": len(replicas),
            "tokens_per_sec": sum(tps.values()),
            "free_kv_blocks": sum(free.values()),
            "queue_depth": sum(queue.values()),
            "max_replica_p99_s": max(p99.values()) if p99 else None,
            "requests_completed": sum(completed.values()),
            "spec_acceptance_rate": (accepted / proposed
                                     if proposed else None),
            "prefix_hit_rate": (hits / (hits + misses)
                                if hits + misses else None),
            "kv_host_hit_blocks": kv_host,
            "kv_cas_hit_blocks": kv_cas,
            "kv_miss_blocks": kv_miss,
            "kv_promoted_blocks": kv_promoted,
            "kv_spilled_blocks": kv_spilled,
            "kv_tier_hit_rate": ((kv_host + kv_cas) / kv_looked
                                 if kv_looked else None),
            "slowest_request": slowest,
        }

    def exec_cache_rollup(self, fams: Optional[Dict[str, Any]] = None
                          ) -> Optional[Dict[str, Any]]:
        """Cluster view of the persistent executable cache
        (``xla_exec_cache_*`` from telemetry/xla.py + storage/
        exec_cache.py) summed across every reporter — trainers and
        serving replicas publish into the same ``cas/exec/`` namespace,
        so the interesting number is fleet-wide: how many compiles were
        skipped and how much compile wall-time that saved. None when no
        reporter has touched the cache (caching off — the default)."""
        fams = fams if fams is not None else self._families()

        def total(name: str, key: str = "value") -> float:
            return sum(float(s.get(key, 0))
                       for _, s in fams.get(name, {}).get("children", []))

        hits = total("xla_exec_cache_hits_total")
        misses = total("xla_exec_cache_misses_total")
        if not hits and not misses:
            return None
        load_count = total("xla_exec_cache_load_seconds", "count")
        load_sum = total("xla_exec_cache_load_seconds", "sum")
        return {
            "hits": int(hits),
            "misses": int(misses),
            "hit_rate": (hits / (hits + misses)) if hits + misses else None,
            "compile_time_saved_s": round(
                total("xla_exec_cache_saved_seconds_total"), 4),
            "load_seconds_total": round(load_sum, 4),
            "mean_load_s": (round(load_sum / load_count, 4)
                            if load_count else None),
        }

    def mesh_rollup(self, fams: Optional[Dict[str, Any]] = None
                    ) -> Optional[Dict[str, Any]]:
        """Mesh view over the collective-accounting and straggler families
        (telemetry/collectives.py + telemetry/mesh.py): collective op/byte
        totals by (kind, axis) summed across reporters — structure adds up
        when several programs are captured — straggler events by device,
        and the worst comm-vs-compute fraction across captured programs
        (worst, not average: the program closest to communication-bound is
        the one a topology change hurts first). None when nothing
        mesh-related has reported (single-device runs)."""
        fams = fams if fams is not None else self._families()
        ops: Dict[str, Dict[str, float]] = {}
        byts: Dict[str, Dict[str, float]] = {}
        for fam_name, dest in (("xla_collective_ops_total", ops),
                               ("xla_collective_bytes", byts)):
            for labels, s in fams.get(fam_name, {}).get("children", []):
                kind, axis = labels.get("kind"), labels.get("axis")
                if kind and axis:
                    by_axis = dest.setdefault(kind, {})
                    by_axis[axis] = by_axis.get(axis, 0.0) + float(
                        s.get("value", 0))
        stragglers: Dict[str, float] = {}
        for labels, s in fams.get("mesh_straggler_events_total",
                                  {}).get("children", []):
            dev = labels.get("device")
            if dev:
                stragglers[dev] = stragglers.get(dev, 0.0) + float(
                    s.get("value", 0))
        worst_frac: Optional[Tuple[str, float]] = None
        for labels, s in fams.get("xla_comm_compute_fraction",
                                  {}).get("children", []):
            v = float(s.get("value", 0))
            if worst_frac is None or v > worst_frac[1]:
                worst_frac = (labels.get("program", "?"), v)
        if not ops and not stragglers and worst_frac is None:
            return None
        return {
            "collective_ops": {k: dict(sorted(v.items()))
                               for k, v in sorted(ops.items())},
            "collective_bytes": {k: dict(sorted(v.items()))
                                 for k, v in sorted(byts.items())},
            "straggler_events": dict(sorted(stragglers.items())),
            "straggler_events_total": sum(stragglers.values()),
            "worst_comm_fraction": (
                {"program": worst_frac[0], "fraction": worst_frac[1]}
                if worst_frac is not None else None),
        }

    def _mesh_lines(self, fams: Dict[str, Any]) -> List[str]:
        """``dct_mesh_*`` rollup gauges for ``dump()`` — the scrapeable
        shape of :meth:`mesh_rollup` (the per-reporter series already
        export under their own names with trial/component labels)."""
        roll = self.mesh_rollup(fams)
        if roll is None:
            return []
        lines = []
        total_ops = sum(sum(v.values())
                        for v in roll["collective_ops"].values())
        total_bytes = sum(sum(v.values())
                          for v in roll["collective_bytes"].values())
        for name, v in (("dct_mesh_collective_ops", total_ops),
                        ("dct_mesh_collective_bytes", total_bytes),
                        ("dct_mesh_straggler_events",
                         roll["straggler_events_total"])):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(v)}")
        worst = roll.get("worst_comm_fraction")
        if worst is not None:
            lines.append("# TYPE dct_mesh_worst_comm_fraction gauge")
            lines.append(
                "dct_mesh_worst_comm_fraction"
                f"{_label_str({'program': worst['program']})} "
                f"{_fmt(worst['fraction'])}")
        return lines

    def _serving_fleet_lines(self, fams: Dict[str, Any]) -> List[str]:
        """``dct_fleet_*`` gauges for ``dump()`` — the scrapeable shape
        of :meth:`serving_fleet_rollup`."""
        roll = self.serving_fleet_rollup(fams)
        if roll is None:
            return []
        lines = []
        for name, key in (("dct_fleet_replicas", "replicas"),
                          ("dct_fleet_tokens_per_sec", "tokens_per_sec"),
                          ("dct_fleet_free_kv_blocks", "free_kv_blocks"),
                          ("dct_fleet_queue_depth", "queue_depth"),
                          ("dct_fleet_max_replica_p99_seconds",
                           "max_replica_p99_s"),
                          ("dct_fleet_requests_completed",
                           "requests_completed"),
                          ("dct_fleet_spec_acceptance_rate",
                           "spec_acceptance_rate"),
                          ("dct_fleet_prefix_hit_rate",
                           "prefix_hit_rate"),
                          ("dct_fleet_kv_host_hit_blocks",
                           "kv_host_hit_blocks"),
                          ("dct_fleet_kv_cas_hit_blocks",
                           "kv_cas_hit_blocks"),
                          ("dct_fleet_kv_promoted_blocks",
                           "kv_promoted_blocks"),
                          ("dct_fleet_kv_spilled_blocks",
                           "kv_spilled_blocks"),
                          ("dct_fleet_kv_tier_hit_rate",
                           "kv_tier_hit_rate")):
            v = roll.get(key)
            if v is None:
                continue
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(v)}")
        slowest = roll.get("slowest_request")
        if slowest:
            lines.append(
                '# EXEMPLAR dct_fleet_slowest_request'
                f'{{request_id="{slowest["request_id"]}"}} '
                f'{_fmt(slowest["latency_s"])}')
        return lines

    def _exec_cache_lines(self, fams: Dict[str, Any]) -> List[str]:
        """``dct_exec_cache_*`` gauges for ``dump()`` — the scrapeable
        shape of :meth:`exec_cache_rollup`."""
        roll = self.exec_cache_rollup(fams)
        if roll is None:
            return []
        lines = []
        for name, key in (("dct_exec_cache_hits", "hits"),
                          ("dct_exec_cache_misses", "misses"),
                          ("dct_exec_cache_hit_rate", "hit_rate"),
                          ("dct_exec_cache_saved_seconds",
                           "compile_time_saved_s"),
                          ("dct_exec_cache_mean_load_seconds",
                           "mean_load_s")):
            v = roll.get(key)
            if v is None:
                continue
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(v)}")
        return lines

    def _goodput_lines(self, fams: Dict[str, Any]) -> List[str]:
        """``dct_goodput_*`` families: the per-trial fraction under its
        canonical name plus the time-weighted cluster-wide fraction (the
        generic ``dct_cluster_goodput_fraction_avg`` rollup is unweighted,
        which is the wrong semantics for a utilization ratio)."""
        roll = self.goodput_rollup(fams)
        if not roll["by_trial"]:
            return []
        lines = ["# TYPE dct_goodput_fraction gauge"]
        for tid in sorted(roll["by_trial"]):
            frac = roll["by_trial"][tid]["goodput_fraction"]
            if frac is not None:
                lines.append(
                    f"dct_goodput_fraction{_label_str({'trial_id': tid})} "
                    f"{_fmt(frac)}")
        if roll["cluster_fraction"] is not None:
            lines.append("# TYPE dct_goodput_cluster_fraction gauge")
            lines.append(
                f"dct_goodput_cluster_fraction "
                f"{_fmt(roll['cluster_fraction'])}")
        return lines

    @staticmethod
    def _summary_lines(name: str, labels: Dict[str, str],
                       s: Dict[str, Any]) -> List[str]:
        out = []
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            if key in s:
                out.append(f"{name}{_label_str(labels, {'quantile': q})} "
                           f"{_fmt(s[key])}")
        out.append(f"{name}_sum{_label_str(labels)} {_fmt(s.get('sum', 0))}")
        out.append(f"{name}_count{_label_str(labels)} "
                   f"{int(s.get('count', 0))}")
        return out

    def _rollup_lines(self, name: str, fam: Dict[str, Any]) -> List[str]:
        children = fam["children"]
        if len(children) < 1:
            return []
        roll = f"dct_cluster_{name}"
        mtype = fam["type"]
        help_line = (f"# HELP {roll} "
                     f"{_escape_help('cluster rollup of ' + name)}")
        if mtype in ("counter", "gauge"):
            total = sum(float(s.get("value", 0)) for _, s in children)
            lines = [help_line,
                     f"# TYPE {roll} {mtype}",
                     f"{roll} {_fmt(total)}"]
            if mtype == "gauge" and len(children) > 1:
                lines.append(f"# TYPE {roll}_avg gauge")
                lines.append(f"{roll}_avg {_fmt(total / len(children))}")
            return lines
        if mtype == "histogram":
            count = sum(int(s.get("count", 0)) for _, s in children)
            total = sum(float(s.get("sum", 0)) for _, s in children)
            lines = [help_line, f"# TYPE {roll} summary"]
            if count:
                for q, key in (("0.5", "p50"), ("0.95", "p95"),
                               ("0.99", "p99")):
                    num = sum(float(s[key]) * int(s.get("count", 0))
                              for _, s in children if key in s)
                    lines.append(
                        f"{roll}{{quantile=\"{q}\"}} {_fmt(num / count)}")
            lines.append(f"{roll}_sum {_fmt(total)}")
            lines.append(f"{roll}_count {count}")
            return lines
        return []

    # -- CLI summary -------------------------------------------------------

    def summary(self, top_n: int = 10, *,
                stale_after_s: float = STALE_SOURCE_AFTER_SEC
                ) -> Dict[str, Any]:
        """Structured cluster summary for ``dct metrics``."""
        fams = self._families()

        def gauge_per_trial(*names: str) -> Dict[str, float]:
            out: Dict[str, float] = {}
            for name in names:
                for labels, s in fams.get(name, {}).get("children", []):
                    tid = labels.get("trial_id")
                    if tid is not None and tid not in out:
                        out[tid] = float(s.get("value", 0))
            return out

        throughput = gauge_per_trial("samples_per_sec", "samples_per_second")
        top = sorted(throughput.items(), key=lambda kv: -kv[1])[:top_n]

        quantiles: Dict[str, Dict[str, float]] = {}
        for name, fam in fams.items():
            if fam["type"] != "histogram":
                continue
            children = fam["children"]
            count = sum(int(s.get("count", 0)) for _, s in children)
            if not count:
                continue
            quantiles[name] = {
                q: sum(float(s.get(k, 0)) * int(s.get("count", 0))
                       for _, s in children) / count
                for q, k in (("p50", "p50"), ("p95", "p95"), ("p99", "p99"))
            }

        counters: Dict[str, float] = {}
        for name, fam in fams.items():
            if fam["type"] != "counter":
                continue
            interesting = (name.startswith("retries_")
                           or name.startswith("cas_")
                           or name.startswith("dct_master_sched_")
                           or "restart" in name or "fallback" in name
                           or "dropped" in name or "failures" in name
                           or "compiles" in name or "anomalies" in name
                           or "divergence" in name or "straggler" in name)
            if interesting:
                counters[name] = sum(float(s.get("value", 0))
                                     for _, s in fam["children"])
        # cross-trial straggler view: per-trial train_dispatch p50 — the
        # slowest host vs the cluster median. A mild skew is topology; a
        # big one plus step_time_anomalies_total on the same trial is a
        # straggler to act on (drain, reschedule).
        straggler: Optional[Dict[str, Any]] = None
        dispatch_p50: Dict[str, float] = {}
        for labels, s in fams.get("train_dispatch_seconds",
                                  {}).get("children", []):
            tid = labels.get("trial_id")
            if tid is not None and int(s.get("count", 0)) and "p50" in s:
                dispatch_p50[tid] = float(s["p50"])
        if dispatch_p50:
            med = statistics.median(dispatch_p50.values())
            slowest_tid = max(dispatch_p50, key=dispatch_p50.get)
            slowest = dispatch_p50[slowest_tid]
            straggler = {
                "slowest_trial": slowest_tid,
                "slowest_p50_s": slowest,
                "median_p50_s": med,
                "slowdown_ratio": (slowest / med) if med > 0 else 0.0,
            }
        with self._lock:
            n_trials = len(self._trials)
            mfu = gauge_per_trial("mfu")
            mfu_measured = gauge_per_trial("mfu_measured")
        ingest = {
            "batches": self._batches.value,
            "samples": self._samples.value,
            "duplicates": self._duplicates.value,
            "rejected": sum(
                m.value for m in self.registry.metrics()
                if m.name == "dct_master_ingest_rejected_total"),
        }
        ages = self.source_ages()
        stale = {src: round(age, 1) for src, age in sorted(ages.items())
                 if age > stale_after_s}
        return {
            "trials": n_trials,
            "sources": {"reporting": len(ages),
                        "stale_after_s": stale_after_s,
                        "stale": stale},
            "top_trials_by_throughput": top,
            "throughput_total": sum(throughput.values()),
            "mfu_by_trial": mfu,
            "mfu_measured_by_trial": mfu_measured,
            "straggler": straggler,
            "goodput": self.goodput_rollup(fams),
            "serving_fleet": self.serving_fleet_rollup(fams),
            "mesh": self.mesh_rollup(fams),
            "exec_cache": self.exec_cache_rollup(fams),
            "slo": self.slo_rollup(),
            "quantiles": quantiles,
            "counters": dict(sorted(counters.items())),
            "ingest": ingest,
        }


def format_summary(summary: Dict[str, Any]) -> str:
    """Human-readable rendering of :meth:`summary` for the CLI."""
    out: List[str] = []
    out.append(f"trials reporting: {summary['trials']}   "
               f"cluster throughput: "
               f"{summary['throughput_total']:.2f} samples/sec")
    sources = summary.get("sources") or {}
    if sources.get("stale"):
        cutoff = sources.get("stale_after_s", STALE_SOURCE_AFTER_SEC)
        out.append(
            f"STALE sources (no ingest in {cutoff:g}s — latest-wins "
            f"gauges below may be frozen): " + ", ".join(
                f"{src} ({age:.0f}s)"
                for src, age in sources["stale"].items()))
    if summary["top_trials_by_throughput"]:
        out.append("top trials by throughput:")
        for tid, sps in summary["top_trials_by_throughput"]:
            mfu = summary["mfu_by_trial"].get(tid)
            mfu_s = f"  mfu={mfu:.4f}" if mfu is not None else ""
            mmfu = summary.get("mfu_measured_by_trial", {}).get(tid)
            if mmfu is not None:
                mfu_s += f"  mfu_measured={mmfu:.4f}"
            out.append(f"  trial {tid}: {sps:.2f} samples/sec{mfu_s}")
    straggler = summary.get("straggler")
    if straggler:
        out.append(
            f"straggler: trial {straggler['slowest_trial']} "
            f"p50={straggler['slowest_p50_s']:.6f}s vs cluster median "
            f"{straggler['median_p50_s']:.6f}s "
            f"({straggler['slowdown_ratio']:.2f}x)")
    goodput = summary.get("goodput")
    if goodput and goodput.get("by_trial"):
        cf = goodput.get("cluster_fraction")
        cf_s = f"{cf:.1%}" if cf is not None else "n/a"
        out.append(f"goodput (cluster, time-weighted): {cf_s} over "
                   f"{goodput.get('wall_total_s', 0.0):.1f}s wall")
        for tid in sorted(goodput["by_trial"]):
            acct = goodput["by_trial"][tid]
            frac = acct.get("goodput_fraction")
            frac_s = f"{frac:.1%}" if frac is not None else "n/a"
            cats = acct.get("categories") or {}
            badput = sorted(
                ((c, s) for c, s in cats.items()
                 if c != "productive" and s > 0),
                key=lambda kv: -kv[1])[:3]
            bad_s = ("  top badput: " + ", ".join(
                f"{c}={s:.2f}s" for c, s in badput)) if badput else ""
            out.append(f"  trial {tid}: goodput {frac_s} of "
                       f"{acct.get('wall_s', 0.0):.2f}s{bad_s}")
    fleet = summary.get("serving_fleet")
    if fleet:
        p99 = fleet.get("max_replica_p99_s")
        p99_s = f"{p99:.4f}s" if p99 is not None else "n/a"
        out.append(
            f"serving fleet: {fleet['replicas']} replicas, "
            f"{fleet['tokens_per_sec']:.1f} tokens/sec aggregate, "
            f"{int(fleet['free_kv_blocks'])} free KV blocks, "
            f"queue depth {int(fleet['queue_depth'])}, "
            f"max replica p99 {p99_s}, "
            f"{int(fleet['requests_completed'])} requests completed")
        rates = []
        spec = fleet.get("spec_acceptance_rate")
        if spec is not None:
            rates.append(f"spec acceptance {spec:.1%}")
        hit = fleet.get("prefix_hit_rate")
        if hit is not None:
            rates.append(f"prefix hit-rate {hit:.1%}")
        slowest = fleet.get("slowest_request")
        if slowest:
            rates.append(
                f"slowest request {slowest['request_id']} "
                f"({slowest['latency_s']:.4f}s on {slowest['replica']})")
        if rates:
            out.append("  " + ", ".join(rates))
        if (fleet.get("kv_promoted_blocks") or fleet.get("kv_spilled_blocks")
                or fleet.get("kv_tier_hit_rate") is not None):
            kv_rate = fleet.get("kv_tier_hit_rate")
            kv_rate_s = f"{kv_rate:.1%}" if kv_rate is not None else "n/a"
            out.append(
                f"  kv: tier hit-rate {kv_rate_s} "
                f"(host {int(fleet.get('kv_host_hit_blocks', 0))} / "
                f"cas {int(fleet.get('kv_cas_hit_blocks', 0))} / "
                f"miss {int(fleet.get('kv_miss_blocks', 0))} blocks), "
                f"promoted {int(fleet.get('kv_promoted_blocks', 0))}, "
                f"spilled {int(fleet.get('kv_spilled_blocks', 0))}")
    mesh = summary.get("mesh")
    if mesh:
        ops = mesh.get("collective_ops") or {}
        op_parts = []
        for kind in sorted(ops):
            for axis, n in sorted(ops[kind].items()):
                op_parts.append(f"{kind}[{axis}]={int(n)}")
        if op_parts:
            out.append("mesh collectives: " + ", ".join(op_parts))
        ev = mesh.get("straggler_events") or {}
        if ev:
            out.append("mesh stragglers: " + ", ".join(
                f"{dev}={int(n)}" for dev, n in sorted(ev.items())))
        worst = mesh.get("worst_comm_fraction")
        if worst is not None:
            out.append(
                f"mesh comm fraction (worst program): "
                f"{worst['fraction']:.1%} ({worst['program']})")
    exec_cache = summary.get("exec_cache")
    if exec_cache:
        rate = exec_cache.get("hit_rate")
        rate_s = f"{rate:.1%}" if rate is not None else "n/a"
        mean_load = exec_cache.get("mean_load_s")
        load_s = (f", mean load {mean_load:.4f}s"
                  if mean_load is not None else "")
        out.append(
            f"exec cache: {exec_cache['hits']} hits / "
            f"{exec_cache['misses']} misses ({rate_s}), "
            f"saved {exec_cache['compile_time_saved_s']:.2f}s of "
            f"compile{load_s}")
    slo = summary.get("slo")
    if slo:
        parts = []
        for name, obj in sorted(slo.get("objectives", {}).items()):
            burn = obj["windows"]["5m"].get("burn_rate")
            burn_s = f"{burn:.2f}x" if burn is not None else "n/a"
            parts.append(f"{name} {obj['verdict']} (5m burn {burn_s})")
        out.append(f"slo: verdict {slo['verdict']} — " + ", ".join(parts))
    if summary["quantiles"]:
        out.append("latency quantiles (cluster, count-weighted):")
        for name, qs in sorted(summary["quantiles"].items()):
            out.append(f"  {name}: p50={qs['p50']:.6f} "
                       f"p95={qs['p95']:.6f} p99={qs['p99']:.6f}")
    if summary["counters"]:
        out.append("counters:")
        for name, v in summary["counters"].items():
            out.append(f"  {name}: {int(v)}")
    ing = summary["ingest"]
    out.append(f"ingestion: {int(ing['batches'])} batches / "
               f"{int(ing['samples'])} samples accepted, "
               f"{int(ing['rejected'])} rejected, "
               f"{int(ing['duplicates'])} duplicate batches dropped")
    return "\n".join(out)
