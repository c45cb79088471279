"""Experiment configuration — the port's trimmed copy of
``determined_clone_tpu/config/experiment.py``.

It keeps the fields the training loop and the serving engine read, with
the JAX package's defaults, and raises :class:`ConfigError` where the
JAX config does for them: an unknown key, a value of the wrong type, an
unknown searcher name or storage type, a storage block without its
path, a negative ``prefetch_depth``, ``steps_per_dispatch`` or
``scheduling_unit`` below 1, an unknown ``checkpoint_policy``, a fault
rule without a point, and every check of the ``serving:`` block
(:class:`ServingConfig`, :class:`SpeculativeConfig`, with the JAX
package's messages). Blocks that describe the cluster and not the trial
(labels, workspace, log policies, ``environment``, ``data``) are
accepted and not parsed. Of the legacy (v0) spellings the JAX package
shims, only the horovod-era ``optimizations`` keys are accepted (and
ignored, as the shim drops them).

The ``observability:`` block is :class:`ObservabilityConfig`, the JAX
package's, with its checks and messages (its ``rules`` are validated as
the JAX ``AlertRule`` validates them; ``timeseries`` and ``rules`` are
read by the master's time-series store, in the JAX package too, and by
nothing in a trial).

A block whose behaviour the port does not have yet raises
``NotImplementedError`` naming its ``ROADMAP.md`` item instead of
training without it: a cloud or content-addressed ``checkpoint_storage``
type. ``resources.slots_per_trial``
above 1 is a trial over that many ranks (``exec/launch.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from determined_clone_tpu_torch.config.length import Length


class ConfigError(ValueError):
    """Invalid experiment configuration."""


_SEARCHER_NAMES = {"single", "random", "grid", "asha", "adaptive_asha",
                   "custom"}
_STORAGE_TYPES = {"shared_fs", "directory", "gcs", "s3", "azure", "cas"}
_PORTED_STORAGE = {"shared_fs", "directory"}
# every top-level key of the JAX package's experiment schema
_TOP_LEVEL = {
    "config_version", "name", "entrypoint", "template", "workspace",
    "project", "unmanaged", "labels", "searcher", "checkpoint_storage",
    "checkpoint_policy", "min_validation_period", "min_checkpoint_period",
    "perform_initial_validation", "max_restarts", "records_per_epoch",
    "scheduling_unit", "reproducibility", "resources", "hyperparameters",
    "log_policies", "profiling", "observability", "serving", "faults",
    "optimizations", "environment", "data",
}
_RESOURCES_KEYS = {"slots_per_trial", "resource_pool", "priority",
                   "topology", "max_slots"}
_SERVING_KEYS = {"max_batch", "max_prefill_len", "kv_block_size",
                 "kv_blocks", "max_queue_depth", "default_max_new_tokens",
                 "host", "port", "prefix_cache", "chunk_prefill_len",
                 "speculative"}
_SPECULATIVE_KEYS = {"enabled", "k", "draft_layers", "draft_d_model",
                     "draft_n_heads", "draft_d_ff"}
_FAULT_RULE_KEYS = {"point", "action", "nth", "times", "probability",
                    "delay_s", "exc", "message", "exit_code", "keep_bytes"}
_FAULT_ACTIONS = ("error", "delay", "truncate", "exit")
_FAULT_EXCS = ("fault", "io", "conn")
_LENGTH_UNITS = {"batches", "records", "epochs"}

_ROADMAP_STORAGE = "ROADMAP.md, Queue 1: the cloud storage managers"


def _mapping(raw: Any, where: str) -> Dict[str, Any]:
    if not isinstance(raw, dict):
        raise ConfigError(f"{where} must be a mapping, got {raw!r}")
    return raw


def _known(raw: Dict[str, Any], keys: set, where: str) -> None:
    unknown = sorted(set(raw) - keys)
    if unknown:
        raise ConfigError(f"{where}.{unknown[0]}: unknown field "
                          f"(known: {sorted(keys)})")


def _int(raw: Dict[str, Any], key: str, default: int, where: str) -> int:
    v = raw.get(key, default)
    if not isinstance(v, int) or isinstance(v, bool):
        raise ConfigError(f"{where}.{key}: expected integer, got "
                          f"{type(v).__name__}")
    return v


def _length(raw: Any, where: str) -> Length:
    if isinstance(raw, dict):
        _known(raw, _LENGTH_UNITS, where)
    try:
        return Length.from_dict(raw)
    except ValueError as e:
        raise ConfigError(f"{where}: {e}") from None


@dataclasses.dataclass
class SearcherConfig:
    """The searcher fields the loop reads; the search method's own
    settings are the master's and are not parsed."""
    name: str = "single"
    metric: str = "loss"
    smaller_is_better: bool = True
    max_length: Optional[Length] = None

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "SearcherConfig":
        raw = _mapping(raw, "searcher")
        name = raw.get("name", "single")
        if name not in _SEARCHER_NAMES:
            raise ConfigError(f"unknown searcher name {name!r}; expected one "
                              f"of {sorted(_SEARCHER_NAMES)}")
        metric = raw.get("metric", "loss")
        if not isinstance(metric, str):
            raise ConfigError(f"searcher.metric: expected string, got "
                              f"{type(metric).__name__}")
        smaller = raw.get("smaller_is_better", True)
        if not isinstance(smaller, bool):
            raise ConfigError("searcher.smaller_is_better: expected boolean")
        return SearcherConfig(
            name=name, metric=metric, smaller_is_better=smaller,
            max_length=(_length(raw["max_length"], "searcher.max_length")
                        if "max_length" in raw else None))


@dataclasses.dataclass
class ResourcesConfig:
    slots_per_trial: int = 1

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "ResourcesConfig":
        raw = _mapping(raw, "resources")
        _known(raw, _RESOURCES_KEYS, "resources")
        slots = _int(raw, "slots_per_trial", 1, "resources")
        if slots < 0:
            raise ConfigError(
                f"resources.slots_per_trial must be >= 0, got {slots}")
        return ResourcesConfig(slots_per_trial=slots)


@dataclasses.dataclass
class CheckpointStorageConfig:
    type: str = "shared_fs"
    host_path: Optional[str] = None       # shared_fs
    storage_path: Optional[str] = None    # shared_fs subdirectory
    container_path: Optional[str] = None  # directory

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "CheckpointStorageConfig":
        raw = _mapping(raw, "checkpoint_storage")
        t = raw.get("type")
        if t not in _STORAGE_TYPES:
            raise ConfigError(f"unknown checkpoint_storage.type {t!r}; "
                              f"expected one of {sorted(_STORAGE_TYPES)}")
        if t not in _PORTED_STORAGE:
            raise NotImplementedError(
                f"checkpoint_storage.type {t!r} is not ported yet "
                f"({_ROADMAP_STORAGE}); use shared_fs or directory")
        cfg = CheckpointStorageConfig(
            type=t, host_path=raw.get("host_path"),
            storage_path=raw.get("storage_path"),
            container_path=raw.get("container_path"))
        if t == "shared_fs" and not cfg.host_path:
            raise ConfigError("checkpoint_storage.host_path is required for "
                              "shared_fs storage")
        if t == "directory" and not cfg.container_path:
            raise ConfigError("checkpoint_storage.container_path is "
                              "required for directory storage")
        return cfg


@dataclasses.dataclass
class OptimizationsConfig:
    prefetch_depth: int = 2        # device batches buffered ahead (0 = sync)
    steps_per_dispatch: int = 1    # optimizer steps per dispatch

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "OptimizationsConfig":
        # other keys are the legacy (horovod-era) knobs, which the JAX
        # package's shim drops: ignored here too
        raw = _mapping(raw, "optimizations")
        cfg = OptimizationsConfig(
            prefetch_depth=_int(raw, "prefetch_depth", 2, "optimizations"),
            steps_per_dispatch=_int(raw, "steps_per_dispatch", 1,
                                    "optimizations"))
        if cfg.prefetch_depth < 0:
            raise ConfigError(f"optimizations.prefetch_depth must be >= 0, "
                              f"got {cfg.prefetch_depth}")
        if cfg.steps_per_dispatch < 1:
            raise ConfigError(f"optimizations.steps_per_dispatch must be "
                              f">= 1, got {cfg.steps_per_dispatch}")
        return cfg


@dataclasses.dataclass
class FaultsConfig:
    enabled: bool = True
    seed: int = 0
    rules: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "FaultsConfig":
        raw = _mapping(raw, "faults")
        _known(raw, {"enabled", "seed", "rules"}, "faults")
        cfg = FaultsConfig(enabled=bool(raw.get("enabled", True)),
                           seed=_int(raw, "seed", 0, "faults"),
                           rules=[dict(r) for r in raw.get("rules") or []])
        for i, rule in enumerate(cfg.rules):
            where = f"faults.rules[{i}]"
            _known(rule, _FAULT_RULE_KEYS, where)
            if not rule.get("point"):
                raise ConfigError(f"{where} requires a `point`")
            if rule.get("action", "error") not in _FAULT_ACTIONS:
                raise ConfigError(f"{where}.action must be one of "
                                  f"{_FAULT_ACTIONS}, got {rule['action']!r}")
            if rule.get("exc", "fault") not in _FAULT_EXCS:
                raise ConfigError(f"{where}.exc must be one of {_FAULT_EXCS}"
                                  f", got {rule['exc']!r}")
            if not 0.0 <= float(rule.get("probability", 1.0)) <= 1.0:
                raise ConfigError(f"{where}.probability must be in [0, 1]")
        return cfg


@dataclasses.dataclass
class SpeculativeConfig:
    """The ``serving.speculative:`` block — draft-model speculative
    decoding. The draft GPT shares the target's vocabulary and
    max_seq_len; only its depth and widths are chosen here. Greedy output
    equals plain decode whatever the draft — a bad draft costs speed."""
    enabled: bool = False
    k: int = 4                      # draft tokens proposed per iteration
    draft_layers: int = 1
    draft_d_model: int = 128
    draft_n_heads: int = 2
    draft_d_ff: int = 512

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "SpeculativeConfig":
        if not isinstance(raw, dict):
            raise ConfigError(
                f"serving.speculative must be a mapping, got {raw!r}")
        cfg = SpeculativeConfig(
            enabled=bool(raw.get("enabled", False)),
            k=int(raw.get("k", 4)),
            draft_layers=int(raw.get("draft_layers", 1)),
            draft_d_model=int(raw.get("draft_d_model", 128)),
            draft_n_heads=int(raw.get("draft_n_heads", 2)),
            draft_d_ff=int(raw.get("draft_d_ff", 512)),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if not 1 <= self.k <= 16:
            raise ConfigError(
                f"serving.speculative.k must be in [1, 16], got {self.k}")
        for name, v in (("draft_layers", self.draft_layers),
                        ("draft_d_model", self.draft_d_model),
                        ("draft_n_heads", self.draft_n_heads),
                        ("draft_d_ff", self.draft_d_ff)):
            if v < 1:
                raise ConfigError(
                    f"serving.speculative.{name} must be >= 1, got {v}")
        if self.draft_d_model % self.draft_n_heads:
            raise ConfigError(
                f"serving.speculative.draft_d_model "
                f"{self.draft_d_model} must divide by draft_n_heads "
                f"{self.draft_n_heads}")


@dataclasses.dataclass
class ServingConfig:
    """The ``serving:`` block: the engine's shape and capacity contract
    (buckets bound the program count, KV blocks bound concurrent
    context, queue depth is the admission valve) and its speed
    features."""
    max_batch: int = 8              # largest (pow2) batch bucket
    max_prefill_len: int = 128      # largest (pow2) prompt-length bucket
    kv_block_size: int = 16         # KV pool block size (pow2 positions)
    kv_blocks: int = 0              # pool blocks; 0 = size for max_batch
    max_queue_depth: int = 64       # admission valve → 429/ServerOverloaded
    default_max_new_tokens: int = 64
    host: str = "127.0.0.1"
    port: int = 8191
    prefix_cache: bool = False      # copy-on-write prompt-prefix sharing
    chunk_prefill_len: int = 0      # 0 = off; else a prefill bucket size
    speculative: SpeculativeConfig = dataclasses.field(
        default_factory=SpeculativeConfig)

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "ServingConfig":
        if not isinstance(raw, dict):
            raise ConfigError(f"serving must be a mapping, got {raw!r}")
        cfg = ServingConfig(
            max_batch=int(raw.get("max_batch", 8)),
            max_prefill_len=int(raw.get("max_prefill_len", 128)),
            kv_block_size=int(raw.get("kv_block_size", 16)),
            kv_blocks=int(raw.get("kv_blocks", 0)),
            max_queue_depth=int(raw.get("max_queue_depth", 64)),
            default_max_new_tokens=int(raw.get("default_max_new_tokens", 64)),
            host=str(raw.get("host", "127.0.0.1")),
            port=int(raw.get("port", 8191)),
            prefix_cache=bool(raw.get("prefix_cache", False)),
            chunk_prefill_len=int(raw.get("chunk_prefill_len", 0)),
            speculative=SpeculativeConfig.from_dict(
                raw.get("speculative", {})),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        for name, v in (("max_batch", self.max_batch),
                        ("max_prefill_len", self.max_prefill_len),
                        ("kv_block_size", self.kv_block_size)):
            if v < 1 or v & (v - 1):
                raise ConfigError(
                    f"serving.{name} must be a power of two >= 1, got {v}")
        if self.kv_blocks < 0:
            raise ConfigError(
                f"serving.kv_blocks must be >= 0 (0 = auto), "
                f"got {self.kv_blocks}")
        if self.max_queue_depth < 1:
            raise ConfigError(
                f"serving.max_queue_depth must be >= 1, "
                f"got {self.max_queue_depth}")
        if self.default_max_new_tokens < 1:
            raise ConfigError(
                f"serving.default_max_new_tokens must be >= 1, "
                f"got {self.default_max_new_tokens}")
        if not 0 < self.port < 65536:
            raise ConfigError(
                f"serving.port must be in (0, 65536), got {self.port}")
        if self.chunk_prefill_len < 0:
            raise ConfigError(
                f"serving.chunk_prefill_len must be >= 0 (0 = off), "
                f"got {self.chunk_prefill_len}")
        if self.chunk_prefill_len:
            v = self.chunk_prefill_len
            if (v & (v - 1) or v > self.max_prefill_len
                    or v < min(8, self.max_prefill_len)):
                raise ConfigError(
                    f"serving.chunk_prefill_len must be a power of two "
                    f"in [{min(8, self.max_prefill_len)}, "
                    f"{self.max_prefill_len}] (it must land on a prefill "
                    f"bucket), got {v}")
        self.speculative.validate()

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _serving(raw: Any) -> ServingConfig:
    """The ``serving:`` block with its unknown keys refused, as the JAX
    package's schema refuses them before ``ServingConfig.from_dict``."""
    raw = _mapping(raw, "serving")
    _known(raw, _SERVING_KEYS, "serving")
    spec = raw.get("speculative", {})
    if isinstance(spec, dict):
        _known(spec, _SPECULATIVE_KEYS, "serving.speculative")
    return ServingConfig.from_dict(raw)


# the alert-rule vocabulary of the JAX package's telemetry/rules.py
_RULE_KINDS = ("threshold", "rate_of_change", "burn_rate", "absence")
_RULE_SEVERITIES = ("page", "ticket")
_RULE_OPS = ("gt", "ge", "lt", "le")
_RULE_REDUCES = ("avg", "max", "min", "last")
_RULE_KEYS = {"name", "kind", "series", "labels", "window_s", "reduce",
              "op", "value", "for_s", "severity", "stale_s", "windows",
              "threshold", "objective", "bad_series", "total_series"}


def _check_alert_rule(raw: Any) -> None:
    """Raise ``ValueError`` or ``TypeError`` where the JAX package's
    ``AlertRule.from_dict`` does, with its messages."""
    if not isinstance(raw, dict):
        raise ValueError(f"alert rule must be a mapping, got {raw!r}")
    unknown = set(raw) - _RULE_KEYS
    if unknown:
        raise ValueError(
            f"alert rule {raw.get('name', '?')!r}: unknown keys "
            f"{sorted(unknown)}")
    if not raw.get("name") or not raw.get("kind"):
        raise ValueError(f"alert rule needs name + kind, got {raw!r}")
    name, kind = str(raw["name"]), str(raw["kind"])
    series, value = raw.get("series"), raw.get("value")
    stale_s, windows = raw.get("stale_s"), raw.get("windows")
    threshold, objective = raw.get("threshold"), raw.get("objective")
    severity = raw.get("severity", "ticket")
    op, reduce = raw.get("op", "gt"), raw.get("reduce", "avg")
    if kind not in _RULE_KINDS:
        raise ValueError(f"rule {name!r}: unknown kind {kind!r} "
                         f"(one of {_RULE_KINDS})")
    if severity not in _RULE_SEVERITIES:
        raise ValueError(f"rule {name!r}: severity must be one of "
                         f"{_RULE_SEVERITIES}, got {severity!r}")
    if op not in _RULE_OPS:
        raise ValueError(f"rule {name!r}: op must be one of "
                         f"{sorted(_RULE_OPS)}, got {op!r}")
    if reduce not in _RULE_REDUCES:
        raise ValueError(f"rule {name!r}: reduce must be one of "
                         f"{_RULE_REDUCES}, got {reduce!r}")
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
        if raw.get("bad_series"):
            if not raw.get("total_series") or objective is None:
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
    # the conversions the JAX rule's constructor makes
    dict(raw.get("labels") or {})
    float(raw.get("window_s", 300.0))
    float(raw.get("for_s", 0.0))
    if stale_s is not None:
        float(stale_s)
    list(windows or [])


@dataclasses.dataclass
class ObservabilityConfig:
    """Trial-side telemetry (``telemetry_from_config``): spans, the
    metrics registry, the Chrome trace, the flight recorder, the goodput
    journal and the step-time anomaly detector. Disabled by default, so
    the trainer's hot loop runs unwrapped."""

    enabled: bool = False
    max_events: int = 200_000      # span-record cap (head kept, tail dropped)
    ship_spans: bool = False       # ship span records to the profiler
    ship_metrics: bool = True      # ship registry snapshots to it
    trace_path: Optional[str] = None  # trace.json destination; None = default
    # flight recorder (crash black box, telemetry/flight.py); None = off
    flight_dir: Optional[str] = None
    flight_segment_events: int = 256  # records per segment file
    flight_segments: int = 8          # ring size (oldest deleted)
    # goodput ledger journal (telemetry/goodput.py); None = ledger in
    # memory only (still published as goodput_* gauges)
    goodput_dir: Optional[str] = None
    # step-time anomaly detector (rolling median/MAD over train_dispatch)
    anomaly_window: int = 64       # rolling baseline length
    anomaly_threshold: float = 5.0  # MAD multiples above median to fire
    anomaly_min_samples: int = 16  # warmup before the detector arms
    # the master's time-series store; None = not enabled
    timeseries: Optional[Dict[str, Any]] = None
    stale_after_s: float = 60.0
    # declarative alert rules for the master's rule engine
    rules: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    stock_slo_rules: bool = False

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "ObservabilityConfig":
        if not isinstance(raw, dict):
            raise ConfigError(f"observability must be a mapping, got {raw!r}")
        cfg = ObservabilityConfig(
            enabled=bool(raw.get("enabled", False)),
            max_events=int(raw.get("max_events", 200_000)),
            ship_spans=bool(raw.get("ship_spans", False)),
            ship_metrics=bool(raw.get("ship_metrics", True)),
            trace_path=raw.get("trace_path"),
            flight_dir=raw.get("flight_dir"),
            flight_segment_events=int(raw.get("flight_segment_events", 256)),
            flight_segments=int(raw.get("flight_segments", 8)),
            goodput_dir=raw.get("goodput_dir"),
            anomaly_window=int(raw.get("anomaly_window", 64)),
            anomaly_threshold=float(raw.get("anomaly_threshold", 5.0)),
            anomaly_min_samples=int(raw.get("anomaly_min_samples", 16)),
            timeseries=raw.get("timeseries"),
            stale_after_s=float(raw.get("stale_after_s", 60.0)),
            rules=list(raw.get("rules") or []),
            stock_slo_rules=bool(raw.get("stock_slo_rules", False)),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.max_events < 1:
            raise ConfigError(
                f"observability.max_events must be >= 1, "
                f"got {self.max_events}")
        if self.flight_segment_events < 1:
            raise ConfigError(
                f"observability.flight_segment_events must be >= 1, "
                f"got {self.flight_segment_events}")
        if self.flight_segments < 2:
            raise ConfigError(
                f"observability.flight_segments must be >= 2, "
                f"got {self.flight_segments}")
        if self.anomaly_window < 4:
            raise ConfigError(
                f"observability.anomaly_window must be >= 4, "
                f"got {self.anomaly_window}")
        if self.anomaly_threshold <= 0:
            raise ConfigError(
                f"observability.anomaly_threshold must be > 0, "
                f"got {self.anomaly_threshold}")
        if self.anomaly_min_samples < 2:
            raise ConfigError(
                f"observability.anomaly_min_samples must be >= 2, "
                f"got {self.anomaly_min_samples}")
        if self.timeseries is not None and not isinstance(self.timeseries,
                                                          dict):
            raise ConfigError(
                f"observability.timeseries must be a mapping, "
                f"got {self.timeseries!r}")
        if self.stale_after_s <= 0:
            raise ConfigError(
                f"observability.stale_after_s must be > 0, "
                f"got {self.stale_after_s}")
        for i, rule in enumerate(self.rules):
            try:
                _check_alert_rule(rule)
            except (TypeError, ValueError) as e:
                raise ConfigError(
                    f"observability.rules[{i}]: {e}") from e

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


# the JAX package's experiment schema for the block (config/schema.py),
# with its quirks: a rule's ``objective`` is typed a string there
_NUM, _INT, _STR, _BOOL = ({"type": t} for t in (
    "number", "integer", "string", "boolean"))
_OBSERVABILITY_SCHEMA = {
    "type": "object", "open": False,
    "properties": {
        "enabled": _BOOL, "max_events": _INT, "ship_spans": _BOOL,
        "ship_metrics": _BOOL, "trace_path": _STR, "flight_dir": _STR,
        "flight_segment_events": _INT, "flight_segments": _INT,
        "goodput_dir": _STR, "anomaly_window": _INT,
        "anomaly_threshold": _NUM, "anomaly_min_samples": _INT,
        "timeseries": {
            "type": "object", "open": False,
            "properties": {
                "enabled": _BOOL, "scrape_period_s": _NUM,
                "capacity_per_series": _INT, "coarse_step_s": _NUM,
                "coarse_capacity": _INT, "memory_budget_mb": _NUM,
                "max_series": _INT, "persist_dir": _STR,
                "segment_scrapes": _INT, "max_segments": _INT,
            },
        },
        "stale_after_s": _NUM,
        "rules": {
            "type": "array",
            "items": {
                "type": "object", "open": False,
                "properties": {
                    "name": _STR,
                    "kind": {"type": "string", "enum": list(_RULE_KINDS)},
                    "series": _STR,
                    "labels": {"type": "object", "open": True},
                    "window_s": _NUM, "reduce": _STR,
                    "op": {"type": "string", "enum": list(_RULE_OPS)},
                    "value": _NUM, "for_s": _NUM,
                    "severity": {"type": "string",
                                 "enum": list(_RULE_SEVERITIES)},
                    "stale_s": _NUM,
                    "windows": {"type": "array",
                                "items": {"anyOf": [_STR, _NUM]}},
                    "threshold": _NUM, "objective": _STR,
                    "bad_series": _STR, "total_series": _STR,
                },
                "required": ["name", "kind"],
            },
        },
        "stock_slo_rules": _BOOL,
    },
}


def _type_ok(schema_type: str, value: Any) -> bool:
    if schema_type == "integer":
        return isinstance(value, int) and not isinstance(value, bool)
    if schema_type == "number":
        return (isinstance(value, (int, float))
                and not isinstance(value, bool))
    return isinstance(value, {"string": str, "boolean": bool,
                              "array": list, "object": dict}[schema_type])


def _schema_errors(value: Any, schema: Dict[str, Any], path: str
                   ) -> List[str]:
    """The JAX schema validator's errors for ``value`` (the subset of its
    forms the block uses: types, enums, objects, arrays, anyOf)."""
    if "anyOf" in schema:
        attempts = [_schema_errors(value, sub, path)
                    for sub in schema["anyOf"]]
        if any(not a for a in attempts):
            return []
        return [f"{path}: no alternative matched: " +
                "; ".join(a[0] for a in attempts if a)]
    stype = schema["type"]
    if not _type_ok(stype, value):
        return [f"{path}: expected {stype}, got {type(value).__name__}"]
    errors: List[str] = []
    if "enum" in schema and value not in schema["enum"]:
        errors.append(f"{path}: expected one of {schema['enum']}, "
                      f"got {value!r}")
    if stype == "object":
        props = schema.get("properties", {})
        for req in schema.get("required", []):
            if req not in value:
                errors.append(f"{path}.{req}: required field missing")
        for key, sub in value.items():
            if key in props:
                errors.extend(_schema_errors(sub, props[key],
                                             f"{path}.{key}"))
            elif not schema.get("open", False):
                errors.append(f"{path}.{key}: unknown field "
                              f"(known: {sorted(props)})")
    elif stype == "array" and "items" in schema:
        for i, item in enumerate(value):
            errors.extend(_schema_errors(item, schema["items"],
                                         f"{path}[{i}]"))
    return errors


def _observability(raw: Any) -> ObservabilityConfig:
    """The ``observability:`` block checked against the JAX package's
    schema (types, enums, unknown keys) before
    :meth:`ObservabilityConfig.from_dict`, as the JAX config checks it."""
    errors = _schema_errors(raw, _OBSERVABILITY_SCHEMA,
                            "<config>.observability")
    if errors:
        raise ConfigError("invalid experiment config:\n  "
                          + "\n  ".join(errors))
    return ObservabilityConfig.from_dict(raw)


@dataclasses.dataclass
class ExperimentConfig:
    searcher: SearcherConfig = dataclasses.field(
        default_factory=SearcherConfig)
    resources: ResourcesConfig = dataclasses.field(
        default_factory=ResourcesConfig)
    hyperparameters: Dict[str, Any] = dataclasses.field(default_factory=dict)
    checkpoint_storage: Optional[CheckpointStorageConfig] = None
    optimizations: OptimizationsConfig = dataclasses.field(
        default_factory=OptimizationsConfig)
    faults: Optional[FaultsConfig] = None
    serving: Optional[ServingConfig] = None
    observability: ObservabilityConfig = dataclasses.field(
        default_factory=ObservabilityConfig)
    checkpoint_policy: str = "best"     # best | all | none
    min_validation_period: Optional[Length] = None
    min_checkpoint_period: Optional[Length] = None
    records_per_epoch: int = 0
    scheduling_unit: int = 100          # batches per searcher unit
    experiment_seed: int = 0            # reproducibility.experiment_seed

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "ExperimentConfig":
        if not isinstance(raw, dict):
            raise ConfigError(f"experiment config must be a mapping, got "
                              f"{type(raw).__name__}")
        _known(raw, _TOP_LEVEL, "<config>")
        repro = _mapping(raw.get("reproducibility") or {}, "reproducibility")
        _known(repro, {"experiment_seed"}, "reproducibility")
        hparams = raw.get("hyperparameters") or {}
        cfg = ExperimentConfig(
            searcher=SearcherConfig.from_dict(raw.get("searcher", {})),
            resources=ResourcesConfig.from_dict(raw.get("resources", {})),
            hyperparameters=_mapping(hparams, "hyperparameters"),
            checkpoint_storage=(
                CheckpointStorageConfig.from_dict(raw["checkpoint_storage"])
                if raw.get("checkpoint_storage") else None),
            optimizations=OptimizationsConfig.from_dict(
                raw.get("optimizations") or {}),
            faults=(FaultsConfig.from_dict(raw["faults"])
                    if raw.get("faults") else None),
            serving=(_serving(raw["serving"]) if raw.get("serving")
                     else None),
            observability=(_observability(raw["observability"])
                           if "observability" in raw
                           else ObservabilityConfig()),
            checkpoint_policy=raw.get("checkpoint_policy", "best"),
            min_validation_period=(
                _length(raw["min_validation_period"], "min_validation_period")
                if "min_validation_period" in raw else None),
            min_checkpoint_period=(
                _length(raw["min_checkpoint_period"], "min_checkpoint_period")
                if "min_checkpoint_period" in raw else None),
            records_per_epoch=_int(raw, "records_per_epoch", 0, "<config>"),
            scheduling_unit=_int(raw, "scheduling_unit", 100, "<config>"),
            experiment_seed=_int(repro, "experiment_seed", 0,
                                 "reproducibility"))
        if cfg.checkpoint_policy not in ("best", "all", "none"):
            raise ConfigError(f"checkpoint_policy must be best|all|none, got "
                              f"{cfg.checkpoint_policy!r}")
        if cfg.scheduling_unit < 1:
            raise ConfigError(f"scheduling_unit must be >= 1, got "
                              f"{cfg.scheduling_unit}")
        return cfg

    @staticmethod
    def from_yaml(path: str) -> "ExperimentConfig":
        import yaml  # lazy: only YAML callers need PyYAML

        with open(path) as f:
            return ExperimentConfig.from_dict(yaml.safe_load(f) or {})
