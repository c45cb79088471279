"""Experiment configuration — the port's trimmed copy of
``determined_clone_tpu/config/experiment.py``.

It keeps the fields the training loop reads, with the JAX package's
defaults, and raises :class:`ConfigError` where the JAX config does for
them: an unknown key, a value of the wrong type, an unknown searcher
name or storage type, a storage block without its path, a negative
``prefetch_depth``, ``steps_per_dispatch`` or ``scheduling_unit`` below
1, an unknown ``checkpoint_policy``, a fault rule without a point.
Blocks that describe the cluster and not the trial (labels, workspace,
log policies, ``serving``, ``environment``, ``data``) are accepted and
not parsed. Of the legacy (v0) spellings the JAX package
shims, only the horovod-era ``optimizations`` keys are accepted (and
ignored, as the shim drops them).

A block whose behaviour the port does not have yet raises
``NotImplementedError`` naming its ``ROADMAP.md`` item instead of
training without it: ``observability.enabled: true``, a cloud or
content-addressed ``checkpoint_storage`` type, and
``resources.slots_per_trial`` above 1.
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
_OBSERVABILITY_KEYS = {
    "enabled", "max_events", "ship_spans", "ship_metrics", "trace_path",
    "flight_dir", "flight_segment_events", "flight_segments", "goodput_dir",
    "anomaly_window", "anomaly_threshold", "anomaly_min_samples",
    "timeseries", "stale_after_s", "rules", "stock_slo_rules",
}
_FAULT_RULE_KEYS = {"point", "action", "nth", "times", "probability",
                    "delay_s", "exc", "message", "exit_code", "keep_bytes"}
_FAULT_ACTIONS = ("error", "delay", "truncate", "exit")
_FAULT_EXCS = ("fault", "io", "conn")
_LENGTH_UNITS = {"batches", "records", "epochs"}

_ROADMAP_PARALLELISM = ("ROADMAP.md, Queue 1: parallelism "
                        "(resources.slots_per_trial > 1)")
_ROADMAP_TELEMETRY = ("ROADMAP.md, Queue 1: the telemetry branch of the "
                      "training loop and DeviceMemoryMonitor")
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
        if slots > 1:
            raise NotImplementedError(
                f"resources.slots_per_trial={slots}: the port trains on one "
                f"card; multi-card training is not ported yet "
                f"({_ROADMAP_PARALLELISM})")
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


def _check_observability(raw: Any) -> None:
    raw = _mapping(raw, "observability")
    _known(raw, _OBSERVABILITY_KEYS, "observability")
    if raw.get("enabled", False):
        raise NotImplementedError(
            f"observability.enabled: the port's training loop has no "
            f"telemetry yet ({_ROADMAP_TELEMETRY})")


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
        if "observability" in raw:
            _check_observability(raw["observability"])
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
