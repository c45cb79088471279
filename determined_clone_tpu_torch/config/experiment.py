"""Experiment configuration — the port's copy of
``determined_clone_tpu/config/experiment.py``: every block, its defaults,
its checks and its messages, and the same pipeline (expconf/parse.go):
legacy (v0) spellings shimmed (``config/shims.py``, the notes kept in
``ExperimentConfig.deprecations``), the raw mapping validated against the
schema as data (``config/schema.py``), then the dataclasses parse values.
``hyperparameters`` is a :class:`HyperparameterSpace`; its ``raw`` is the
mapping a trial reads.

An ``observability.rules`` entry is validated by the port's own
``telemetry/rules.py`` (``AlertRule.from_dict``), as the JAX package
validates it with its own.

A block whose behaviour the port does not have yet raises
``NotImplementedError`` naming its ``ROADMAP.md`` item instead of
training without it: a cloud or content-addressed ``checkpoint_storage``
type, after the JAX package's own checks of the block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from determined_clone_tpu_torch.config.hyperparameters import (
    HyperparameterSpace,
)
from determined_clone_tpu_torch.config.length import Length


class ConfigError(ValueError):
    """Invalid experiment configuration."""


# ---------------------------------------------------------------------------
# Searcher union (reference: expconf/searcher_config.go:16-28)
# ---------------------------------------------------------------------------

_SEARCHER_NAMES = {"single", "random", "grid", "asha", "adaptive_asha", "custom"}


@dataclasses.dataclass
class SearcherConfig:
    name: str = "single"
    metric: str = "loss"
    smaller_is_better: bool = True
    max_length: Optional[Length] = None
    # random
    max_trials: int = 1
    # asha / adaptive_asha
    max_time: Optional[int] = None      # rungs ceiling, in scheduling units
    num_rungs: int = 5
    divisor: int = 4
    max_concurrent_trials: int = 16
    # adaptive_asha
    mode: str = "standard"              # aggressive | standard | conservative
    bracket_rungs: Optional[List[int]] = None
    # single / stopping-based asha
    stop_once: bool = False
    # source-of-truth blob for anything extra (custom searchers)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "SearcherConfig":
        if not isinstance(raw, dict):
            raise ConfigError(f"searcher must be a mapping, got {raw!r}")
        name = raw.get("name", "single")
        if name not in _SEARCHER_NAMES:
            raise ConfigError(
                f"unknown searcher name {name!r}; expected one of {sorted(_SEARCHER_NAMES)}"
            )
        known = {f.name for f in dataclasses.fields(SearcherConfig)} - {"extra"}
        cfg = SearcherConfig(
            name=name,
            metric=raw.get("metric", "loss"),
            smaller_is_better=bool(raw.get("smaller_is_better", True)),
            max_length=Length.from_dict(raw["max_length"]) if "max_length" in raw else None,
            max_trials=int(raw.get("max_trials", 1)),
            max_time=raw.get("max_time"),
            num_rungs=int(raw.get("num_rungs", 5)),
            divisor=int(raw.get("divisor", 4)),
            max_concurrent_trials=int(raw.get("max_concurrent_trials", 16)),
            mode=raw.get("mode", "standard"),
            bracket_rungs=raw.get("bracket_rungs"),
            stop_once=bool(raw.get("stop_once", False)),
            extra={k: v for k, v in raw.items() if k not in known},
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.name in ("random", "grid", "asha", "adaptive_asha") and self.max_trials < 1:
            raise ConfigError(f"searcher.max_trials must be >= 1, got {self.max_trials}")
        if self.name in ("asha", "adaptive_asha"):
            if self.divisor < 2:
                raise ConfigError(f"searcher.divisor must be >= 2, got {self.divisor}")
            if self.num_rungs < 1:
                raise ConfigError(f"searcher.num_rungs must be >= 1, got {self.num_rungs}")
        if self.name == "adaptive_asha" and self.mode not in (
            "aggressive", "standard", "conservative",
        ):
            raise ConfigError(f"unknown adaptive_asha mode {self.mode!r}")

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "metric": self.metric,
            "smaller_is_better": self.smaller_is_better,
        }
        if self.max_length is not None:
            d["max_length"] = self.max_length.to_dict()
        if self.name in ("random", "grid", "asha", "adaptive_asha"):
            d["max_trials"] = self.max_trials
        if self.name in ("asha", "adaptive_asha"):
            d.update(
                max_time=self.max_time, num_rungs=self.num_rungs, divisor=self.divisor,
                max_concurrent_trials=self.max_concurrent_trials, stop_once=self.stop_once,
            )
        if self.name == "adaptive_asha":
            d["mode"] = self.mode
        d.update(self.extra)
        return d


# ---------------------------------------------------------------------------
# Resources (slots per trial: ranks, one card each; the topology fields
# are the JAX package's and are kept so either package reads the other's
# configs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ResourcesConfig:
    slots_per_trial: int = 1            # ranks per trial (gang size)
    topology: Optional[str] = None      # e.g. "v5e-8", "2x4"; None = any fit
    slices: int = 1                     # multislice: gang N whole slices
                                        # (DCN between them); topology is
                                        # then the per-slice shape
    resource_pool: str = "default"
    priority: Optional[int] = None      # priority-scheduler weight
    max_slots: Optional[int] = None     # cap across concurrent trials

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "ResourcesConfig":
        topo = raw.get("topology")
        slices = 1
        if isinstance(topo, dict):
            slices = int(topo.get("slices", 1))
            topo = topo.get("slice_shape")
        cfg = ResourcesConfig(
            slots_per_trial=int(raw.get("slots_per_trial", 1)),
            topology=topo,
            slices=slices,
            resource_pool=raw.get("resource_pool", "default"),
            priority=int(raw["priority"]) if raw.get("priority") is not None else None,
            max_slots=raw.get("max_slots"),
        )
        if cfg.slices < 1:
            raise ConfigError(
                f"resources.topology.slices must be >= 1, got {cfg.slices}")
        if cfg.slices > 1 and (cfg.slots_per_trial < cfg.slices
                               or cfg.slots_per_trial % cfg.slices != 0):
            raise ConfigError(
                f"slots_per_trial ({cfg.slots_per_trial}) must divide evenly "
                f"into {cfg.slices} slices (at least one chip per slice)")
        if cfg.slots_per_trial < 0:
            raise ConfigError(f"resources.slots_per_trial must be >= 0, got {cfg.slots_per_trial}")
        if cfg.priority is not None and not (1 <= int(cfg.priority) <= 99):
            raise ConfigError("resources.priority must be in [1, 99]")
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if v is not None}
        if d.pop("slices", 1) > 1:
            # round-trip the multislice object form the master parses
            d["topology"] = {"slices": self.slices,
                            "slice_shape": self.topology}
            if self.topology is None:
                d["topology"].pop("slice_shape")
        return d


# ---------------------------------------------------------------------------
# Checkpoint storage union (reference: expconf checkpoint_storage_config;
# harness/determined/common/storage backends)
# ---------------------------------------------------------------------------

_STORAGE_TYPES = {"shared_fs", "directory", "gcs", "s3", "azure", "cas"}
_PORTED_STORAGE = {"shared_fs", "directory"}
_ROADMAP_STORAGE = "ROADMAP.md, Queue 1: the cloud storage managers"


@dataclasses.dataclass
class CheckpointStorageConfig:
    type: str = "shared_fs"
    host_path: Optional[str] = None       # shared_fs
    storage_path: Optional[str] = None    # shared_fs subdir / directory path
    container_path: Optional[str] = None  # directory
    bucket: Optional[str] = None          # gcs / s3
    prefix: Optional[str] = None          # gcs / s3 / azure
    container: Optional[str] = None       # azure blob container
    connection_string: Optional[str] = None  # azure
    save_experiment_best: int = 0
    save_trial_best: int = 1
    save_trial_latest: int = 1
    # content-addressed store (type: cas) — all default None so non-cas
    # configs round-trip byte-identically through to_dict
    chunk_size_kb: Optional[int] = None
    cache_path: Optional[str] = None
    cache_size_mb: Optional[int] = None
    transfer_workers: Optional[int] = None
    inner: Optional["CheckpointStorageConfig"] = None

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "CheckpointStorageConfig":
        t = raw.get("type", "shared_fs")
        if t not in _STORAGE_TYPES:
            raise ConfigError(
                f"unknown checkpoint_storage.type {t!r}; expected one of {sorted(_STORAGE_TYPES)}"
            )
        inner = None
        if t == "cas":
            inner_raw = raw.get("inner")
            if inner_raw is None:
                # flat convenience form: `type: cas` + a shared_fs/directory
                # path — synthesize the inner backend block
                if raw.get("host_path"):
                    inner_raw = {"type": "shared_fs",
                                 "host_path": raw["host_path"],
                                 "storage_path": raw.get("storage_path")}
                    inner_raw = {k: v for k, v in inner_raw.items()
                                 if v is not None}
                elif raw.get("container_path"):
                    inner_raw = {"type": "directory",
                                 "container_path": raw["container_path"]}
                else:
                    raise ConfigError(
                        "checkpoint_storage type 'cas' needs an 'inner' "
                        "backend block (or a flat host_path/container_path)")
            if inner_raw.get("type") == "cas":
                raise ConfigError(
                    "checkpoint_storage.inner cannot itself be 'cas'")
            inner = CheckpointStorageConfig.from_dict(inner_raw)
        cfg = CheckpointStorageConfig(
            type=t,
            host_path=raw.get("host_path"),
            storage_path=raw.get("storage_path"),
            container_path=raw.get("container_path"),
            bucket=raw.get("bucket"),
            prefix=raw.get("prefix"),
            container=raw.get("container"),
            connection_string=raw.get("connection_string"),
            save_experiment_best=int(raw.get("save_experiment_best", 0)),
            save_trial_best=int(raw.get("save_trial_best", 1)),
            save_trial_latest=int(raw.get("save_trial_latest", 1)),
            chunk_size_kb=(int(raw["chunk_size_kb"])
                           if raw.get("chunk_size_kb") is not None else None),
            cache_path=raw.get("cache_path"),
            cache_size_mb=(int(raw["cache_size_mb"])
                           if raw.get("cache_size_mb") is not None else None),
            transfer_workers=(int(raw["transfer_workers"])
                              if raw.get("transfer_workers") is not None
                              else None),
            inner=inner,
        )
        if t == "shared_fs" and not cfg.host_path:
            raise ConfigError("checkpoint_storage.host_path is required for shared_fs storage")
        if t == "directory" and not cfg.container_path:
            raise ConfigError(
                "checkpoint_storage.container_path is required for directory storage"
            )
        if t in ("gcs", "s3") and not cfg.bucket:
            raise ConfigError(f"checkpoint_storage.bucket is required for {t} storage")
        if t == "azure" and not cfg.container:
            raise ConfigError(
                "checkpoint_storage.container is required for azure storage"
            )
        if cfg.chunk_size_kb is not None and cfg.chunk_size_kb < 1:
            raise ConfigError(
                f"checkpoint_storage.chunk_size_kb must be >= 1, "
                f"got {cfg.chunk_size_kb}")
        if cfg.cache_size_mb is not None and cfg.cache_size_mb < 1:
            raise ConfigError(
                f"checkpoint_storage.cache_size_mb must be >= 1, "
                f"got {cfg.cache_size_mb}")
        if cfg.transfer_workers is not None and cfg.transfer_workers < 0:
            raise ConfigError(
                f"checkpoint_storage.transfer_workers must be >= 0, "
                f"got {cfg.transfer_workers}")
        if t not in _PORTED_STORAGE:
            raise NotImplementedError(
                f"checkpoint_storage.type {t!r} is not ported yet "
                f"({_ROADMAP_STORAGE}); use shared_fs or directory")
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if v is not None and k != "inner"}
        if self.inner is not None:
            d["inner"] = self.inner.to_dict()
        return d


# ---------------------------------------------------------------------------
# Optimizations (reference: expconf OptimizationsConfig — there it tunes
# horovod aggregation; here it tunes the training loop: input prefetch and
# steps per dispatch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OptimizationsConfig:
    prefetch_depth: int = 2        # device batches buffered ahead (0 = sync)
    steps_per_dispatch: int = 1    # optimizer steps per dispatch

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "OptimizationsConfig":
        if not isinstance(raw, dict):
            raise ConfigError(f"optimizations must be a mapping, got {raw!r}")
        cfg = OptimizationsConfig(
            prefetch_depth=int(raw.get("prefetch_depth", 2)),
            steps_per_dispatch=int(raw.get("steps_per_dispatch", 1)),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.prefetch_depth < 0:
            raise ConfigError(
                f"optimizations.prefetch_depth must be >= 0, "
                f"got {self.prefetch_depth}")
        if self.steps_per_dispatch < 1:
            raise ConfigError(
                f"optimizations.steps_per_dispatch must be >= 1, "
                f"got {self.steps_per_dispatch}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Observability (trial-side telemetry: spans, metrics registry, Chrome-trace
# export — see docs/observability.md; disabled by default so the hot loop
# stays unwrapped)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ObservabilityConfig:
    enabled: bool = False
    max_events: int = 200_000      # span-record cap (head kept, tail dropped)
    ship_spans: bool = False       # ship span records over profiler channel
    ship_metrics: bool = True      # ship registry snapshots over it
    trace_path: Optional[str] = None  # trace.json destination; None = default
    # flight recorder (crash black box — telemetry/flight.py); None = off
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
    # master-side time-series store (telemetry/tsdb.py); None = the
    # TSDB is not enabled. Keys mirror TimeSeriesDB.from_dict.
    timeseries: Optional[Dict[str, Any]] = None
    # sources with no ingest for this long are flagged stale in
    # `dct metrics` output and skipped by the TSDB scrape
    stale_after_s: float = 60.0
    # declarative alert rules (telemetry/rules.py AlertRule.from_dict)
    rules: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # install the two PR-13 burn-rate rules over dct_slo_burn_rate
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
        # rule semantics (per-kind required fields, thresholds) live in
        # telemetry/rules.py; validating here makes `experiment create`
        # reject a bad rule instead of the master at scrape time
        from determined_clone_tpu_torch.telemetry.rules import AlertRule

        for i, rule in enumerate(self.rules):
            try:
                AlertRule.from_dict(rule)
            except (TypeError, ValueError) as e:
                raise ConfigError(
                    f"observability.rules[{i}]: {e}") from e

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


# ---------------------------------------------------------------------------
# Serving (the `serving:` block) — online inference via `dct serve`:
# continuous batching over a paged KV cache; see docs/serving.md. The knobs
# are the engine's shape/capacity contract: buckets bound the program
# count, kv blocks bound concurrent context, queue depth is the admission
# valve. No reference equivalent (the reference serves only batch jobs).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpeculativeConfig:
    """The ``serving.speculative:`` block — draft-model speculative
    decoding (docs/serving.md). The draft GPT shares the target's
    tokenizer/vocab and max_seq_len; only its depth/width are chosen
    here. Greedy output is bit-identical to plain decode regardless of
    draft quality — a bad draft only costs speed."""
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


# ---------------------------------------------------------------------------
# Fault injection (the `faults:` block) — a seeded, deterministic FaultPlan
# for chaos testing; see docs/fault_tolerance.md. No reference equivalent:
# the reference exercises failure paths with live clusters, we do it by seed.
# ---------------------------------------------------------------------------

_FAULT_ACTIONS = ("error", "delay", "truncate", "exit")
_FAULT_EXCS = ("fault", "io", "conn")


@dataclasses.dataclass
class FaultsConfig:
    enabled: bool = True
    seed: int = 0
    rules: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "FaultsConfig":
        if not isinstance(raw, dict):
            raise ConfigError(f"faults must be a mapping, got {raw!r}")
        cfg = FaultsConfig(
            enabled=bool(raw.get("enabled", True)),
            seed=int(raw.get("seed", 0)),
            rules=[dict(r) for r in raw.get("rules") or []],
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        for i, rule in enumerate(self.rules):
            if not isinstance(rule, dict) or not rule.get("point"):
                raise ConfigError(f"faults.rules[{i}] requires a `point`")
            action = rule.get("action", "error")
            if action not in _FAULT_ACTIONS:
                raise ConfigError(
                    f"faults.rules[{i}].action must be one of "
                    f"{_FAULT_ACTIONS}, got {action!r}")
            exc = rule.get("exc", "fault")
            if exc not in _FAULT_EXCS:
                raise ConfigError(
                    f"faults.rules[{i}].exc must be one of "
                    f"{_FAULT_EXCS}, got {exc!r}")
            prob = float(rule.get("probability", 1.0))
            if not 0.0 <= prob <= 1.0:
                raise ConfigError(
                    f"faults.rules[{i}].probability must be in [0, 1], "
                    f"got {prob}")

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"enabled": self.enabled, "seed": self.seed}
        if self.rules:
            d["rules"] = self.rules
        return d


# ---------------------------------------------------------------------------
# Log policies (reference: expconf log_policies → logpattern subsystem)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LogPolicy:
    pattern: str
    action: str = "exclude_node"  # exclude_node | cancel_retries

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "LogPolicy":
        if "pattern" not in raw:
            raise ConfigError("log policy requires a `pattern`")
        action = raw.get("action", "exclude_node")
        if isinstance(action, dict):  # reference's {"type": "..."} form
            action = action.get("type", "exclude_node")
        if action not in ("exclude_node", "cancel_retries"):
            raise ConfigError(f"unknown log policy action {action!r}")
        return LogPolicy(pattern=raw["pattern"], action=action)


# ---------------------------------------------------------------------------
# The experiment config itself
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExperimentConfig:
    name: str = "unnamed-experiment"
    entrypoint: Optional[str] = None
    searcher: SearcherConfig = dataclasses.field(default_factory=SearcherConfig)
    resources: ResourcesConfig = dataclasses.field(default_factory=ResourcesConfig)
    hyperparameters: HyperparameterSpace = dataclasses.field(
        default_factory=HyperparameterSpace
    )
    checkpoint_storage: Optional[CheckpointStorageConfig] = None
    optimizations: OptimizationsConfig = dataclasses.field(
        default_factory=OptimizationsConfig
    )
    observability: ObservabilityConfig = dataclasses.field(
        default_factory=ObservabilityConfig
    )
    serving: Optional[ServingConfig] = None
    faults: Optional[FaultsConfig] = None
    checkpoint_policy: str = "best"     # best | all | none
    min_validation_period: Optional[Length] = None
    min_checkpoint_period: Optional[Length] = None
    perform_initial_validation: bool = False
    max_restarts: int = 5
    records_per_epoch: int = 0
    scheduling_unit: int = 100          # batches per searcher unit
    experiment_seed: int = 0            # reproducibility.experiment_seed
    labels: List[str] = dataclasses.field(default_factory=list)
    workspace: str = "Uncategorized"
    project: str = "Uncategorized"
    log_policies: List[LogPolicy] = dataclasses.field(default_factory=list)
    profiling_enabled: bool = False
    environment: Dict[str, Any] = dataclasses.field(default_factory=dict)
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    raw: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # what the v0->v1 shim rewrote (surfaced as deprecation notices)
    deprecations: List[str] = dataclasses.field(default_factory=list)

    @staticmethod
    def from_dict(raw: Dict[str, Any]) -> "ExperimentConfig":
        if not isinstance(raw, dict):
            raise ConfigError(f"experiment config must be a mapping, got {type(raw).__name__}")
        # schema-first pipeline (≈ expconf parse.go): shim legacy (v0)
        # spellings to the current version, then validate against the
        # schema-as-data before the dataclass layer parses values
        from determined_clone_tpu_torch.config import schema as schema_mod
        from determined_clone_tpu_torch.config import shims

        try:
            raw, deprecations = shims.shim(raw)
        except ValueError as e:
            raise ConfigError(str(e)) from None
        errors = schema_mod.validate(raw)
        if errors:
            raise ConfigError("invalid experiment config:\n  " +
                              "\n  ".join(errors))
        profiling = raw.get("profiling", {})
        cfg = ExperimentConfig(
            name=raw.get("name", "unnamed-experiment"),
            entrypoint=raw.get("entrypoint"),
            searcher=SearcherConfig.from_dict(raw.get("searcher", {})),
            resources=ResourcesConfig.from_dict(raw.get("resources", {})),
            hyperparameters=HyperparameterSpace(raw.get("hyperparameters", {})),
            checkpoint_storage=(
                CheckpointStorageConfig.from_dict(raw["checkpoint_storage"])
                if raw.get("checkpoint_storage") else None
            ),
            optimizations=OptimizationsConfig.from_dict(
                raw.get("optimizations") or {}
            ),
            observability=ObservabilityConfig.from_dict(
                raw.get("observability") or {}
            ),
            serving=(ServingConfig.from_dict(raw["serving"])
                     if raw.get("serving") else None),
            faults=(FaultsConfig.from_dict(raw["faults"])
                    if raw.get("faults") else None),
            checkpoint_policy=raw.get("checkpoint_policy", "best"),
            min_validation_period=(
                Length.from_dict(raw["min_validation_period"])
                if "min_validation_period" in raw else None
            ),
            min_checkpoint_period=(
                Length.from_dict(raw["min_checkpoint_period"])
                if "min_checkpoint_period" in raw else None
            ),
            perform_initial_validation=bool(raw.get("perform_initial_validation", False)),
            max_restarts=int(raw.get("max_restarts", 5)),
            records_per_epoch=int(raw.get("records_per_epoch", 0)),
            scheduling_unit=int(raw.get("scheduling_unit", 100)),
            experiment_seed=int(
                (raw.get("reproducibility") or {}).get("experiment_seed", 0)
            ),
            labels=list(raw.get("labels", []) or []),
            workspace=raw.get("workspace", "Uncategorized"),
            project=raw.get("project", "Uncategorized"),
            log_policies=[LogPolicy.from_dict(p) for p in raw.get("log_policies", []) or []],
            profiling_enabled=bool(
                profiling.get("enabled", False) if isinstance(profiling, dict) else profiling
            ),
            environment=raw.get("environment", {}) or {},
            data=raw.get("data", {}) or {},
            raw=raw,
            deprecations=deprecations,
        )
        cfg.validate()
        return cfg

    @staticmethod
    def from_yaml(path: str) -> "ExperimentConfig":
        import yaml  # lazy: only YAML callers need PyYAML

        with open(path) as f:
            return ExperimentConfig.from_dict(yaml.safe_load(f) or {})

    def validate(self) -> None:
        if self.checkpoint_policy not in ("best", "all", "none"):
            raise ConfigError(
                f"checkpoint_policy must be best|all|none, got {self.checkpoint_policy!r}"
            )
        if self.max_restarts < 0:
            raise ConfigError(f"max_restarts must be >= 0, got {self.max_restarts}")
        if self.scheduling_unit < 1:
            raise ConfigError(f"scheduling_unit must be >= 1, got {self.scheduling_unit}")
        if self.searcher.name == "grid" and self.hyperparameters.grid_size() == 0:
            # a grid over an empty space is a single trial; allowed, like the reference
            pass

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "searcher": self.searcher.to_dict(),
            "resources": self.resources.to_dict(),
            "hyperparameters": self.hyperparameters.raw,
            "checkpoint_policy": self.checkpoint_policy,
            "max_restarts": self.max_restarts,
            "records_per_epoch": self.records_per_epoch,
            "scheduling_unit": self.scheduling_unit,
            "reproducibility": {"experiment_seed": self.experiment_seed},
            "labels": self.labels,
            "workspace": self.workspace,
            "project": self.project,
        }
        if self.entrypoint:
            d["entrypoint"] = self.entrypoint
        if self.checkpoint_storage:
            d["checkpoint_storage"] = self.checkpoint_storage.to_dict()
        if self.optimizations != OptimizationsConfig():
            d["optimizations"] = self.optimizations.to_dict()
        if self.observability != ObservabilityConfig():
            d["observability"] = self.observability.to_dict()
        if self.serving is not None:
            d["serving"] = self.serving.to_dict()
        if self.faults is not None:
            d["faults"] = self.faults.to_dict()
        if self.min_validation_period:
            d["min_validation_period"] = self.min_validation_period.to_dict()
        if self.min_checkpoint_period:
            d["min_checkpoint_period"] = self.min_checkpoint_period.to_dict()
        if self.data:
            d["data"] = self.data
        return d


def merge_configs(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    """Template merging (reference: master/internal/templates + schemas.Merge):
    override wins per key; nested dicts merge recursively; lists replace."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_configs(out[k], v)
        else:
            out[k] = v
    return out
