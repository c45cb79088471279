"""Experiment configuration — the port's copy of the JAX package's
``config``: the experiment config with its schema and v0 shims, the
hyperparameter space, and training lengths."""
from determined_clone_tpu_torch.config.experiment import (
    CheckpointStorageConfig,
    ConfigError,
    ExperimentConfig,
    LogPolicy,
    ObservabilityConfig,
    OptimizationsConfig,
    ResourcesConfig,
    SearcherConfig,
    ServingConfig,
    SpeculativeConfig,
    merge_configs,
)
from determined_clone_tpu_torch.config.hyperparameters import (
    Categorical,
    Const,
    Double,
    Hyperparameter,
    HyperparameterSpace,
    Int,
    Log,
    parse_hyperparameter,
)
from determined_clone_tpu_torch.config.length import Length, Unit

__all__ = [
    "CheckpointStorageConfig",
    "ConfigError",
    "ExperimentConfig",
    "LogPolicy",
    "ObservabilityConfig",
    "OptimizationsConfig",
    "ResourcesConfig",
    "SearcherConfig",
    "ServingConfig",
    "SpeculativeConfig",
    "merge_configs",
    "Categorical",
    "Const",
    "Double",
    "Hyperparameter",
    "HyperparameterSpace",
    "Int",
    "Log",
    "parse_hyperparameter",
    "Length",
    "Unit",
]
