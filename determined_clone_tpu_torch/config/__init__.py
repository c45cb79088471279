"""Experiment configuration — the port's trimmed copy of the JAX
package's ``config`` (the fields the training loop and the serving
engine read)."""
from determined_clone_tpu_torch.config.experiment import (
    CheckpointStorageConfig,
    ConfigError,
    ExperimentConfig,
    ObservabilityConfig,
    OptimizationsConfig,
    ResourcesConfig,
    SearcherConfig,
    ServingConfig,
    SpeculativeConfig,
)
from determined_clone_tpu_torch.config.length import Length, Unit

__all__ = [
    "CheckpointStorageConfig",
    "ConfigError",
    "ExperimentConfig",
    "Length",
    "ObservabilityConfig",
    "OptimizationsConfig",
    "ResourcesConfig",
    "SearcherConfig",
    "ServingConfig",
    "SpeculativeConfig",
    "Unit",
]
