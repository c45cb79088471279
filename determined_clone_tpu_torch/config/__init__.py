"""Experiment configuration — the port's trimmed copy of the JAX
package's ``config`` (the fields the training loop reads)."""
from determined_clone_tpu_torch.config.experiment import (
    CheckpointStorageConfig,
    ConfigError,
    ExperimentConfig,
    OptimizationsConfig,
    ResourcesConfig,
    SearcherConfig,
)
from determined_clone_tpu_torch.config.length import Length, Unit

__all__ = [
    "CheckpointStorageConfig",
    "ConfigError",
    "ExperimentConfig",
    "Length",
    "OptimizationsConfig",
    "ResourcesConfig",
    "SearcherConfig",
    "Unit",
]
