"""Experiment orchestration (≈ master/internal/experiment.go, local mode);
the port's copy of ``determined_clone_tpu/experiment``."""
from determined_clone_tpu_torch.experiment.runner import (
    ExperimentResult,
    LocalExperimentRunner,
    TrialRecord,
)

__all__ = ["ExperimentResult", "LocalExperimentRunner", "TrialRecord"]
