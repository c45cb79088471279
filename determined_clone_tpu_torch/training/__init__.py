"""Training: the trial API, the Trainer loop, the train step, its
optimizers and metric accumulation."""
from determined_clone_tpu_torch.training.metrics import MetricAccumulator
from determined_clone_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from determined_clone_tpu_torch.training.trainer import Trainer
from determined_clone_tpu_torch.training.trial import TorchTrial, TrialContext

__all__ = [
    "MetricAccumulator",
    "TrainState",
    "create_train_state",
    "make_eval_step",
    "make_train_step",
    "Trainer",
    "TorchTrial",
    "TrialContext",
]
