"""TorchTrial — the high-level trial API; the port of
``determined_clone_tpu/training/trial.py`` (``JaxTrial``).

A trial declares functions the Trainer calls:

  initial_params(gen)                 params, drawn from a torch.Generator
  optimizer()                         an ``optim.Optimizer`` (schedules
                                      are callables of the update count)
  loss(params, batch, seed)           (loss, metrics dict of device scalars)
  eval_metrics(params, batch, seed)   per-batch validation metrics
  training_data()/validation_data()   host batches (numpy pytrees)

Where the JAX trial receives a PRNG key, a TorchTrial receives an int
seed (``ops.layers.fold_seed`` derives more). The TrialContext carries
what trial code may read: hparams, the experiment config, the device and
the Core API context. ``sharding_rules``/``batch_spec`` come with the
parallelism slice.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, Iterable, Optional, Tuple

import torch

from determined_clone_tpu_torch.config.experiment import ExperimentConfig
from determined_clone_tpu_torch.core import Context
from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.training.optim import Optimizer


class TrialContext:
    """``device`` defaults to the card and raises without CUDA unless
    ``device="cpu"`` is given."""

    def __init__(self, *, config: ExperimentConfig, hparams: Dict[str, Any],
                 core: Context, device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self.config = config
        self.hparams = hparams
        self.core = core

    def get_hparam(self, name: str, default: Any = None) -> Any:
        node: Any = self.hparams
        for part in name.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


class TorchTrial(abc.ABC):
    """Subclass and implement the functions; the Trainer does the rest."""

    def __init__(self, context: TrialContext) -> None:
        self.context = context

    # -- required -----------------------------------------------------------

    @abc.abstractmethod
    def initial_params(self, gen: torch.Generator) -> Any:
        """Params on ``context.device``; ``gen`` lives on that device."""

    @abc.abstractmethod
    def optimizer(self) -> Optimizer:
        ...

    @abc.abstractmethod
    def loss(self, params: Any, batch: Any, seed: int
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (scalar loss, metrics dict of device scalars)."""

    @abc.abstractmethod
    def training_data(self) -> Iterable[Any]:
        """Yield host-side batches (numpy pytrees) with GLOBAL batch dim."""

    # -- optional -----------------------------------------------------------

    def eval_metrics(self, params: Any, batch: Any,
                     seed: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """Per-batch validation metrics (mean-reduced across batches).

        ``seed`` is threaded by the Trainer off the experiment's seed,
        fresh at every validation; a direct caller that passes none gets
        the experiment seed. Overrides with the plain ``(params, batch)``
        signature keep working."""
        if seed is None:
            seed = self.context.config.experiment_seed
        out = self.loss(params, batch, seed)
        loss, metrics = out if isinstance(out, tuple) else (out, {})
        return {"loss": loss, **metrics}

    def validation_data(self) -> Optional[Iterable[Any]]:
        return None

    def train_step_flops(self) -> Optional[Any]:
        """Analytic FLOPs for ONE optimizer step over one global batch —
        a ``telemetry.flops.StepFlops`` or a plain float; None when the
        trial does not know its model's count."""
        return None

    def tokens_per_sample(self) -> Optional[int]:
        """Tokens per sample (sequence length); None → 1."""
        return None

    @property
    def global_batch_size(self) -> int:
        return int(self.context.get_hparam("global_batch_size", 32))
