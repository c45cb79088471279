"""The training step: loss → grads → optimizer update — the port of
``determined_clone_tpu/training/train_step.py``.

PyTorch runs eagerly, so the step is a Python function where the JAX
package jits one XLA program; it still makes no host sync: the loss and
``grad_norm`` come back as device tensors. The state's params are
updated in place (the JAX step donates its state). The JAX module's
``capture_compile`` (explicit XLA ``lower()``/``compile()``) and
``program_cache_size`` (the jit cache probe) are XLA-only and have no
counterpart here; ``state_shardings`` belongs to the parallelism slice.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from determined_clone_tpu_torch.ops.layers import fold_seed
from determined_clone_tpu_torch.training.optim import (
    Optimizer,
    global_norm,
    leaves,
    unflatten,
)

LossFn = Callable[..., Any]  # (params, batch, seed) -> loss | (loss, metrics)
Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """Params, optimizer state, step, and a seed in place of the JAX
    rng key: step ``n`` draws its randomness from ``fold_seed(seed, n)``,
    as the JAX step splits a fresh key from its carried one.

    In a checkpoint (``core/_serialization.py``) its children are
    positional, as the JAX ``TrainState`` registers them: ``0`` params,
    ``1`` optimizer state, ``2`` the step as int32 and ``3`` the seed as
    the two uint32 words of a JAX PRNG key, high word first
    (``jax.random.PRNGKey(s)`` is ``[s >> 32, s & 0xffffffff]``). So the
    seed crosses frameworks losslessly, and a JAX key read here becomes
    the seed of those two words. The random streams drawn from it do
    not: dropout masks differ between the frameworks, so a trial that
    draws randomness does not continue the same stream after moving.
    """

    params: Any
    opt_state: Any
    step: int
    seed: int

    def tree_flatten(self) -> tuple:
        key = np.array([(self.seed >> 32) & 0xFFFFFFFF,
                        self.seed & 0xFFFFFFFF], np.uint32)
        return self.params, self.opt_state, np.int32(self.step), key

    @classmethod
    def tree_unflatten(cls, children) -> "TrainState":
        params, opt_state, step, key = children
        hi, lo = (int(w) for w in np.asarray(key, np.uint32))
        return cls(params, opt_state, int(step), (hi << 32) | lo)


def create_train_state(params: Any, tx: Optimizer, seed: int) -> TrainState:
    """The state takes ``params`` over: it marks them as requiring grad,
    and the step updates them in place."""
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=tx.init(params), step=0,
                      seed=seed)


def make_train_step(loss_fn: LossFn, tx: Optimizer, *,
                    steps_per_dispatch: int = 1
                    ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """Build the train step.

    ``loss_fn(params, batch, seed)`` returns a scalar loss or
    ``(loss, metrics_dict)``. The step returns the new state and
    ``{"loss", "grad_norm", **metrics}`` as device scalars; ``grad_norm``
    is ``optax.global_norm`` of the gradients.

    With ``steps_per_dispatch=k > 1`` the step takes ``(state, batch_0,
    ..., batch_{k-1})``, runs the k optimizer steps in turn and sums the
    per-step metrics (sum, not mean, so ``MetricAccumulator.add(metrics,
    count=k)`` keeps an exact per-batch mean): the same state as k calls
    of the single step.
    """

    def step_fn(state: TrainState, batch: Any) -> Tuple[TrainState, Metrics]:
        out = loss_fn(state.params, batch, fold_seed(state.seed, state.step))
        loss, metrics = out if isinstance(out, tuple) else (out, {})
        params = leaves(state.params)
        # a parameter the loss does not use (BERT's MLM bias under the
        # classification loss) gets a zero gradient, as under jax.grad
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            params, torch.autograd.grad(loss, params, allow_unused=True))]
        # copied before the update: a metric may alias a parameter (a
        # metric of ``params["w"]``), which the update overwrites in place,
        # and the JAX step reports the value before the update
        out_metrics = {"loss": loss.detach().float(),
                       "grad_norm": global_norm(list(grads)).float(),
                       **{k: v.detach().clone() for k, v in metrics.items()}}
        opt_state = tx.update(unflatten(state.params, list(grads)),
                              state.opt_state, state.params)
        return TrainState(state.params, opt_state, state.step + 1,
                          state.seed), out_metrics

    k = int(steps_per_dispatch)
    if k < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
    if k == 1:
        return step_fn

    def fused_fn(state: TrainState, *batches: Any
                 ) -> Tuple[TrainState, Metrics]:
        if len(batches) != k:
            raise ValueError(f"expected {k} batches, got {len(batches)}")
        summed: Metrics = {}
        for batch in batches:
            state, metrics = step_fn(state, batch)
            summed = {name: summed[name] + v if name in summed else v
                      for name, v in metrics.items()}
        return state, summed

    return fused_fn


def make_eval_step(eval_fn: Callable[..., Metrics], *,
                   seed: Optional[int] = None
                   ) -> Callable[[TrainState, Any], Metrics]:
    """Evaluation over the state's params, without autograd. When ``seed``
    is given and ``eval_fn`` declares a ``seed`` parameter, each call gets
    ``fold_seed(seed, state.step)`` — fresh per validation boundary, as
    the JAX step folds the step into its rng."""
    wants_seed = (seed is not None
                  and "seed" in inspect.signature(eval_fn).parameters)

    def step_fn(state: TrainState, batch: Any) -> Metrics:
        with torch.no_grad():
            if wants_seed:
                return eval_fn(state.params, batch,
                               seed=fold_seed(seed, state.step))
            return eval_fn(state.params, batch)

    return step_fn


def param_count(tree: Any) -> int:
    """Total parameter count — the N of the 6·N FLOP approximation."""
    return sum(int(t.numel()) for t in leaves(tree))
