"""The training step: loss → grads → optimizer update — the port of
``determined_clone_tpu/training/train_step.py``.

PyTorch runs eagerly, so the step is a Python function where the JAX
package jits one XLA program; it still makes no host sync: the loss and
``grad_norm`` come back as device tensors. The state's params are
updated in place (the JAX step donates its state). The JAX module's
``capture_compile`` (explicit XLA ``lower()``/``compile()``) and
``program_cache_size`` (the jit cache probe) are XLA-only and have no
counterpart here.

Over a mesh, ``state_shardings`` places the state as the JAX package
does (Adam moments take their parameter's sharding, scalars replicate)
and ``shard_state`` makes its tensors DTensors. The same step then takes
the DTensor state and a DTensor batch: the loss is the global batch's
(the model reduces it), and each gradient is summed over the data axes
(the batch's, and ``sp`` for a sequence split) before the update
(``parallel/spmd.py``), so loss, gradients and ``grad_norm`` are those
of the global batch. ``pp``-split leaves (``GPT_PP_SHARDING_RULES``)
are placed, updated and saved as any other sharded leaf: each stage's
ranks hold and step only its layers.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from determined_clone_tpu_torch.core._serialization import (
    tree_paths_and_leaves,
)
from determined_clone_tpu_torch.ops.layers import fold_seed
from determined_clone_tpu_torch.parallel.sharding import (
    NamedSharding,
    P,
    ShardingRules,
    shard_put,
)
from determined_clone_tpu_torch.parallel.spmd import local_tensor, spmd_of
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


def mark_trainable(params: Any) -> None:
    """Make every parameter an autograd leaf: a plain tensor itself, a
    DTensor its local tensor (what the step differentiates)."""
    for p in leaves(params):
        local_tensor(p).requires_grad_(True)


def create_train_state(params: Any, tx: Optimizer, seed: int) -> TrainState:
    """The state takes ``params`` over: it marks them as requiring grad,
    and the step updates them in place."""
    mark_trainable(params)
    return TrainState(params=params, opt_state=tx.init(params), step=0,
                      seed=seed)


def state_shardings(state: TrainState, mesh: Any,
                    rules: ShardingRules) -> TrainState:
    """Shardings for a whole TrainState. Optimizer-state subtrees
    congruent with the params (Adam's mu and nu) take the params' own
    shardings — ZeRO-1/2: the moments are sharded exactly like the params
    they track; everything else (counts, step, seed) replicates."""
    param_sh = rules.shardings_for(state.params, mesh)
    struct = _paths(state.params)
    rep = NamedSharding(mesh, P())

    def opt(node: Any) -> Any:
        if isinstance(node, dict):
            if _paths(node) == struct:
                return param_sh
            return {k: opt(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[opt(c) for c in node])
        if isinstance(node, (tuple, list)):
            return type(node)(opt(c) for c in node)
        return rep

    return TrainState(params=param_sh, opt_state=opt(state.opt_state),
                      step=rep, seed=rep)


def _paths(tree: Any) -> list:
    return [p for p, _ in tree_paths_and_leaves(tree)]


def shard_state(state: TrainState, shardings: TrainState) -> TrainState:
    """The state's tensors as DTensors on ``shardings`` (every rank holds
    the same values; each keeps its blocks)."""
    params = shard_put(state.params, shardings.params)
    mark_trainable(params)
    return TrainState(params, shard_put(state.opt_state, shardings.opt_state),
                      state.step, state.seed)


def _like(g: torch.Tensor, p: Any) -> torch.Tensor:
    """Local gradient ``g`` as a DTensor placed as its parameter ``p``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(g, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


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
        targets = [local_tensor(p) for p in params]
        # a parameter the loss does not use (BERT's MLM bias under the
        # classification loss) gets a zero gradient, as under jax.grad
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            targets, torch.autograd.grad(loss, targets, allow_unused=True))]
        sp = spmd_of(params[0])
        if sp is not None:
            with torch.no_grad():
                sp.reduce_grads(params, grads)
            grads = [_like(g, p) for g, p in zip(grads, params)]
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
