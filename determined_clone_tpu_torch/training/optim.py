"""Optimizers — the port's counterparts of the ``optax`` transformations
that the repo's GPT training and its tests use: ``adamw`` (the
``bench.py`` optimizer), ``adam`` and ``sgd``.

They are written on PyTorch's multi-tensor ``torch._foreach_*`` ops, one
launch per op over all the leaves, rather than by wrapping
``torch.optim``: the state stays optax's functional ``(count, mu, nu)``
(``ScaleByAdamState``), so a JAX checkpoint's optimizer state maps onto
it leaf for leaf (``convert.adam_state_from_numpy``), and the arithmetic
follows optax's: bias-corrected moments, ``eps`` outside the square
root, and the decoupled weight decay added to the update of every leaf
(optax's ``mask`` is None in ``bench.py``) before the learning rate
scales it.

One departure, for memory: optax returns new params and state, and the
JAX step donates the old ones; here ``update`` writes the new values into
the params' and the moments' own tensors and returns the new state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, NamedTuple

import torch

Params = Dict[str, Any]


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """The same nested dict with ``fn`` applied to every tensor."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unflatten(like: Any, values: List[torch.Tensor]) -> Any:
    """``values`` (in :func:`leaves` order) in the structure of ``like``."""
    it: Iterator[torch.Tensor] = iter(values)
    return tree_map(lambda _: next(it), like)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the 2-norm over all the tensors, on their
    device (no host sync)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``; ``count`` is the number of updates
    made, a Python int (the step needs no device value for it)."""
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params) -> state``; ``update(grads, state, params) ->
    state``, which updates ``params`` (and the state's tensors) in
    place."""
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], Any]


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Optimizer:
    """``optax.adamw`` with ``eps_root=0``, no ``mask``, no Nesterov."""

    def init(params: Params) -> AdamState:
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    def update(grads: Params, state: AdamState, params: Params) -> AdamState:
        p, g = leaves(params), leaves(grads)
        mu, nu = leaves(state.mu), leaves(state.nu)
        count = state.count + 1
        with torch.no_grad():
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, g, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1 - b2)
            denom = torch._foreach_div(nu, 1 - b2 ** count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            u = torch._foreach_div(mu, 1 - b1 ** count)
            torch._foreach_div_(u, denom)
            if weight_decay:
                torch._foreach_add_(u, p, alpha=weight_decay)
            torch._foreach_add_(p, u, alpha=-learning_rate)
        return AdamState(count, state.mu, state.nu)

    return Optimizer(init, update)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """``optax.adam``: :func:`adamw` without the weight decay."""
    return adamw(learning_rate, b1, b2, eps, weight_decay=0.0)


def sgd(learning_rate: float) -> Optimizer:
    """``optax.sgd`` without momentum: ``p -= learning_rate * g``."""

    def update(grads: Params, state: None, params: Params) -> None:
        with torch.no_grad():
            torch._foreach_add_(leaves(params), leaves(grads),
                                alpha=-learning_rate)

    return Optimizer(lambda params: None, update)
