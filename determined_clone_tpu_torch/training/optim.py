"""Optimizers — the port's counterparts of the ``optax`` transformations
that the repo's training uses: ``adamw``, ``adam``, ``sgd``,
``clip_by_global_norm``, ``chain`` and the ``linear_schedule`` learning
rate.

Each is built as optax builds it, from the same pieces in the same order
(``adamw`` is ``chain(scale_by_adam, add_decayed_weights,
scale_by_learning_rate)``), so its state has optax's layout: a chain's
state is the tuple of its members' states, a member that keeps nothing
holds an :class:`EmptyState`, Adam holds ``AdamState(count, mu, nu)``
(optax's ``ScaleByAdamState``) and a learning-rate schedule its own
``ScheduleState(count)``. A JAX checkpoint's optimizer state therefore
maps onto the port's leaf for leaf by its tree path
(``core/_serialization.py``), with no table of special cases. Counts are
Python ints (the step needs no device value for them).

The arithmetic follows optax's: bias-corrected moments (the corrections
computed in float32) with ``eps`` outside the square root, the decoupled
weight decay added to the update of every leaf (no ``mask``) before the
learning rate scales it, and the update added to the params last. It
runs on PyTorch's multi-tensor ``torch._foreach_*`` ops, one launch per
op over all the leaves, rather than through ``torch.optim``, whose state
has another layout.

One departure, for memory: optax returns new params and state, and the
JAX step donates the old ones; here ``Optimizer.update`` writes the new
values into the params' and the moments' own tensors and returns the new
state.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple, Tuple,
                    Union)

import numpy as np
import torch

Params = Dict[str, Any]
Updates = List[torch.Tensor]
# a learning rate, or a schedule: the update count -> the learning rate
ScalarOrSchedule = Union[float, Callable[[int], float]]


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of nested dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """The same nested dicts and lists with ``fn`` applied to every
    tensor."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def unflatten(like: Any, values: List[torch.Tensor]) -> Any:
    """``values`` (in :func:`leaves` order) in the structure of ``like``."""
    it: Iterator[torch.Tensor] = iter(values)
    return tree_map(lambda _: next(it), like)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the 2-norm over all the tensors, on their
    device (no host sync)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class EmptyState(NamedTuple):
    """optax's ``EmptyState``: the state of a member that keeps none."""


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``; ``count`` is the number of updates
    made."""
    count: int
    mu: Params
    nu: Params


class ScheduleState(NamedTuple):
    """optax's ``ScaleByScheduleState``: the schedule's own count."""
    count: int


Transform = Callable[[Updates, Any, List[torch.Tensor]], Tuple[Updates, Any]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optax ``GradientTransformation`` over a nested dict of tensors.

    ``init(params) -> state``. ``transform(updates, state, params) ->
    (updates, state)`` takes the updates and params as lists in
    :func:`leaves` order and may write into the update tensors; it is what
    :func:`chain` composes. ``update(grads, state, params) -> state``
    transforms the gradients and adds the result to ``params`` in place —
    optax's ``update`` followed by ``apply_updates``."""
    init: Callable[[Params], Any]
    transform: Transform

    def update(self, grads: Params, state: Any, params: Params) -> Any:
        p = leaves(params)
        with torch.no_grad():
            u, state = self.transform(leaves(grads), state, p)
            torch._foreach_add_(p, u)
        return state


def _stateless(transform: Callable[[Updates, List[torch.Tensor]], Updates]
               ) -> Optimizer:
    return Optimizer(lambda params: EmptyState(),
                     lambda u, state, p: (transform(u, p), state))


def chain(*members: Optimizer) -> Optimizer:
    """``optax.chain``: the members in turn; the state is their tuple."""

    def init(params: Params) -> tuple:
        return tuple(m.init(params) for m in members)

    def transform(u: Updates, state: tuple, p: List[torch.Tensor]):
        new = []
        for m, s in zip(members, state):
            u, s = m.transform(u, s, p)
            new.append(s)
        return u, tuple(new)

    return Optimizer(init, transform)


def identity() -> Optimizer:
    """``optax.identity``."""
    return _stateless(lambda u, p: u)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    """``optax.clip_by_global_norm``: updates whose global norm reaches
    ``max_norm`` are scaled down to it. The scale is a device scalar,
    ``min(1, max_norm / norm)``, so no host sync decides the branch; below
    the threshold it is exactly 1 (optax's select keeps the updates), and
    above it ``t * (max_norm / norm)`` differs from optax's
    ``(t / norm) * max_norm`` by at most a rounding."""

    def transform(u: Updates, p: List[torch.Tensor]) -> Updates:
        scale = torch.clamp(max_norm / global_norm(u), max=1.0)
        torch._foreach_mul_(u, scale)
        return u

    return _stateless(transform)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it: at count 1,
    ``1 - 0.999`` in float32 is 1.3e-5 off the exact value, and the
    moments are divided by what optax divides them by."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> Optimizer:
    """``optax.scale_by_adam`` with ``eps_root=0``, no Nesterov."""

    def init(params: Params) -> AdamState:
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    def transform(g: Updates, state: AdamState, p: List[torch.Tensor]):
        mu, nu = leaves(state.mu), leaves(state.nu)
        count = state.count + 1
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - b2)
        denom = torch._foreach_div(nu, _bias_correction(b2, count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        u = torch._foreach_div(mu, _bias_correction(b1, count))
        torch._foreach_div_(u, denom)
        return u, AdamState(count, state.mu, state.nu)

    return Optimizer(init, transform)


def add_decayed_weights(weight_decay: float) -> Optimizer:
    """``optax.add_decayed_weights`` without a mask: ``u + wd * p``."""

    def transform(u: Updates, p: List[torch.Tensor]) -> Updates:
        if weight_decay:
            torch._foreach_add_(u, p, alpha=weight_decay)
        return u

    return _stateless(transform)


def scale_by_learning_rate(learning_rate: ScalarOrSchedule) -> Optimizer:
    """``optax.scale_by_learning_rate``: the updates times
    ``-learning_rate``; a schedule is called with its own count
    (``optax.scale_by_schedule``)."""
    if not callable(learning_rate):
        def scale(u: Updates, p: List[torch.Tensor]) -> Updates:
            torch._foreach_mul_(u, -learning_rate)
            return u

        return _stateless(scale)

    def transform(u: Updates, state: ScheduleState, p: List[torch.Tensor]):
        torch._foreach_mul_(u, -float(learning_rate(state.count)))
        return u, ScheduleState(state.count + 1)

    return Optimizer(lambda params: ScheduleState(0), transform)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int, transition_begin: int = 0
                    ) -> Callable[[int], float]:
    """``optax.linear_schedule``: ``init_value`` until
    ``transition_begin``, then linearly to ``end_value`` over
    ``transition_steps`` counts, computed in float32 as optax computes
    it; constant ``init_value`` when ``transition_steps <= 0``."""
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)
    init32, end32 = np.float32(init_value), np.float32(end_value)

    def schedule(count: int) -> float:
        c = np.float32(min(max(count - transition_begin, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return float((init32 - end32) * frac + end32)

    return schedule


def adamw(learning_rate: ScalarOrSchedule, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Optimizer:
    """``optax.adamw`` with ``eps_root=0``, no ``mask``, no Nesterov."""
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def adam(learning_rate: ScalarOrSchedule, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """``optax.adam``."""
    return chain(scale_by_adam(b1, b2, eps),
                 scale_by_learning_rate(learning_rate))


def sgd(learning_rate: ScalarOrSchedule) -> Optimizer:
    """``optax.sgd`` without momentum: ``p -= learning_rate * g``."""
    return chain(identity(), scale_by_learning_rate(learning_rate))
