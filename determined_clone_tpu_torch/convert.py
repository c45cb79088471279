"""Parameters (and Adam's optimizer state) from the JAX package into the
port, one leaf for one leaf.

The JAX package's parameters are nested dicts of arrays; as numpy
(``jax.device_get`` on the JAX side — the port never imports JAX) they
map straight onto the port's dicts of tensors, because the port keeps the
same stacked ``[L, ...]`` layout and the same leaf names.

The flat keys of a single-host checkpoint shard (``shard-0.npz``, where
``core/_serialization.py`` joins the tree path with ".") are accepted
too, so ``params_from_numpy(dict(np.load(path)), device)`` loads an
unsharded checkpoint's arrays. Lists and tuples are walked as the
serialization walks them (the detector's ``backbone`` is a list): a
node whose flat keys are ``0 .. n-1`` becomes a list.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.training.optim import AdamState


def _to_tensor(arr: Any, dev: torch.device, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: widen exactly
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:  # a writable copy: arrays from JAX are read-only views
        t = torch.from_numpy(np.array(arr))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(dev)


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        *parents, name = key.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return _listify(tree)


def _listify(node: Any) -> Any:
    """Nested dicts with the dicts keyed ``"0" .. "n-1"`` as lists."""
    if not isinstance(node, dict):
        return node
    kids = {k: _listify(v) for k, v in node.items()}
    if kids and set(kids) == {str(i) for i in range(len(kids))}:
        return [kids[str(i)] for i in range(len(kids))]
    return kids


def params_from_numpy(tree: Mapping[str, Any], device: DeviceLike = "cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Nested dicts, lists and tuples of numpy arrays (or flat checkpoint
    keys ``"blocks.attn_qkv.kernel"``, ``"backbone.0.kernel"``) → the same
    tree of tensors on ``device``, cast to ``dtype`` when given."""
    dev = resolve_device(device)

    def conv(node: Any) -> Any:
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return _to_tensor(node, dev, dtype)

    if any("." in k for k in tree):
        tree = _nest(tree)
    return conv(tree)


def adam_state_from_numpy(state: Any, device: DeviceLike = "cuda"
                          ) -> AdamState:
    """optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``; as numpy
    trees, from ``jax.device_get``) → the port's :class:`AdamState` on
    ``device``, so a JAX run's optimizer resumes in the port. For
    ``optax.adamw``/``adam`` it is the first entry of the chain's state
    tuple; the decay and learning-rate entries hold nothing."""
    return AdamState(count=int(np.asarray(state.count)),
                     mu=params_from_numpy(state.mu, device),
                     nu=params_from_numpy(state.nu, device))
