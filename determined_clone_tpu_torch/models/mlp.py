"""MLP classifier — the port of ``determined_clone_tpu/models/mlp.py``,
the mnist workhorse (the reference's mnist_pytorch tutorial model)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch

from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.ops.layers import (
    dense,
    dense_init,
    softmax_cross_entropy,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden_dims: Sequence[int] = (128, 64)
    n_classes: int = 10
    compute_dtype: Any = torch.float32


def init(gen: torch.Generator, cfg: MLPConfig,
         device: DeviceLike = "cuda") -> Params:
    dev = resolve_device(device)
    dims = [cfg.in_dim, *cfg.hidden_dims, cfg.n_classes]
    return {f"layer_{i}": dense_init(gen, dims[i], dims[i + 1], device=dev)
            for i in range(len(dims) - 1)}


def apply(params: Params, cfg: MLPConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B, in_dim] (or [B, 28, 28(, 1)], flattened here) → logits
    [B, C] in fp32."""
    x = x.reshape(x.shape[0], -1)
    n = len(params)
    for i in range(n):
        x = dense(params[f"layer_{i}"], x, compute_dtype=cfg.compute_dtype)
        if i < n - 1:
            x = torch.relu(x)
    return x.float()


def loss_fn(params: Params, cfg: MLPConfig, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    return softmax_cross_entropy(apply(params, cfg, x), y).mean()
