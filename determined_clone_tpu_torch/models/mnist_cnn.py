"""Small conv net for mnist — the port of
``determined_clone_tpu/models/mnist_cnn.py``: two conv blocks and two
dense layers with dropout between them, NHWC as in the JAX package.

``apply`` flattens the NHWC activations as (H, W, C) before ``fc1``, as
the JAX model does: its rows are in that order, and an NCHW flatten would
feed them permuted (it would train, and disagree with every checkpoint).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.ops.layers import (
    conv2d,
    conv_init,
    dense,
    dense_init,
    dropout,
    fold_seed,
    max_pool,
    softmax_cross_entropy,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MnistCNNConfig:
    n_filters_1: int = 32
    n_filters_2: int = 64
    dropout_1: float = 0.25
    dropout_2: float = 0.5
    n_classes: int = 10
    compute_dtype: Any = torch.float32


def init(gen: torch.Generator, cfg: MnistCNNConfig,
         device: DeviceLike = "cuda") -> Params:
    dev = resolve_device(device)
    flat = 7 * 7 * cfg.n_filters_2  # 28 → 14 → 7 after two stride-2 pools
    return {
        "conv1": conv_init(gen, 1, cfg.n_filters_1, 3, device=dev),
        "conv2": conv_init(gen, cfg.n_filters_1, cfg.n_filters_2, 3,
                           device=dev),
        "fc1": dense_init(gen, flat, 128, device=dev),
        "fc2": dense_init(gen, 128, cfg.n_classes, device=dev),
    }


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    return max_pool(x, 2, 2, "VALID")


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def apply(params: Params, cfg: MnistCNNConfig, x: torch.Tensor, *,
          training: bool = False,
          dropout_seed: Optional[int] = None) -> torch.Tensor:
    """x: [B, 28, 28, 1] NHWC (flat [B, 784] accepted) → logits [B, C]
    (fp32). Dropout is on when ``training`` and ``dropout_seed`` is given:
    the two layers draw from the seeds ``fold_seed(dropout_seed, 0)`` and
    ``(…, 1)``, where the JAX model splits its dropout key in two."""
    if x.dim() == 2:
        x = x.reshape(-1, 28, 28, 1)
    g1 = g2 = None
    if training and dropout_seed is not None:
        g1 = _generator(fold_seed(dropout_seed, 0), x.device)
        g2 = _generator(fold_seed(dropout_seed, 1), x.device)
    cd = cfg.compute_dtype
    x = torch.relu(conv2d(params["conv1"], x, compute_dtype=cd))
    x = _maxpool2(x)
    x = torch.relu(conv2d(params["conv2"], x, compute_dtype=cd))
    x = _maxpool2(x)
    x = dropout(x, cfg.dropout_1, g1)
    x = x.reshape(x.shape[0], -1)  # (H, W, C) order, as the JAX model
    x = torch.relu(dense(params["fc1"], x, compute_dtype=cd))
    x = dropout(x, cfg.dropout_2, g2)
    return dense(params["fc2"], x, compute_dtype=cd).float()


def loss_fn(params: Params, cfg: MnistCNNConfig, x: torch.Tensor,
            y: torch.Tensor, *, training: bool = False,
            dropout_seed: Optional[int] = None) -> torch.Tensor:
    logits = apply(params, cfg, x, training=training,
                   dropout_seed=dropout_seed)
    return softmax_cross_entropy(logits, y).mean()
