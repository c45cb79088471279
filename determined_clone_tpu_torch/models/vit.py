"""Vision Transformer — the port of ``determined_clone_tpu/models/vit.py``.

The patch embedding is one matrix product over patches cut without a
gather (``patchify``); the blocks' params are stacked ``[L, ...]`` as in
the JAX package, walked by a loop in place of ``lax.scan``. The residual
stream stays fp32 — only the products run in ``compute_dtype`` — and the
CLS token and position embedding are added in fp32. Attention is plain
``mha`` (non-causal), as in the JAX model. With ``remat`` each block is
recomputed in the backward (``torch.utils.checkpoint``, non-reentrant;
``jax.checkpoint`` with no policy).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.ops import layers
from determined_clone_tpu_torch.ops.attention import mha
from determined_clone_tpu_torch.training.optim import leaves

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    n_classes: int = 1000
    d_model: int = 384
    n_layers: int = 12
    n_heads: int = 6
    d_ff: int = 1536
    dropout: float = 0.0
    compute_dtype: Any = torch.bfloat16
    remat: bool = False

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.channels * self.patch_size ** 2

    @staticmethod
    def tiny() -> "ViTConfig":
        return ViTConfig(image_size=32, patch_size=8, channels=3,
                         n_classes=10, d_model=64, n_layers=2, n_heads=4,
                         d_ff=128, compute_dtype=torch.float32)


def init(gen: torch.Generator, cfg: ViTConfig,
         device: DeviceLike = "cuda") -> Params:
    dev = resolve_device(device)
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    out_std = 0.02 / (2 * L) ** 0.5

    def normal(shape, stddev=0.02):
        return layers.trunc_normal(gen, shape, stddev, device=dev)

    return {
        "patch_proj": layers.dense_init(gen, cfg.patch_dim, d, device=dev),
        "pos_embed": normal((cfg.n_patches + 1, d)),
        "cls_token": normal((d,)),
        "blocks": {
            "ln1_scale": torch.ones((L, d), device=dev),
            "ln1_bias": torch.zeros((L, d), device=dev),
            "wqkv": normal((L, d, 3 * d)),
            "wo": normal((L, d, d), out_std),
            "ln2_scale": torch.ones((L, d), device=dev),
            "ln2_bias": torch.zeros((L, d), device=dev),
            "w1": normal((L, d, f)),
            "w2": normal((L, f, d), out_std),
        },
        "ln_f": layers.layernorm_init(d, device=dev),
        "head": layers.dense_init(gen, d, cfg.n_classes, device=dev),
    }


def patchify(cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] → [B, n_patches, patch_dim]: patches in row-major
    order, each flattened as (row, column, channel) of its pixels."""
    b = images.shape[0]
    p, g = cfg.patch_size, cfg.image_size // cfg.patch_size
    x = images.reshape(b, g, p, g, p, cfg.channels)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [B, g, g, p, p, C]
    return x.reshape(b, g * g, cfg.patch_dim)


def _block(cfg: ViTConfig, bp: Params, x: torch.Tensor) -> torch.Tensor:
    d, h, cd = cfg.d_model, cfg.n_heads, cfg.compute_dtype
    y = layers.layernorm({"scale": bp["ln1_scale"], "bias": bp["ln1_bias"]},
                         x).to(cd)
    q, k, v = torch.split(y @ bp["wqkv"].to(cd), d, dim=-1)

    def heads(t):
        return t.reshape(*t.shape[:-1], h, d // h)

    attn = mha(heads(q), heads(k), heads(v), causal=False)
    attn = attn.reshape(*attn.shape[:-2], d)
    x = x + (attn @ bp["wo"].to(cd)).to(x.dtype)

    y = layers.layernorm({"scale": bp["ln2_scale"], "bias": bp["ln2_bias"]},
                         x).to(cd)
    y = layers.gelu(y @ bp["w1"].to(cd))
    return x + (y @ bp["w2"].to(cd)).to(x.dtype)


def encode(params: Params, cfg: ViTConfig, images: torch.Tensor
           ) -> torch.Tensor:
    """[B, H, W, C] → [B, 1 + n_patches, d_model] encoded tokens (fp32)."""
    x = patchify(cfg, images).to(cfg.compute_dtype)
    x = layers.dense(params["patch_proj"], x, compute_dtype=cfg.compute_dtype)
    x = x.float()
    cls = params["cls_token"].expand(x.shape[0], 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    remat = cfg.remat and torch.is_grad_enabled()
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        bp = {k: v[i] for k, v in blocks.items()}
        if remat:
            x = checkpoint(_block, cfg, bp, x, use_reentrant=False)
        else:
            x = _block(cfg, bp, x)
    return layers.layernorm(params["ln_f"], x)


def apply(params: Params, cfg: ViTConfig, images: torch.Tensor
          ) -> torch.Tensor:
    """Classification logits [B, n_classes] from the CLS token."""
    tokens = encode(params, cfg, images)
    return layers.dense(params["head"], tokens[:, 0, :])


def loss_fn(params: Params, cfg: ViTConfig, images: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    logits = apply(params, cfg, images)
    return layers.softmax_cross_entropy(logits, labels).mean()


def param_count(params: Params) -> int:
    return sum(int(p.numel()) for p in leaves(params))
