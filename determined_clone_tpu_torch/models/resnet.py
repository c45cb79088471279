"""ResNet-GN — the port of ``determined_clone_tpu/models/resnet.py``
(BASELINE config #3, ResNet-50).

The JAX model's choices carry over: NHWC activations and HWIO kernels
(``ops/layers.conv2d`` views them channels-last for cuDNN), GroupNorm in
place of BatchNorm (batch-size independent, no running stats to thread
through the step), bf16 compute with fp32 params, and the blocks as a
plain loop (the stages are heterogeneous). The stride-2 convolutions and
the stem's max pool pad as XLA's "SAME" does, the odd pixel on the high
side.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.ops.layers import (
    conv2d,
    conv_init,
    dense,
    dense_init,
    groupnorm,
    groupnorm_init,
    max_pool,
    softmax_cross_entropy,
)
from determined_clone_tpu_torch.training.optim import leaves

Params = Dict[str, Any]

# stage depths per variant (bottleneck blocks; expansion 4)
DEPTHS = {
    26: (1, 2, 4, 1),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    n_classes: int = 1000
    width: int = 64          # stem/base width; stages are width*(1,2,4,8)
    channels: int = 3
    gn_groups: int = 32
    compute_dtype: Any = torch.bfloat16

    @property
    def stage_blocks(self) -> Tuple[int, int, int, int]:
        if self.depth not in DEPTHS:
            raise ValueError(
                f"unsupported resnet depth {self.depth}; "
                f"expected one of {sorted(DEPTHS)}")
        return DEPTHS[self.depth]

    @staticmethod
    def tiny() -> "ResNetConfig":
        return ResNetConfig(depth=26, n_classes=10, width=16,
                            compute_dtype=torch.float32)


def _block_init(gen: torch.Generator, c_in: int, c_mid: int, stride: int,
                dev: torch.device) -> Params:
    c_out = 4 * c_mid
    p = {
        "conv1": conv_init(gen, c_in, c_mid, 1, device=dev),
        "gn1": groupnorm_init(c_mid, device=dev),
        "conv2": conv_init(gen, c_mid, c_mid, 3, device=dev),
        "gn2": groupnorm_init(c_mid, device=dev),
        "conv3": conv_init(gen, c_mid, c_out, 1, device=dev),
        "gn3": groupnorm_init(c_out, device=dev),
    }
    if stride != 1 or c_in != c_out:
        p["proj"] = conv_init(gen, c_in, c_out, 1, device=dev)
        p["gn_proj"] = groupnorm_init(c_out, device=dev)
    return p


def init(gen: torch.Generator, cfg: ResNetConfig,
         device: DeviceLike = "cuda") -> Params:
    dev = resolve_device(device)
    params: Params = {
        "stem": conv_init(gen, cfg.channels, cfg.width, 7, device=dev),
        "gn_stem": groupnorm_init(cfg.width, device=dev),
    }
    c_in = cfg.width
    for s, n_blocks in enumerate(cfg.stage_blocks):
        c_mid = cfg.width * (2 ** s)
        for b in range(n_blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            params[f"s{s}b{b}"] = _block_init(gen, c_in, c_mid, stride, dev)
            c_in = 4 * c_mid
    params["head"] = dense_init(gen, c_in, cfg.n_classes, device=dev)
    return params


def _bottleneck(p: Params, cfg: ResNetConfig, x: torch.Tensor,
                stride: int) -> torch.Tensor:
    g, cd = cfg.gn_groups, cfg.compute_dtype
    h = conv2d(p["conv1"], x, compute_dtype=cd)
    h = torch.relu(groupnorm(p["gn1"], h, groups=g))
    h = conv2d(p["conv2"], h, stride=stride, compute_dtype=cd)
    h = torch.relu(groupnorm(p["gn2"], h, groups=g))
    h = conv2d(p["conv3"], h, compute_dtype=cd)
    h = groupnorm(p["gn3"], h, groups=g)
    if "proj" in p:
        x = groupnorm(p["gn_proj"],
                      conv2d(p["proj"], x, stride=stride, compute_dtype=cd),
                      groups=g)
    return torch.relu(x + h)


def _maxpool3_s2(x: torch.Tensor) -> torch.Tensor:
    return max_pool(x, 3, 2, "SAME")


def apply(params: Params, cfg: ResNetConfig, x: torch.Tensor
          ) -> torch.Tensor:
    """x: [B, H, W, C] NHWC → logits [B, n_classes] (fp32)."""
    x = conv2d(params["stem"], x, stride=2, compute_dtype=cfg.compute_dtype)
    x = torch.relu(groupnorm(params["gn_stem"], x, groups=cfg.gn_groups))
    x = _maxpool3_s2(x)
    for s, n_blocks in enumerate(cfg.stage_blocks):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            x = _bottleneck(params[f"s{s}b{b}"], cfg, x, stride)
    x = x.mean(dim=(1, 2))  # global average pool
    return dense(params["head"], x,
                 compute_dtype=cfg.compute_dtype).float()


def loss_fn(params: Params, cfg: ResNetConfig, x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    return softmax_cross_entropy(apply(params, cfg, x), y).mean()


def param_count(params: Params) -> int:
    return sum(int(p.numel()) for p in leaves(params))
