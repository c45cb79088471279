"""Functional NN layers over plain dicts of tensors — the port of
``determined_clone_tpu/ops/layers.py``.

Same dtype policy as the JAX package: parameters are fp32, activations
run in the compute dtype (bf16 by default), normalisation statistics are
fp32. Initialisers draw from a ``torch.Generator`` in place of a JAX key;
the two frameworks give different numbers from one seed, so parity tests
build weights on the JAX side and convert them (``convert.py``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def trunc_normal(gen: torch.Generator, shape: Tuple[int, ...],
                 stddev: float = 0.02, dtype=torch.float32,
                 device: Any = None) -> torch.Tensor:
    """``stddev`` times a normal truncated to [-2, 2], drawn on the
    generator's device and moved to ``device`` (default: stay there)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    t = (stddev * t).to(dtype)
    return t if device is None else t.to(device)


def lecun_normal(gen: torch.Generator, shape: Tuple[int, ...],
                 fan_in: Optional[int] = None, dtype=torch.float32,
                 device: Any = None) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    return trunc_normal(gen, shape, stddev=math.sqrt(1.0 / max(1, fan_in)),
                        dtype=dtype, device=device)


def he_normal(gen: torch.Generator, shape: Tuple[int, ...],
              fan_in: Optional[int] = None, dtype=torch.float32,
              device: Any = None) -> torch.Tensor:
    fan_in = fan_in if fan_in is not None else shape[0]
    return trunc_normal(gen, shape, stddev=math.sqrt(2.0 / max(1, fan_in)),
                        dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Dense / embedding / norms
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               bias: bool = True, dtype=torch.float32,
               device: Any = None) -> Params:
    p: Params = {"kernel": lecun_normal(gen, (in_dim, out_dim), dtype=dtype,
                                        device=device)}
    if bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def dense(params: Params, x: torch.Tensor, *,
          compute_dtype=None) -> torch.Tensor:
    """``x @ kernel (+ bias)``; with ``compute_dtype`` both operands are
    cast first, and the bias is added in the product's dtype."""
    k = params["kernel"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        k = k.to(compute_dtype)
    y = x @ k
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


def embedding_init(gen: torch.Generator, vocab: int, dim: int,
                   dtype=torch.float32, device: Any = None) -> Params:
    return {"table": trunc_normal(gen, (vocab, dim), dtype=dtype,
                                  device=device)}


def embedding(params: Params, ids: torch.Tensor, *,
              compute_dtype=None) -> torch.Tensor:
    # gather, then cast: the same values as casting the table first (the
    # cast is elementwise) without converting the whole vocabulary
    x = params["table"][ids]
    return x if compute_dtype is None else x.to(compute_dtype)


def layernorm_init(dim: int, dtype=torch.float32, device: Any = None
                   ) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    # statistics in fp32 whatever the activation dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rmsnorm_init(dim: int, dtype=torch.float32, device: Any = None
                 ) -> Params:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Convolutions and pools (the ResNet / mnist-CNN families)
#
# Activations are NHWC and kernels HWIO, as in the JAX package, so the
# parameter trees and checkpoints are the same. At call time an NHWC tensor
# is viewed as NCHW with ``permute(0, 3, 1, 2)`` — a channels-last tensor,
# no copy — so cuDNN runs NHWC; the result is permuted back the same way.
# ---------------------------------------------------------------------------

def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's ``"SAME"`` along a dimension of size
    ``n``: ``ceil(n / stride)`` outputs, the odd pixel of padding on the
    high side. A 3×3/2 window on an even size pads (0, 1), where torch's
    symmetric ``padding=1`` would shift every window up by a pixel."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_nchw(x: torch.Tensor, kh: int, kw: int, stride: int,
              padding: str, value: float = 0.0) -> torch.Tensor:
    """``x`` (an NCHW view) padded as ``padding`` ("SAME" or "VALID")
    pads it for a ``kh×kw`` window at ``stride``."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    top, bottom = same_pads(x.shape[2], kh, stride)
    left, right = same_pads(x.shape[3], kw, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def conv_init(gen: torch.Generator, in_ch: int, out_ch: int, kernel: int, *,
              dtype=torch.float32, device: Any = None) -> Params:
    shape = (kernel, kernel, in_ch, out_ch)  # HWIO
    return {"kernel": he_normal(gen, shape, fan_in=kernel * kernel * in_ch,
                                dtype=dtype, device=device)}


def conv2d(params: Params, x: torch.Tensor, *, stride: int = 1,
           padding: str = "SAME", compute_dtype=None) -> torch.Tensor:
    """NHWC convolution with an HWIO kernel and XLA's padding rules
    (``lax.conv_general_dilated``); the asymmetric "SAME" pads are
    applied explicitly."""
    k = params["kernel"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        k = k.to(compute_dtype)
    kh, kw = k.shape[0], k.shape[1]
    xc = _pad_nchw(x.permute(0, 3, 1, 2), kh, kw, stride, padding)
    # OIHW view of a channels-last (OHWI) copy of the kernel
    w = k.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
    return F.conv2d(xc, w, stride=stride).permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: str = "VALID") -> torch.Tensor:
    """NHWC max pool with XLA's padding rules: "SAME" pads with -inf
    (``lax.reduce_window(x, -inf, max, ...)``), on the high side first."""
    xc = _pad_nchw(x.permute(0, 3, 1, 2), window, window, stride, padding,
                   value=float("-inf"))
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


def batchnorm_init(ch: int, dtype=torch.float32, device: Any = None
                   ) -> Params:
    return {"scale": torch.ones((ch,), dtype=dtype, device=device),
            "bias": torch.zeros((ch,), dtype=dtype, device=device),
            "mean": torch.zeros((ch,), dtype=dtype, device=device),
            "var": torch.ones((ch,), dtype=dtype, device=device)}


def batchnorm(params: Params, x: torch.Tensor, *, training: bool,
              momentum: float = 0.9, eps: float = 1e-5
              ) -> Tuple[torch.Tensor, Params]:
    """BatchNorm over the last (channel) axis with functional running
    stats → ``(y, new_params)``. Training normalises by the batch's
    *biased* variance ``E[x²] - mean²`` in fp32 and moves the running
    stats as ``momentum * old + (1 - momentum) * batch`` — the JAX
    formulas, not ``F.batch_norm``'s (unbiased running variance, the
    opposite momentum)."""
    xf = x.float()
    if training:
        axes = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=axes)
        var = xf.square().mean(dim=axes) - mean.square()
        new_stats = {**params,
                     "mean": momentum * params["mean"] + (1 - momentum) * mean,
                     "var": momentum * params["var"] + (1 - momentum) * var}
    else:
        mean, var = params["mean"], params["var"]
        new_stats = params
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"] + params["bias"]
    return y.to(x.dtype), new_stats


def groupnorm_init(ch: int, dtype=torch.float32, device: Any = None
                   ) -> Params:
    return {"scale": torch.ones((ch,), dtype=dtype, device=device),
            "bias": torch.zeros((ch,), dtype=dtype, device=device)}


def groupnorm(params: Params, x: torch.Tensor, *, groups: int = 32,
              eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over NHWC: groups of contiguous channels, ``min(groups,
    C)`` of them, one fewer at a time until they divide C (C=48 with 32
    groups gives 24). Statistics in fp32 (the population variance of the
    deviations); the result in ``x``'s dtype."""
    B, H, W, C = x.shape
    g = min(groups, C)
    while C % g != 0:
        g -= 1
    xf = x.float().reshape(B, H, W, g, C // g)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2, 4), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, H, W, C)
    y = y * params["scale"] + params["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# Dropout, loss, metrics
# ---------------------------------------------------------------------------

def fold_seed(seed: int, *data: int) -> int:
    """A new 63-bit seed from ``seed`` and ``data`` — the port's
    ``jax.random.fold_in``/``split``: distinct inputs give independent
    seeds, and the same inputs always the same one."""
    state = np.random.SeedSequence([seed, *data]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            rows: Optional[Tuple[int, int]] = None,
            seq: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``; ``x`` as it is when ``generator``
    is None (not training) or ``rate`` is 0. The mask is drawn from
    ``generator``, which must live on ``x``'s device — an explicit
    generator, never the global one, so a recompute that seeds a fresh
    generator alike draws the same mask (``models/gpt.py``). With
    ``rows=(first, total)``, ``x`` is rows ``first:first + len(x)`` of a
    batch of ``total`` rows: the mask is drawn at the whole batch's shape
    and cut to those rows, so every split of the batch draws the same
    masks; ``seq=(first, total)`` does the same for dimension 1 (a block
    of the sequence)."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    shape = list(x.shape)
    if rows is not None:
        shape[0] = rows[1]
    if seq is not None:
        shape[1] = seq[1]
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if rows is not None:
        mask = mask[rows[0]:rows[0] + x.shape[0]]
    if seq is not None:
        mask = mask[:, seq[0]:seq[0] + x.shape[1]]
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-example loss; logits [..., C], integer labels [...]. Computed
    in fp32 whatever the logits' dtype."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels[..., None].long()).squeeze(-1)
    loss = logz - label_logit
    if label_smoothing > 0.0:
        smooth = logz - logits.mean(dim=-1)
        loss = (1 - label_smoothing) * loss + label_smoothing * smooth
    return loss


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).float().mean()
