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
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``; ``x`` as it is when ``generator``
    is None (not training) or ``rate`` is 0. The mask is drawn from
    ``generator``, which must live on ``x``'s device — an explicit
    generator, never the global one, so a recompute that seeds a fresh
    generator alike draws the same mask (``models/gpt.py``)."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
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
