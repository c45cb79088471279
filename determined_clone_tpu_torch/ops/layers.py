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


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")
