"""Analytic FLOPs accounting and MFU — the port's copy of the GPT part of
``determined_clone_tpu/telemetry/flops.py``.

Per-training-step floating point operations from the model config alone:
a matmul of ``[m, k] @ [k, n]`` costs ``2*m*k*n`` FLOPs, and a training
step costs 3x the forward pass (1x forward + 2x backward), whatever
``cfg.remat``: MFU counts the model's work, not the recompute.

Per-token forward FLOPs by component, for ``L`` layers, width ``d``, FFN
width ``f``, sequence length ``s``, vocab ``V``:

- attention projections (q,k,v,out):      ``L * 8 * d^2``
- attention scores + value mix:           ``L * 4 * s * d``
- dense MLP (two matmuls):                ``L * 4 * d * f``
- MoE MLP (top-k of E experts):           ``L * k * 4 * d * f``
  plus router:                            ``L * 2 * d * E``
- logits:                                 ``2 * d * V``

The peak is the H100 SXM's dense bf16 tensor-core rate from NVIDIA's
data sheet, which assumes the card's full 700 W power limit; the JAX
package's TPU peaks have no place here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

# Training multiplier: forward + backward(2x).
TRAIN_MULT = 3.0

# NVIDIA H100 SXM, dense bf16 on the tensor cores, at 700 W.
H100_PEAK_BF16_FLOPS = 989e12


@dataclass(frozen=True)
class StepFlops:
    """FLOPs for one training step, with a component breakdown."""
    total: float
    per_token: float
    tokens: int
    breakdown: Dict[str, float]

    def flops_per_sec(self, step_seconds: float) -> float:
        if step_seconds <= 0:
            return 0.0
        return self.total / step_seconds


def attention_flops_per_token(d_model: int, seq_len: int,
                              n_layers: int) -> float:
    """Projections + scores + value mix, per token, forward pass."""
    proj = 8.0 * d_model * d_model
    mix = 4.0 * seq_len * d_model
    return n_layers * (proj + mix)


def mlp_flops_per_token(d_model: int, d_ff: int, n_layers: int, *,
                        moe_experts: int = 0, moe_k: int = 2) -> float:
    """Dense or MoE FFN per token, forward pass (router included)."""
    dense = 4.0 * d_model * d_ff
    if moe_experts and moe_experts > 1:
        k = max(1, min(moe_k, moe_experts))
        router = 2.0 * d_model * moe_experts
        return n_layers * (k * dense + router)
    return n_layers * dense


def moe_layer_flops(n_tokens: int, d_model: int, d_ff: int,
                    n_experts: int, *,
                    capacity_factor: float = 1.25) -> Dict[str, float]:
    """Exact forward FLOPs of one capacity-based MoE FFN layer for
    ``n_tokens`` tokens (router, dispatch, up, down, combine): with
    capacity ``C = ceil(N/E · cf)`` the experts compute their full
    capacity buffer, padded slots included."""
    n = float(n_tokens)
    d, f, e = float(d_model), float(d_ff), float(n_experts)
    c = float(max(1, math.ceil(n_tokens / n_experts * capacity_factor)))
    out = {
        "router": 2.0 * n * d * e,
        "dispatch": 2.0 * n * e * c * d,
        "up": 2.0 * e * c * d * f,
        "down": 2.0 * e * c * f * d,
        "combine": 2.0 * n * e * c * d,
    }
    out["total"] = sum(out.values())
    out["capacity"] = c
    return out


def embedding_flops_per_token(d_model: int, vocab_size: int) -> float:
    """Logit projection; the embedding lookup itself is a gather."""
    return 2.0 * d_model * vocab_size


def gpt_forward_flops_per_token(cfg: Any, seq_len: int) -> Dict[str, float]:
    """Per-token forward FLOPs breakdown for a GPT-family config
    (duck-typed: anything with GPTConfig's fields)."""
    return {
        "attention": attention_flops_per_token(
            cfg.d_model, seq_len, cfg.n_layers),
        "mlp": mlp_flops_per_token(
            cfg.d_model, cfg.d_ff, cfg.n_layers,
            moe_experts=getattr(cfg, "moe_experts", 0),
            moe_k=getattr(cfg, "moe_k", 2)),
        "embedding": embedding_flops_per_token(cfg.d_model, cfg.vocab_size),
    }


def gpt_train_step_flops(cfg: Any, batch_size: int,
                         seq_len: Optional[int] = None) -> StepFlops:
    """Analytic FLOPs for one training step of a GPT-family model (MoE
    configs get the exact capacity-based count)."""
    seq = int(seq_len or cfg.max_seq_len)
    tokens = int(batch_size) * seq
    breakdown = gpt_forward_flops_per_token(cfg, seq)
    moe_experts = getattr(cfg, "moe_experts", 0)
    if moe_experts and moe_experts > 1 and tokens > 0:
        layer = moe_layer_flops(
            tokens, cfg.d_model, cfg.d_ff, moe_experts,
            capacity_factor=getattr(cfg, "moe_capacity_factor", 1.25))
        breakdown["mlp"] = cfg.n_layers * layer["total"] / tokens
    per_token_fwd = sum(breakdown.values())
    per_token = TRAIN_MULT * per_token_fwd
    return StepFlops(
        total=per_token * tokens,
        per_token=per_token,
        tokens=tokens,
        breakdown={k: TRAIN_MULT * v * tokens for k, v in breakdown.items()},
    )


def mfu(flops_per_sec: float, peak_flops: float = H100_PEAK_BF16_FLOPS,
        n_devices: int = 1) -> float:
    """Model FLOPs utilization against ``n_devices`` cards of peak."""
    denom = peak_flops * max(1, n_devices)
    if denom <= 0:
        return 0.0
    return flops_per_sec / denom
