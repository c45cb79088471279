"""Frozen operation and byte counts of the work the benchmark measures.

The GPT counts are a copy of the port's ``telemetry/flops.py`` at the
time the benchmark was defined, frozen here so that a later change to the
program cannot move the yardstick: a ``[m, k] @ [k, n]`` product costs
``2*m*k*n``; a training step is 3x the forward (recompute not counted);
attention's score and value products are counted over the full
``[T, T]`` square, as that module counts them. The kernel counts follow
the kernels' contracts, from shapes alone: causal work is half the square,
and every input byte is read once and every output byte written once.
"""
from __future__ import annotations

from typing import Dict

TRAIN_MULT = 3.0


def gpt_forward_flops_per_token(cfg: dict, seq_len: int) -> Dict[str, float]:
    L, d, f, V = (cfg["n_layers"], cfg["d_model"], cfg["d_ff"],
                  cfg["vocab_size"])
    return {
        "attention": L * (8.0 * d * d + 4.0 * seq_len * d),
        "mlp": L * 4.0 * d * f,
        "embedding": 2.0 * d * V,
    }


def gpt_train_step_flops(cfg: dict, batch: int, seq_len: int) -> float:
    """Model FLOPs of one optimizer step over ``batch`` sequences."""
    per_tok = sum(gpt_forward_flops_per_token(cfg, seq_len).values())
    return TRAIN_MULT * per_tok * batch * seq_len


def gpt_prefill_flops(cfg: dict, prompt_len: int) -> float:
    """One request's prefill: each of its P tokens at sequence length P."""
    per_tok = sum(gpt_forward_flops_per_token(cfg, prompt_len).values())
    return per_tok * prompt_len


def gpt_decode_flops(cfg: dict, context_len: int) -> float:
    """One decode step of one sequence at KV context ``context_len``."""
    L, d, f, V = (cfg["n_layers"], cfg["d_model"], cfg["d_ff"],
                  cfg["vocab_size"])
    return (L * (8.0 * d * d + 4.0 * context_len * d) + L * 4.0 * d * f
            + 2.0 * d * V)


def gpt_request_flops(cfg: dict, prompt_len: int, new_tokens: int) -> float:
    """A served request: its prefill, then ``new_tokens - 1`` decode steps
    (the first token comes out of the prefill)."""
    total = gpt_prefill_flops(cfg, prompt_len)
    for j in range(1, new_tokens):
        total += gpt_decode_flops(cfg, prompt_len + j)
    return total


def causal_attention_fwd(B: int, H: int, T: int, D: int,
                         elem_bytes: int) -> Dict[str, float]:
    """Causal attention forward: ``q k^T`` and ``p v`` over the lower
    triangle, 2·B·H·T²·D; q, k, v read and o written once."""
    return {"flops": 2.0 * B * H * T * T * D,
            "bytes": 4.0 * B * H * T * D * elem_bytes}


def causal_attention_bwd(B: int, H: int, T: int, D: int,
                         elem_bytes: int) -> Dict[str, float]:
    """Causal attention backward: dQ, dK, dV and dP over the lower
    triangle, 4·B·H·T²·D (a recompute of the forward not counted); q, k,
    v, o and dO read and dq, dk, dv written once."""
    return {"flops": 4.0 * B * H * T * T * D,
            "bytes": 8.0 * B * H * T * D * elem_bytes}
