"""Analytic FLOPs accounting and MFU — the port's copy of the GPT part of
``determined_clone_tpu/telemetry/flops.py``: the training counts and the
serving ones (prefill, KV-cached decode, whole requests, the speculative
verify and step).

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

The ``6 * n_params`` approximation is :func:`dense_train_flops_per_token`,
for trials without an analytic count.

The peak is the H100 SXM's dense bf16 tensor-core rate from NVIDIA's
data sheet, which assumes the card's full 700 W power limit, and the
interconnect its NVLink 4 rate per direction
(:func:`peak_flops_estimate`, :func:`interconnect_bandwidth_estimate`,
each with a provenance label); the JAX package's TPU peaks have no place
here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

# Training multiplier: forward + backward(2x).
TRAIN_MULT = 3.0

# NVIDIA H100 SXM, dense bf16 on the tensor cores, at 700 W.
H100_PEAK_BF16_FLOPS = 989e12
# An order-of-magnitude CPU estimate (the JAX package's): it makes MFU
# non-null and comparable across runs on one machine, nothing more; its
# provenance label says so.
CPU_PEAK_EST_FLOPS = 50e9
# Per-direction NVLink 4 bandwidth of one H100 SXM (900 GB/s both ways);
# the CPU number (the JAX package's) stands in for shared memory between
# gloo ranks on one host.
H100_NVLINK_BYTES_PER_S = 450e9
CPU_INTERCONNECT_EST_BYTES_PER_S = 10e9


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
                    capacity_factor: float = 1.25,
                    dispatch: str = "einsum") -> Dict[str, float]:
    """Exact forward FLOPs of one capacity-based MoE FFN layer for
    ``n_tokens`` tokens (router, dispatch, up, down, combine): with
    capacity ``C = ceil(N/E · cf)`` the experts compute their full
    capacity buffer, padded slots included. ``dispatch="einsum"`` counts
    the JAX package's one-hot dispatch and combine products;
    ``"index"`` counts the port's ``ops/moe.py``, which gathers rows by
    index instead (no products there: dispatch and combine are 0)."""
    if dispatch not in ("einsum", "index"):
        raise ValueError(f"dispatch must be einsum or index, got "
                         f"{dispatch!r}")
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
    if dispatch == "index":
        out["dispatch"] = out["combine"] = 0.0
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
                         seq_len: Optional[int] = None, *,
                         moe_dispatch: str = "einsum") -> StepFlops:
    """Analytic FLOPs for one training step of a GPT-family model (MoE
    configs get the exact capacity-based count of ``moe_dispatch``'s
    form, :func:`moe_layer_flops`)."""
    seq = int(seq_len or cfg.max_seq_len)
    tokens = int(batch_size) * seq
    breakdown = gpt_forward_flops_per_token(cfg, seq)
    moe_experts = getattr(cfg, "moe_experts", 0)
    if moe_experts and moe_experts > 1 and tokens > 0:
        layer = moe_layer_flops(
            tokens, cfg.d_model, cfg.d_ff, moe_experts,
            capacity_factor=getattr(cfg, "moe_capacity_factor", 1.25),
            dispatch=moe_dispatch)
        breakdown["mlp"] = cfg.n_layers * layer["total"] / tokens
    per_token_fwd = sum(breakdown.values())
    per_token = TRAIN_MULT * per_token_fwd
    return StepFlops(
        total=per_token * tokens,
        per_token=per_token,
        tokens=tokens,
        breakdown={k: TRAIN_MULT * v * tokens for k, v in breakdown.items()},
    )


def gpt_prefill_flops(cfg: Any, prompt_len: int) -> Dict[str, float]:
    """Forward FLOPs of one serving prefill over a ``prompt_len`` prompt.

    Same accounting convention as training (full [T, S] score matmul —
    masking saves nothing arithmetically): each of the P prompt tokens
    costs ``attention(s=P) + mlp + embedding``, so the call total is just
    P times the per-token forward breakdown at sequence length P. Keys
    are component totals for the whole call, plus ``"total"``.
    """
    per_tok = gpt_forward_flops_per_token(cfg, int(prompt_len))
    out = {k: v * float(prompt_len) for k, v in per_tok.items()}
    out["total"] = sum(out.values())
    return out


def gpt_decode_flops_per_token(cfg: Any, context_len: int) -> Dict[str, float]:
    """Forward FLOPs of ONE incremental decode step at KV-cache context
    length ``context_len`` — the formula that makes serving MFU honest.

    With the KV cache, the new token pays the full projections
    (``L·8d²``) and MLP (``L·4df``) but its attention mix is linear in
    the *context*, not quadratic in the sequence: scores ``[1, c]`` and
    the value mix cost ``L·4·c·d`` (2cd QKᵀ + 2cd PV per layer). Compare
    :func:`gpt_prefill_flops`, where every prompt token pays ``4·P·d`` —
    the asymmetry is exactly why serving splits prefill from decode.
    """
    c = float(context_len)
    out = {
        "attention": cfg.n_layers * (8.0 * cfg.d_model * cfg.d_model
                                     + 4.0 * c * cfg.d_model),
        "mlp": mlp_flops_per_token(
            cfg.d_model, cfg.d_ff, cfg.n_layers,
            moe_experts=getattr(cfg, "moe_experts", 0),
            moe_k=getattr(cfg, "moe_k", 2)),
        "embedding": embedding_flops_per_token(cfg.d_model, cfg.vocab_size),
    }
    out["total"] = sum(out.values())
    return out


def gpt_generation_flops(cfg: Any, prompt_len: int, new_tokens: int, *,
                         prefill_from: int = 0) -> float:
    """Total forward FLOPs to serve one request: one prefill of
    ``prompt_len`` plus ``new_tokens - 1`` incremental decode steps (the
    first generated token falls out of the prefill logits; decode step j
    runs at context ``prompt_len + j``).

    ``prefill_from`` accounts for prefix sharing: positions before it
    were aliased from the prefix cache, so only the suffix tokens pay
    prefill FLOPs (each still at full sequence length ``prompt_len`` —
    the same accounting convention as :func:`gpt_prefill_flops`). The
    re-scored last prompt token keeps the suffix count >= 1.
    """
    p, n = int(prompt_len), int(new_tokens)
    skip = min(max(0, int(prefill_from)), p - 1)
    per_tok = gpt_forward_flops_per_token(cfg, p)
    total = sum(per_tok.values()) * float(p - skip)
    for j in range(1, n):
        total += gpt_decode_flops_per_token(cfg, p + j)["total"]
    return total


def gpt_verify_flops(cfg: Any, context_len: int, k: int) -> Dict[str, float]:
    """Forward FLOPs of ONE speculative verify call: the target scores
    ``k + 1`` tokens (last committed token + k drafts) starting at
    context ``context_len``. Each scored token pays the full projections
    + MLP + embedding of a decode step, and its attention mix is linear
    in its OWN context — token i of the call sees ``context_len + i``
    cached positions — so the call total is the sum of k+1 consecutive
    decode-step counts. This is why acceptance rate is the whole game:
    the verify call costs what k+1 sequential decode steps cost, but
    only ``accepted + 1`` of its tokens are emitted.
    """
    out: Dict[str, float] = {}
    for i in range(int(k) + 1):
        step = gpt_decode_flops_per_token(cfg, int(context_len) + i)
        for key, v in step.items():
            out[key] = out.get(key, 0.0) + v
    return out


def gpt_speculative_step_flops(cfg: Any, draft_cfg: Any, context_len: int,
                               k: int) -> Dict[str, float]:
    """Forward FLOPs of one whole speculative iteration for one
    sequence: k single-token draft proposals (each an incremental decode
    step of the draft model at its growing context) plus the target's
    k+1-token verify call. Returns ``{"draft", "verify", "total"}`` —
    the per-emitted-token cost is ``total / (accepted + 1)``, which is
    the quantity the speculative step trades against plain decode.
    """
    c = int(context_len)
    draft = sum(gpt_decode_flops_per_token(draft_cfg, c + i)["total"]
                for i in range(int(k)))
    verify = gpt_verify_flops(cfg, c, k)["total"]
    return {"draft": draft, "verify": verify, "total": draft + verify}


def dense_train_flops_per_token(n_params: int) -> float:
    """The ``6 * N`` approximation for configs we can't decompose."""
    return 6.0 * float(n_params)


def dense_train_step_flops(n_params: int, batch_size: int,
                           seq_len: int) -> StepFlops:
    per_token = dense_train_flops_per_token(n_params)
    tokens = int(batch_size) * int(seq_len)
    return StepFlops(total=per_token * tokens, per_token=per_token,
                     tokens=tokens, breakdown={"dense_6n": per_token * tokens})


def _platform(platform: Optional[str]) -> str:
    """``platform`` lower-cased, else ``gpu`` when this process has
    initialised CUDA and ``cpu`` otherwise."""
    if platform:
        return platform.lower()
    import torch

    return "gpu" if torch.cuda.is_initialized() else "cpu"


def _card_name(device_name: Optional[str]) -> str:
    if device_name is not None:
        return device_name.lower()
    import torch

    return torch.cuda.get_device_name().lower()


def peak_flops_estimate(platform: Optional[str] = None,
                        device_name: Optional[str] = None,
                        ) -> Tuple[float, str]:
    """Best-available peak FLOPs of one card: ``(peak, provenance)``.

    ``gpu`` whose name (``device_name``, default
    ``torch.cuda.get_device_name()``) says H100: the H100 SXM's dense
    bf16 rate, labelled ``gpu:h100``; any other card is assumed to be one,
    labelled ``gpu:h100:assumed``; the CPU gets ``cpu:est``. MFU
    consumers carry the label next to the number so that an assumed peak
    never passes as a known one.
    """
    plat = _platform(platform)
    if plat == "gpu":
        if "h100" in _card_name(device_name):
            return H100_PEAK_BF16_FLOPS, "gpu:h100"
        return H100_PEAK_BF16_FLOPS, "gpu:h100:assumed"
    return CPU_PEAK_EST_FLOPS, "cpu:est"


def interconnect_bandwidth_estimate(platform: Optional[str] = None,
                                    device_name: Optional[str] = None,
                                    ) -> Tuple[float, str]:
    """Best-available per-card interconnect bandwidth (bytes/s), with the
    provenance contract of :func:`peak_flops_estimate`: an H100's NVLink 4
    per direction (``gpu:h100:nvlink4``; ``...:assumed`` on another card),
    the CPU's shared-memory estimate ``cpu:est`` for gloo ranks. The
    comm/compute fraction (``telemetry/collectives.py``) divides payload
    bytes by it."""
    plat = _platform(platform)
    if plat == "gpu":
        label = ("gpu:h100:nvlink4" if "h100" in _card_name(device_name)
                 else "gpu:h100:nvlink4:assumed")
        return H100_NVLINK_BYTES_PER_S, label
    return CPU_INTERCONNECT_EST_BYTES_PER_S, "cpu:est"


def mfu(flops_per_sec: float, peak_flops: float = H100_PEAK_BF16_FLOPS,
        n_devices: int = 1) -> float:
    """Model FLOPs utilization against ``n_devices`` cards of peak."""
    denom = peak_flops * max(1, n_devices)
    if denom <= 0:
        return 0.0
    return flops_per_sec / denom
