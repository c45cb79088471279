"""Plain attention ops — the single-device part of
``determined_clone_tpu/ops/attention.py``.

``mha`` is the reference every attention path is held against and the
attention of the paged serving forward. The public functions keep the
JAX package's ``[B, T, H, D]`` layout.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

NEG_INF = -1e30


def _causal_mask(q_len: int, k_len: int, q_offset: int = 0,
                 k_offset: int = 0,
                 device: Union[str, torch.device, None] = None
                 ) -> torch.Tensor:
    """[q_len, k_len] bool mask; True = attendable."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = k_offset + torch.arange(k_len, device=device)[None, :]
    return q_pos >= k_pos


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention. q,k,v: [B, T, H, D]. Scores and softmax in
    fp32; probabilities go back to ``q.dtype`` for the second product.
    ``mask`` broadcasts against the [B, H, Tq, Tk] scores."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(d)
    if causal:
        cm = _causal_mask(q.shape[1], k.shape[1], device=q.device)
        scores = scores.masked_fill(~cm, NEG_INF)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor, *,
                     base: float = 10000.0) -> torch.Tensor:
    """RoPE, half-split. x: [B, T, H, D] (D even), positions: [T] or
    [B, T]. Rotation in fp32, result in ``x.dtype``."""
    D = x.shape[-1]
    half = D // 2
    freqs = base ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)
