"""Plain attention ops — the single-device part of
``determined_clone_tpu/ops/attention.py``.

``mha`` is the reference every attention path is held against and the
attention of the paged serving forward. ``causal_blockwise_attention``
is the streaming form, O(T·block) memory: the GPT block's "blockwise"
attention and the recompute that the flash kernel's backward
differentiates. The public functions keep the JAX package's
``[B, T, H, D]`` layout. ``ring_attention`` and ``ulysses_attention``
belong to the parallelism slice.
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


def _online_softmax_block(carry, q: torch.Tensor, k_blk: torch.Tensor,
                          v_blk: torch.Tensor, block_mask: torch.Tensor,
                          scale: float):
    """One streaming-softmax step: merge a K/V block into (acc, m, l).

    acc: running unnormalised output [B, Tq, H, D] (fp32)
    m:   running row max             [B, H, Tq]     (fp32)
    l:   running row denominator     [B, H, Tq]     (fp32)
    """
    acc, m, l = carry
    # both products in fp32: bf16 operands are cast first (the JAX code's
    # preferred_element_type=float32 — bf16 intermediates overflow in the
    # backward); a bf16 product is exact in fp32, so the values agree
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    s = s.masked_fill(~block_mask, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows: exp(NEG_INF - NEG_INF) would be 1
    alpha = torch.exp(torch.where(m > NEG_INF / 2, m - m_new,
                                  torch.full_like(m, NEG_INF)))
    p = torch.exp(s - m_new[..., None])
    p = p.masked_fill(~block_mask, 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v_blk.float())
    return acc_new, m_new, l_new


def causal_blockwise_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, block_size: int = 512,
                               causal: bool = True) -> torch.Tensor:
    """Streaming attention over K/V blocks (a loop in place of the JAX
    ``lax.scan``); O(T·block) memory instead of O(T²). Matches ``mha``
    numerically (fp32 softmax); ``causal=False`` is the unmasked variant.
    The block must divide the K/V length (it clamps to it)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    dtype = q.dtype
    block_size = min(block_size, Tk)
    if Tk % block_size != 0:
        raise ValueError(f"block_size {block_size} must evenly divide the "
                         f"K/V sequence length {Tk}")
    scale = 1.0 / (D ** 0.5)
    q, k, v = q.float(), k.float(), v.float()  # once, not once per block
    acc = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device)
    for k0 in range(0, Tk, block_size):
        if causal:
            bmask = _causal_mask(Tq, block_size, k_offset=k0,
                                 device=q.device)
        else:
            bmask = torch.ones((Tq, block_size), dtype=torch.bool,
                               device=q.device)
        acc, m, l = _online_softmax_block(
            (acc, m, l), q, k[:, k0:k0 + block_size],
            v[:, k0:k0 + block_size], bmask, scale)
    out = acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(dtype)


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
