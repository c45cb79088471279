"""Plain attention ops — the single-device part of
``determined_clone_tpu/ops/attention.py``.

``mha`` is the reference every attention path is held against and the
attention of the paged serving forward. ``causal_blockwise_attention``
is the streaming form, O(T·block) memory: the GPT block's "blockwise"
attention and the recompute that the flash kernel's backward
differentiates. The public functions keep the JAX package's
``[B, T, H, D]`` layout. ``ring_attention`` and ``ulysses_attention``
are sequence parallelism over a mesh axis (``sp``): plain PyTorch and
``torch.distributed``, as the JAX functions are plain JAX inside a
``shard_map``; they take the DeviceMesh where the JAX ones take the
``shard_map``'s axis name alone.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Union

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


def _sp_context(mesh: Any, axis_name: str):
    from determined_clone_tpu_torch.parallel.spmd import SpmdContext

    ctx = SpmdContext(mesh)
    if axis_name not in ctx.sizes:
        raise ValueError(f"the mesh has no axis {axis_name!r}")
    return ctx


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis_name: str, mesh: Any,
                   axis_index: Optional[int] = None,
                   axis_size: Optional[int] = None) -> torch.Tensor:
    """Causal ring attention: the sequence axis is split over mesh axis
    ``axis_name``; Q stays put while the K/V blocks travel the ring
    (``SpmdContext.shift``, whose backward is the reverse shift), so
    every query block sees the whole sequence with only neighbour
    traffic. Each step merges one block into an fp32 online softmax.

    q,k,v: [B, T_local, H, D], this rank's block of the sequence; its
    queries' global positions are axis_index*T_local + [0, T_local).
    ``axis_index``/``axis_size`` default to this rank's coordinate and
    the axis' size on ``mesh`` (a DeviceMesh), and must agree with them.
    Blocks wholly above the diagonal are computed and masked, as in the
    JAX loop.
    """
    ctx = _sp_context(mesh, axis_name)
    n, me = ctx.sizes[axis_name], ctx.coord[axis_name]
    if (axis_size, axis_index) != (None, None) and (
            axis_size != n or int(axis_index) != me):
        raise ValueError(f"axis_index/axis_size ({axis_index}, {axis_size}) "
                         f"disagree with the mesh's {axis_name!r}: ({me}, "
                         f"{n})")
    B, T, H, D = q.shape
    scale = 1.0 / (D ** 0.5)
    acc = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    for i in range(n):
        # the K/V held now came from rank (me - i) mod n
        src = (me - i) % n
        bmask = _causal_mask(T, T, q_offset=me * T, k_offset=src * T,
                             device=q.device)
        acc, m, l = _online_softmax_block((acc, m, l), q, k, v,
                                          bmask[None, None], scale)
        if i < n - 1:   # the JAX loop's last rotation is never read
            k, v = ctx.shift((k, v), axis_name)
    out = acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


class _AllToAll(torch.autograd.Function):
    """Block j of dimension 0 to rank j of ``group``, block r of the
    result from rank r; the backward sends each gradient block back."""

    @staticmethod
    def forward(ctx, blocks, group):
        import torch.distributed as dist

        ctx.group = group
        from determined_clone_tpu_torch.telemetry import collectives

        out = torch.empty_like(blocks)
        dist.all_to_all_single(out, blocks.contiguous(), group=group)
        collectives.note("all-to-all", group, out.nbytes)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g.contiguous(), ctx.group), None


def _all_to_all(x: torch.Tensor, scatter_dim: int, concat_dim: int,
                n: int, group) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` cut into n blocks along
    ``scatter_dim``, block j sent to rank j; the blocks received are
    joined along ``concat_dim`` in rank order. Differentiable (the
    backward is the reverse all-to-all)."""
    got = _AllToAll.apply(torch.stack(x.chunk(n, scatter_dim)), group)
    return torch.cat(got.unbind(0), concat_dim)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      axis_name: str, mesh: Any,
                      causal: bool = True) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism, the
    complement of ``ring_attention``: the sequence arrives split over
    ``axis_name``; all-to-alls reshard q/k/v to head-parallel layout
    ([B, T, H/sp, D]: the whole sequence for a slice of heads), ``mha``
    runs locally, and a last all-to-all reshards the output back. Four
    all-to-alls in all, each differentiable (its backward is the reverse
    all-to-all).

    q,k,v: [B, T_local, H, D]; H must be divisible by the axis size.
    """
    ctx = _sp_context(mesh, axis_name)
    sp = ctx.sizes[axis_name]
    if q.shape[2] % sp != 0:
        raise ValueError(
            f"ulysses_attention requires the head count ({q.shape[2]}) to "
            f"be divisible by the '{axis_name}' axis size ({sp}); use "
            f"ring_attention for indivisible head counts")
    if sp == 1:
        return mha(q, k, v, causal=causal)
    group = ctx.groups[axis_name]

    def a2a(x, scatter_dim, concat_dim):
        return _all_to_all(x, scatter_dim, concat_dim, sp, group)

    # [B, T/sp, H, D] -> [B, T, H/sp, D]: scatter heads, gather sequence
    qh, kh, vh = (a2a(t, 2, 1) for t in (q, k, v))
    out = mha(qh, kh, vh, causal=causal)
    # [B, T, H/sp, D] -> [B, T/sp, H, D]
    return a2a(out, 1, 2)


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
