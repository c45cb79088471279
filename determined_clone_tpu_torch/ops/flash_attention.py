"""Flash attention — the port of
``determined_clone_tpu/ops/flash_attention.py``.

The TPU kernel (``_fwd_kernel`` under ``pl.pallas_call``) becomes a CUDA
kernel written for Hopper, ``csrc/flash_attn_fwd.cu``; its source note
says how the TPU grid translates and what bounds it on the card.

:func:`flash_attention` keeps the JAX wrapper's contract: q, k, v in the
``[B, T, H, D]`` layout, block sizes clamped to the sequence lengths,
``ValueError`` when a length does not divide. Tensors on the CPU take the
plain version, :func:`flash_attention_reference`, which walks the same
tile loop as the TPU kernel (online softmax in fp32, causal tiles above
the diagonal skipped); any other tensor launches the kernel or raises —
there is no fallback from the card to the plain version.

The kernel tiles and masks ragged edges itself, so the block contract is
the JAX wrapper's, not the kernel's: :func:`flash_attention_kernel` is the
kernel route at any lengths, which the GPT block takes on the card in
place of padding T to a block multiple.

Both routes go through :class:`FlashAttentionFunction`, the port of the
JAX ``custom_vjp``: the forward is the kernel (or, on the CPU, the plain
version) and saves only q, k, v; the backward recomputes attention with
``causal_blockwise_attention`` and differentiates that, as ``_vjp_bwd``
does. The TPU side has no backward kernel, so neither has the port: the
backward is plain PyTorch on either device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from determined_clone_tpu_torch.ops.attention import causal_blockwise_attention

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              block_q: int = 128,
                              block_k: int = 128) -> torch.Tensor:
    """Plain PyTorch version of the kernel, tile by tile: per query block,
    an online softmax over the key blocks with m/l/acc in fp32, the
    fully-masked-row guard on ``alpha``, and ``acc / max(l, 1e-30)`` in
    the input dtype. Blocks must divide the lengths (the caller clamps)."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    scale = 1.0 / (D ** 0.5)
    qf = q.permute(0, 2, 1, 3).float() * scale     # [B, H, Tq, D]
    kf = k.permute(0, 2, 1, 3).float()
    vf = v.permute(0, 2, 1, 3).float()
    out = torch.empty((B, H, Tq, D), dtype=torch.float32, device=q.device)
    for q0 in range(0, Tq, block_q):
        qb = qf[:, :, q0:q0 + block_q]
        m = torch.full((B, H, block_q), NEG_INF, device=q.device)
        l = torch.zeros((B, H, block_q), device=q.device)
        acc = torch.zeros((B, H, block_q, D), device=q.device)
        q_pos = q0 + torch.arange(block_q, device=q.device)[:, None]
        for k0 in range(0, Tk, block_k):
            if causal and q0 + block_q - 1 < k0:
                continue  # tile strictly above the diagonal
            s = qb @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)
            if causal:
                keep = q_pos >= k0 + torch.arange(block_k,
                                                  device=q.device)[None, :]
                s = s.masked_fill(~keep, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # fully-masked-so-far rows: exp(NEG_INF - NEG_INF) must not be 1
            alpha = torch.exp(torch.where(m > NEG_INF / 2, m - m_new,
                                          torch.full_like(m, NEG_INF)))
            p = torch.exp(s - m_new[..., None])
            if causal:
                p = p.masked_fill(~keep, 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p @ vf[:, :, k0:k0 + block_k]
            m = m_new
        out[:, :, q0:q0 + block_q] = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Fused attention. q,k,v: [B, T, H, D]; matches ``mha`` numerically
    (fp32 softmax). Block sizes clamp to the sequence lengths, which must
    then divide evenly. ``flash_attention.launches`` counts kernel
    launches (not calls of the plain version)."""
    block_q = min(block_q, q.shape[1])
    block_k = min(block_k, k.shape[1])
    if q.shape[1] % block_q != 0:
        raise ValueError(
            f"q length {q.shape[1]} not divisible by block_q {block_q}")
    if k.shape[1] % block_k != 0:
        raise ValueError(
            f"k length {k.shape[1]} not divisible by block_k {block_k}")
    _same_device(q, k, v)
    return FlashAttentionFunction.apply(q, k, v, causal, block_q, block_k)


flash_attention.launches = 0


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           block_k: int = 128) -> torch.Tensor:
    """The kernel at any lengths Tq, Tk: no block contract, no padding.
    Never takes the plain version; raises for tensors off the card.
    ``block_k`` is the key block of the backward's recompute."""
    _same_device(q, k, v)
    return FlashAttentionFunction.apply(q, k, v, causal, None, block_k)


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with the JAX package's VJP (``_vjp_fwd`` and
    ``_vjp_bwd``). ``block_q`` None is the kernel route at any lengths;
    otherwise CPU tensors take the plain version at the given blocks."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_q: Optional[int],
                block_k: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.block_k = causal, block_k
        if block_q is not None and q.device.type == "cpu":
            return flash_attention_reference(q, k, v, causal=causal,
                                             block_q=block_q,
                                             block_k=block_k)
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        Tq, Tk = q.shape[1], k.shape[1]
        blk = min(ctx.block_k, Tk)
        # the recompute's blocks must divide Tk, and the kernel route
        # takes any T: pad K/V with zero rows to a block multiple. Safe
        # only when causal with Tq <= Tk — the padded keys come after
        # every real query, so none attends to them (JAX pads the GPT
        # block's q, k, v on the same argument). Otherwise one block of
        # all the keys.
        pad = -Tk % blk
        if pad and not (ctx.causal and Tq <= Tk):
            blk, pad = Tk, 0
        with torch.enable_grad():
            # k and v may be strided views of the fused qkv projection:
            # the gradients come back contiguous, in their shapes
            q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
            kp, vp = k, v
            if pad:
                kp, vp = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
            out = causal_blockwise_attention(q, kp, vp, block_size=blk,
                                             causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def _same_device(q, k, v) -> None:
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on different devices: "
                         f"{q.device}, {k.device}, {v.device}")


def check_kernel_args(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> tuple:
    """What the kernel takes, checked without a card: [B, T, H, D] with
    matching B, H, D and Tk; one dtype of float32 or bfloat16; D in
    ``_HEAD_DIMS``; a contiguous head dimension; base pointers and the B,
    T and H strides (in bytes) multiples of 16, for the 16-byte
    asynchronous copies. The stride of a dimension of size 1 is never
    used, so it is passed as 0 and not checked. Raises ``ValueError``;
    returns ``(B, H, Tq, Tk, D, strides)``, ``strides`` the 9 element
    strides (batch, time, head) of q, k, v. A DTensor is refused: the
    kernel takes each rank's local q, k, v (``models/gpt.py`` passes its
    own heads under ``tp``), never a view it would have to gather."""
    if any(hasattr(t, "placements") for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes local tensors, not "
                         "DTensors: pass each rank's own q, k, v")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, T, H, D]")
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    if k.shape != (B, Tk, H, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        st, sh, item = t.stride(), t.shape, t.element_size()
        if st[3] != 1:
            raise ValueError("the head dimension of q, k, v must be "
                             "contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}'s data pointer is not 16-byte aligned")
        for i, dim in enumerate("BTH"):
            s = st[i] if sh[i] > 1 else 0
            if s * item % 16:
                raise ValueError(f"{name}'s {dim} stride ({st[i]} elements) "
                                 f"is not a multiple of 16 bytes")
            strides.append(s)
    return B, H, Tq, Tk, D, tuple(strides)


def kernel_flops(B: int, H: int, Tq: int, Tk: int, D: int,
                 causal: bool) -> float:
    """The FLOPs of one kernel launch: two products (``QKᵀ`` and ``PV``)
    of ``2·D`` per (query, key) pair it attends — every pair, or with
    ``causal`` the pairs with key index <= query index."""
    if causal:
        n = min(Tq, Tk)
        pairs = n * (n + 1) // 2 + (Tq - n) * Tk
    else:
        pairs = Tq * Tk
    return 4.0 * B * H * D * pairs


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    """Launch the kernel built from ``csrc/flash_attn_fwd.cu`` on the
    current stream, count the launch, and add its FLOPs to a compile
    capture in progress (``telemetry/compile.py``): called through
    ctypes, the kernel is invisible to ``FlopCounterMode``."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel needs CUDA tensors, got "
                         f"{q.device}")
    from determined_clone_tpu_torch.ops import _build
    from determined_clone_tpu_torch.telemetry.compile import add_flops

    o = run_kernel(_build.library("flash_attn_fwd"), q, k, v, causal)
    if o.numel():
        flash_attention.launches += 1
        B, Tq, H, D = q.shape
        add_flops(kernel_flops(B, H, Tq, k.shape[1], D, causal))
    return o


def run_kernel(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Check what the kernel takes, allocate the output and launch the
    kernel of ``lib`` (a library with the ``flash_attn_fwd`` C interface)
    on the current stream; nothing to launch for an empty output."""
    B, H, Tq, Tk, D, strides = check_kernel_args(q, k, v)
    o = torch.empty((B, Tq, H, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    ost = o.stride()
    c_strides = (ctypes.c_longlong * 12)(
        *strides, ost[0] if B > 1 else 0, ost[1] if Tq > 1 else 0,
        ost[2] if H > 1 else 0)
    args = (_DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), B, H, Tq, Tk, c_strides,
            1.0 / D ** 0.5, int(causal))
    with torch.cuda.device(q.device):
        err = lib.flash_attn_fwd(*args,
                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.flash_attn_error_string(err).decode()
        raise RuntimeError(f"flash_attn_fwd launch failed ({err}): {msg}")
    return o
