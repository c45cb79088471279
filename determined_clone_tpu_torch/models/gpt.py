"""GPT — the port of ``determined_clone_tpu/models/gpt.py``.

Parameters are a plain dict with the JAX package's stacked-block layout
(``blocks/<name>/<leaf>`` carry a leading ``[L]`` layer dimension), so
``convert.params_from_numpy`` maps the JAX tree one leaf to one leaf. A
Python loop over the layers takes the place of ``lax.scan``.

Covered: the uncached forward (``apply``, through the CUDA
flash-attention kernel on the card), training (``loss_fn`` with dropout
and remat per block; the flash backward recomputes through the blockwise
attention), and the paged prefill/decode forward the serving engine runs
(``forward_paged``). MoE, pipelining, ``forward_paged_logits`` and the
identity-layer helpers come in later slices.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.ops.attention import (
    causal_blockwise_attention,
    mha,
    rotary_embedding,
)
from determined_clone_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_kernel,
)
from determined_clone_tpu_torch.ops.layers import (
    dense,
    dense_init,
    dropout,
    embedding,
    embedding_init,
    fold_seed,
    gelu,
    layernorm,
    layernorm_init,
    softmax_cross_entropy,
    trunc_normal,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304          # gpt-neox vocab, padded to a multiple of 128
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 2048
    dropout: float = 0.0
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    # "auto" (flash on CUDA tensors, mha on the CPU), "mha" (plain
    # PyTorch), "blockwise" (the streaming form), "flash" (the CUDA
    # kernel; its plain version on the CPU). blockwise_attention=True is
    # the legacy spelling of "blockwise".
    attention_impl: str = "auto"
    blockwise_attention: bool = False
    attention_block_size: int = 512
    tie_embeddings: bool = True
    moe_experts: int = 0
    moe_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    pipeline_microbatches: int = 0

    def __post_init__(self) -> None:
        if self.moe_experts > 0:
            raise NotImplementedError("MoE GPT: not ported yet")

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @staticmethod
    def tiny() -> "GPTConfig":
        return GPTConfig(vocab_size=256, n_layers=2, d_model=64, n_heads=4,
                         d_ff=128, max_seq_len=128, remat=False)


def resolved_attention_impl(cfg: GPTConfig, device: DeviceLike) -> str:
    """The concrete attention ``cfg`` selects for tensors on ``device``:
    "auto" is the CUDA kernel for CUDA tensors and plain ``mha`` on the
    CPU, as the JAX package picks the Pallas kernel only on a TPU."""
    impl = "blockwise" if cfg.blockwise_attention else cfg.attention_impl
    if impl == "auto":
        return "flash" if torch.device(device).type == "cuda" else "mha"
    if impl not in ("mha", "blockwise", "flash"):
        raise ValueError(f"unknown attention_impl {impl!r}; "
                         f"expected auto|mha|blockwise|flash")
    return impl


def init(gen: torch.Generator, cfg: GPTConfig,
         device: DeviceLike = "cuda") -> Params:
    """Stacked-block GPT params drawn from ``gen`` (on the generator's
    device) and placed on ``device``."""
    dev = resolve_device(device)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype

    def stacked(shape, stddev=0.02):
        return trunc_normal(gen, (L, *shape), stddev=stddev, dtype=dt,
                            device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    out_std = 0.02 / (2 * L) ** 0.5
    params: Params = {
        "embed": embedding_init(gen, cfg.vocab_size, D, dtype=dt, device=dev),
        "blocks": {
            "ln1": {"scale": ones(L, D), "bias": zeros(L, D)},
            "attn_qkv": {"kernel": stacked((D, 3 * D)),
                         "bias": zeros(L, 3 * D)},
            "attn_out": {"kernel": stacked((D, D), stddev=out_std),
                         "bias": zeros(L, D)},
            "ln2": {"scale": ones(L, D), "bias": zeros(L, D)},
            "mlp_up": {"kernel": stacked((D, F)), "bias": zeros(L, F)},
            "mlp_down": {"kernel": stacked((F, D), stddev=out_std),
                         "bias": zeros(L, D)},
        },
        "final_norm": layernorm_init(D, dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, D, cfg.vocab_size, bias=False,
                                       dtype=dt, device=dev)
    return params


def _layer(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked blocks (views, no copies)."""
    return {name: {k: v[i] for k, v in sub.items()}
            for name, sub in params["blocks"].items()}


def _qkv(cfg: GPTConfig, bp: Params, x: torch.Tensor,
         positions: torch.Tensor):
    B, T, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    h = layernorm(bp["ln1"], x)
    qkv = dense(bp["attn_qkv"], h, compute_dtype=cfg.compute_dtype)
    q, k, v = torch.split(qkv, cfg.d_model, dim=-1)
    q = rotary_embedding(q.reshape(B, T, H, hd), positions)
    k = rotary_embedding(k.reshape(B, T, H, hd), positions)
    return q, k, v.reshape(B, T, H, hd)


def _finish_block(cfg: GPTConfig, bp: Params, x: torch.Tensor,
                  attn: torch.Tensor,
                  gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Output projection, residual, and the MLP half of the block; with
    ``gen``, dropout on both branches before their residual adds."""
    B, T, D = x.shape
    attn = dense(bp["attn_out"], attn.reshape(B, T, D),
                 compute_dtype=cfg.compute_dtype)
    x = x + dropout(attn, cfg.dropout, gen)
    h = layernorm(bp["ln2"], x)
    h = dense(bp["mlp_up"], h, compute_dtype=cfg.compute_dtype)
    h = gelu(h)
    h = dense(bp["mlp_down"], h, compute_dtype=cfg.compute_dtype)
    return x + dropout(h, cfg.dropout, gen)


def _block(cfg: GPTConfig, bp: Params, x: torch.Tensor,
           positions: torch.Tensor,
           dropout_seed: Optional[int] = None) -> torch.Tensor:
    """One pre-LN transformer block. x: [B, T, D] in compute dtype.
    Dropout is on when ``dropout_seed`` (this layer's) is given."""
    # Remat trap: torch.utils.checkpoint restores the global RNG state for
    # the recompute, never an explicit generator's. A generator carried
    # from block to block would draw other masks in the recompute and give
    # wrong gradients without an error. So the block seeds a fresh
    # generator from its layer's seed, and the recompute draws the same
    # masks.
    gen = None
    if dropout_seed is not None:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(dropout_seed)
    T = x.shape[1]
    q, k, v = _qkv(cfg, bp, x, positions)
    impl = resolved_attention_impl(cfg, x.device)
    blk = min(cfg.attention_block_size, 128)
    if impl == "mha":
        attn = mha(q, k, v, causal=True)
    elif impl == "blockwise":
        attn = causal_blockwise_attention(
            q, k, v, block_size=cfg.attention_block_size)
    elif x.device.type != "cpu":
        # the kernel masks ragged edges itself: any T, no padding (its
        # backward pads K/V for the recompute)
        attn = flash_attention_kernel(q, k, v, causal=True, block_k=blk)
    else:
        # the plain version keeps the JAX contract, which tiles T into
        # blk-sized blocks; pad an indivisible T and slice back. Safe
        # because attention is causal: real queries only ever see real
        # keys, padded rows are dropped.
        pad = -T % blk
        if pad:
            q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                       for t in (q, k, v))
        attn = flash_attention(q, k, v, causal=True, block_q=blk,
                               block_k=blk)
        if pad:
            attn = attn[:, :T]
    return _finish_block(cfg, bp, x, attn, gen)


def _logits(params: Params, cfg: GPTConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x.float() @ params["embed"]["table"].float().T
    return dense(params["lm_head"], x, compute_dtype=torch.float32)


_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _remat_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: the
    products without batch dimensions (the dense layers' ``mm``) are
    saved; everything else, batched attention products included, is
    recomputed in the backward. The flash Function is no aten op, so its
    kernel launches again in the recompute — as in the JAX program, where
    ``attn_out``'s weight gradient needs the attention output."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_remat_context = functools.partial(create_selective_checkpoint_contexts,
                                   _remat_policy)


def _forward(params: Params, cfg: GPTConfig, tokens: torch.Tensor, *,
             training: bool = False, dropout_seed: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward → (logits [B, T, V] fp32, aux scalar). tokens: int [B, T]
    on the parameters' device. ``aux`` is the MoE load-balancing loss,
    0 for this dense GPT.

    Dropout is on only when ``training``, ``dropout_seed`` is given and
    ``cfg.dropout > 0``; the per-layer seeds are derived before the loop,
    as the JAX package splits per-layer keys outside its scan. With
    ``cfg.remat`` and autograd recording, each block is checkpointed under
    :func:`_remat_policy`."""
    T = tokens.shape[1]
    positions = torch.arange(T, device=tokens.device)
    x = embedding(params["embed"], tokens, compute_dtype=cfg.compute_dtype)
    seeds = [None] * cfg.n_layers
    if training and dropout_seed is not None and cfg.dropout > 0.0:
        seeds = [fold_seed(dropout_seed, i) for i in range(cfg.n_layers)]
    remat = cfg.remat and torch.is_grad_enabled()
    for i, seed in enumerate(seeds):
        if remat:
            x = checkpoint(_block, cfg, _layer(params, i), x, positions,
                           seed, use_reentrant=False,
                           context_fn=_remat_context)
        else:
            x = _block(cfg, _layer(params, i), x, positions, seed)
    x = layernorm(params["final_norm"], x)
    logits = _logits(params, cfg, x).float()
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def apply(params: Params, cfg: GPTConfig, tokens: torch.Tensor, *,
          training: bool = False,
          dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Forward pass → logits [B, T, V] (fp32); see :func:`_forward`."""
    logits, _ = _forward(params, cfg, tokens, training=training,
                         dropout_seed=dropout_seed)
    return logits


def loss_fn(params: Params, cfg: GPTConfig, tokens: torch.Tensor,
            targets: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
            training: bool = False,
            dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Mean next-token cross-entropy (fp32). targets/mask: [B, T]."""
    logits, _ = _forward(params, cfg, tokens, training=training,
                         dropout_seed=dropout_seed)
    per_tok = softmax_cross_entropy(logits, targets)
    if mask is None:
        return per_tok.mean()
    maskf = mask.float()
    return (per_tok * maskf).sum() / maskf.sum().clamp_min(1.0)


def _block_paged(cfg: GPTConfig, bp: Params, x: torch.Tensor,
                 positions: torch.Tensor, k_pool_l: torch.Tensor,
                 v_pool_l: torch.Tensor, src_rows: torch.Tensor,
                 dst_slots: torch.Tensor, gather_idx: torch.Tensor,
                 attn_mask: torch.Tensor) -> torch.Tensor:
    """One pre-LN block on the paged-KV serving path.

    x: [B, T, D] new tokens only. k_pool_l/v_pool_l: [N, bs, H, hd], this
    layer's view of the pools, written IN PLACE: new-token rows
    ``src_rows`` of the flattened [B*T] K/V go to flat slots
    ``dst_slots`` (padding tokens were already dropped, as the JAX
    scatter's mode="drop" drops them). Attention then gathers the whole
    paged context through ``gather_idx`` ([B, S]) under ``attn_mask``
    ([B, 1, T, S]).
    """
    B, T, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    N, bs = k_pool_l.shape[0], k_pool_l.shape[1]
    q, k, v = _qkv(cfg, bp, x, positions)
    k_flat = k_pool_l.view(N * bs, H, hd)
    v_flat = v_pool_l.view(N * bs, H, hd)
    k_flat.index_copy_(0, dst_slots, k.reshape(B * T, H, hd)[src_rows])
    v_flat.index_copy_(0, dst_slots, v.reshape(B * T, H, hd)[src_rows])
    # slot j of the gathered context is sequence position j
    attn = mha(q, k_flat[gather_idx], v_flat[gather_idx], causal=False,
               mask=attn_mask)
    return _finish_block(cfg, bp, x, attn)


def _paged_backbone(params: Params, cfg: GPTConfig, tokens: torch.Tensor,
                    positions: torch.Tensor, token_mask: torch.Tensor,
                    k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """Embed → paged transformer stack → final layernorm; returns the
    normed hidden states [B, T, D] and updates the pools in place."""
    B, T = tokens.shape
    N, bs = k_pool.shape[1], k_pool.shape[2]
    S = block_tables.shape[1] * bs
    dev = tokens.device
    positions = positions.long()
    tables = block_tables.long()

    # scatter slots for the new tokens: pool block backing position p is
    # block_tables[b, p // bs]; padding tokens get the out-of-range slot
    # N*bs and are dropped, once for all layers
    blk = torch.gather(tables, 1, positions // bs)
    scatter_idx = torch.where(token_mask, blk * bs + positions % bs,
                              torch.full_like(blk, N * bs)).reshape(B * T)
    src_rows = torch.nonzero(scatter_idx < N * bs).squeeze(1)
    dst_slots = scatter_idx[src_rows]
    gather_idx = (tables[:, :, None] * bs
                  + torch.arange(bs, device=dev)[None, None, :]).reshape(B, S)
    # context slot j == sequence position j: causal = "j <= my position"
    attn_mask = ((torch.arange(S, device=dev)[None, None, :]
                  <= positions[:, :, None]) & token_mask[:, :, None])[:, None]

    x = embedding(params["embed"], tokens, compute_dtype=cfg.compute_dtype)
    for i in range(cfg.n_layers):
        x = _block_paged(cfg, _layer(params, i), x, positions, k_pool[i],
                         v_pool[i], src_rows, dst_slots, gather_idx,
                         attn_mask)
    return layernorm(params["final_norm"], x)


def forward_paged(params: Params, cfg: GPTConfig, tokens: torch.Tensor,
                  positions: torch.Tensor, token_mask: torch.Tensor,
                  last_index: torch.Tensor, k_pool: torch.Tensor,
                  v_pool: torch.Tensor, block_tables: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """KV-cache-aware forward for online serving (paged attention).

    One function for both halves of the prefill/decode split:

    - **prefill**: ``tokens`` is the bucket-padded prompt ([B, T]); every
      prompt token's K/V is written into the pool, and the logits returned
      are each row's *last real token*;
    - **decode**: ``T == 1``; one new token per running sequence is
      appended to the pool and attends to its whole paged context.

    Args:
      tokens:     int [B, T] new token ids.
      positions:  int [B, T] absolute sequence positions of ``tokens``.
      token_mask: bool [B, T]; False marks padding, which is neither
                  written to the pool nor attended to.
      last_index: int [B], index into T of each row's last real token.
      k_pool/v_pool: [L, N, block, H, hd] paged pools, updated IN PLACE
                  (where the JAX engine donates them to the jitted call).
      block_tables: int [B, W] pool block ids per sequence; entry w backs
                  positions [w*block, (w+1)*block).

    Returns ``(logits [B, V] fp32, k_pool, v_pool)``, the pools being the
    same tensors that were passed in. Same dtypes as :func:`apply`, so a
    greedy decode through this path matches re-running the uncached
    forward each step.
    """
    x = _paged_backbone(params, cfg, tokens, positions, token_mask, k_pool,
                        v_pool, block_tables)
    h_last = x[torch.arange(x.shape[0], device=x.device), last_index.long()]
    return _logits(params, cfg, h_last).float(), k_pool, v_pool


def param_count(params: Params) -> int:
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        else:
            yield t
    return sum(int(x.numel()) for x in leaves(params))
