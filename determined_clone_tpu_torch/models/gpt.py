"""GPT — the port of ``determined_clone_tpu/models/gpt.py``.

Parameters are a plain dict with the JAX package's stacked-block layout
(``blocks/<name>/<leaf>`` carry a leading ``[L]`` layer dimension), so
``convert.params_from_numpy`` maps the JAX tree one leaf to one leaf. A
Python loop over the layers takes the place of ``lax.scan``.

Covered: the uncached forward (``apply``, through the CUDA
flash-attention kernel on the card), training (``loss_fn`` with dropout
and remat per block; the flash backward recomputes through the blockwise
attention), the paged prefill/decode forward the serving engine runs
(``forward_paged``) and its all-position form for the speculative verify
(``forward_paged_logits``), and the identity-layer helpers that build a
speculative testbed (``extend_with_identity_layers``,
``slice_prefix_layers``). The paged forward has fixed shapes and no host
sync, so the engine can capture it in a CUDA graph. ``moe_experts > 0``
replaces each block's MLP by the routed expert FFN (``ops/moe.py``), in
training and in the paged forward, whose capacity comes from that call's
``B·T`` (padding rows included), as in the JAX package.

Over a mesh: when the parameters are DTensors placed by
``GPT_SHARDING_RULES`` (``parallel/sharding.py``) and the batch is a
DTensor split over ``dp`` × ``fsdp``, ``loss_fn`` runs each rank's share
of the JAX program (``parallel/spmd.py``): weights sharded over ``fsdp``
are all-gathered per layer (FSDP); ``tp`` splits the heads (the flash
kernel runs on the rank's own heads), the MLP width and the vocabulary
(a vocab-parallel embedding and cross-entropy, whose logsumexp spans
``tp``); ``ep`` splits the experts; the loss is the global batch's.
Over ``pp`` with the blocks placed by ``GPT_PP_SHARDING_RULES``, or
with ``pipeline_microbatches`` above 1 (blocks not split over ``pp`` are
then cut to each stage's layers, as the JAX program reshards them), the
stack runs as a GPipe pipeline (``parallel/pipeline.py``): each rank
runs its stage's layers on ``pipeline_microbatches`` microbatches of its
rows. Over ``sp`` each rank takes its block of the sequence (the tokens
may come split by ``TOKENS_SPEC`` or whole), with global rotary
positions, and attends through ``ring_attention``; the loss's token mean
spans ``sp``, and the MoE routes the global token array
(``ops/moe.py``).
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
    ring_attention,
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
from determined_clone_tpu_torch.ops.moe import moe_ffn
from determined_clone_tpu_torch.parallel.pipeline import pipeline_apply
from determined_clone_tpu_torch.parallel.sharding import (
    P,
    ShardingRules,
    placements_for,
)
from determined_clone_tpu_torch.parallel.spmd import (
    BATCH_AXES,
    SpmdContext,
    local_rows,
    split_over,
    spmd_of,
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


# Megatron-style TP rules + explicit fsdp specs, the JAX package's.
# Column-parallel up-projections shard the output dim on tp; row-parallel
# down-projections shard the input dim. Stacked block leaves have a leading
# [L] layer dim; with ``pipelined=True`` that dim is sliced over pp.
def sharding_rules(pipelined: bool = False) -> ShardingRules:
    lead = "pp" if pipelined else None
    return ShardingRules(rules=[
        (r"embed/table$",            P("tp", "fsdp")),       # [V, D] vocab-parallel
        (r"blocks/.*attn_qkv/kernel$",  P(lead, "fsdp", "tp")),  # [L, D, 3D] column
        (r"blocks/.*attn_out/kernel$",  P(lead, "tp", "fsdp")),  # [L, D, D]  row
        (r"blocks/.*mlp_up/kernel$",    P(lead, "fsdp", "tp")),  # [L, D, F]  column
        (r"blocks/.*mlp_down/kernel$",  P(lead, "tp", "fsdp")),  # [L, F, D]  row
        (r"blocks/moe/router/kernel$",  P(lead)),               # [L, D, E] small
        (r"blocks/moe/up/kernel$",      P(lead, "ep", "fsdp", "tp")),   # [L,E,D,F]
        (r"blocks/moe/down/kernel$",    P(lead, "ep", "tp", "fsdp")),   # [L,E,F,D]
        (r"blocks/moe/.*bias$",         P(lead, "ep")),         # [L, E, ·]
        (r"blocks/.*(bias|scale)$",     P(lead)),
        (r"lm_head/kernel$",         P("fsdp", "tp")),       # [D, V]
        (r"final_norm/",             P()),
    ])


GPT_SHARDING_RULES = sharding_rules(pipelined=False)
GPT_PP_SHARDING_RULES = sharding_rules(pipelined=True)

# Activation specs: batch over (dp, fsdp), sequence over sp, heads/features over tp.
TOKENS_SPEC = P(("dp", "fsdp"), "sp")
ACTIVATION_SPEC = P(("dp", "fsdp"), "sp", "tp")


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
    embed = embedding_init(gen, cfg.vocab_size, D, dtype=dt, device=dev)
    blocks: Params = {
        "ln1": {"scale": ones(L, D), "bias": zeros(L, D)},
        "attn_qkv": {"kernel": stacked((D, 3 * D)), "bias": zeros(L, 3 * D)},
        "attn_out": {"kernel": stacked((D, D), stddev=out_std),
                     "bias": zeros(L, D)},
        "ln2": {"scale": ones(L, D), "bias": zeros(L, D)},
    }
    if cfg.moe_experts > 0:
        E = cfg.moe_experts
        blocks["moe"] = {
            "router": {"kernel": stacked((D, E))},
            "up": {"kernel": stacked((E, D, F)), "bias": zeros(L, E, F)},
            "down": {"kernel": stacked((E, F, D), stddev=out_std),
                     "bias": zeros(L, E, D)},
        }
    else:
        blocks["mlp_up"] = {"kernel": stacked((D, F)), "bias": zeros(L, F)}
        blocks["mlp_down"] = {"kernel": stacked((F, D), stddev=out_std),
                              "bias": zeros(L, D)}
    params: Params = {"embed": embed, "blocks": blocks,
                      "final_norm": layernorm_init(D, dtype=dt, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, D, cfg.vocab_size, bias=False,
                                       dtype=dt, device=dev)
    return params


def _stacked(blocks: Params, pick) -> Params:
    """The stacked blocks with ``pick`` applied to every leaf."""
    return {k: _stacked(v, pick) if isinstance(v, dict) else pick(v)
            for k, v in blocks.items()}


def _layer(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked blocks (views, no copies)."""
    return _stacked(params["blocks"], lambda v: v[i])


def _layer_local(sp: SpmdContext, cfg: GPTConfig, params: Params,
                 i: int) -> Params:
    """Layer ``i``'s weights as this rank computes with them: gathered
    over every axis but ``tp`` and ``ep``; this rank's heads of the fused
    q|k|v projection, its block of the MLP width (or of the experts and
    their width) and its rows of the row-parallel projections."""
    b = params["blocks"]

    def leaf(name, key, **kw):
        return sp.local(b[name][key], index=i, **kw)

    def heads(t):  # [..., 3D] -> this rank's heads of q, k and v
        return sp.qkv_heads(t, cfg.n_heads, cfg.head_dim)

    out: Params = {
        "ln1": {k: leaf("ln1", k) for k in b["ln1"]},
        "ln2": {k: leaf("ln2", k) for k in b["ln2"]},
        "attn_qkv": {"kernel": heads(leaf("attn_qkv", "kernel", split=("tp",))),
                     "bias": heads(leaf("attn_qkv", "bias", split=("tp",)))},
        "attn_out": {"kernel": leaf("attn_out", "kernel", keep={"tp": 0}),
                     "bias": leaf("attn_out", "bias")},
    }
    if cfg.moe_experts > 0:
        m = b["moe"]

        def moe(name, key, **kw):
            return sp.local(m[name][key], index=i, **kw)

        out["moe"] = {
            "router": {"kernel": moe("router", "kernel")},
            "up": {"kernel": moe("up", "kernel", keep={"ep": 0, "tp": 2}),
                   "bias": moe("up", "bias", keep={"ep": 0, "tp": 1})},
            "down": {"kernel": moe("down", "kernel", keep={"ep": 0, "tp": 1}),
                     "bias": moe("down", "bias", keep={"ep": 0})},
        }
    else:
        out["mlp_up"] = {"kernel": leaf("mlp_up", "kernel", keep={"tp": 1}),
                         "bias": leaf("mlp_up", "bias", keep={"tp": 0})}
        out["mlp_down"] = {"kernel": leaf("mlp_down", "kernel", keep={"tp": 0}),
                           "bias": leaf("mlp_down", "bias")}
    return out


def _dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator],
             sp: Optional[SpmdContext]) -> torch.Tensor:
    """Dropout whose mask is drawn at the global batch shape and cut to
    this rank's rows (and sequence block), so a mesh run draws the
    one-rank run's masks."""
    if sp is None or sp.batch_shards * sp.sp == 1:
        return dropout(x, rate, gen)
    B, T = x.shape[:2]
    return dropout(x, rate, gen,
                   rows=(sp.batch_index * B, sp.batch_shards * B),
                   seq=(sp.sp_rank * T, sp.sp * T))


def _qkv(cfg: GPTConfig, bp: Params, x: torch.Tensor,
         positions: torch.Tensor, sp: Optional[SpmdContext] = None):
    B, T, _ = x.shape
    hd = cfg.head_dim
    h = layernorm(bp["ln1"], x)
    if sp is not None:
        h = sp.copy_to(h, "tp")
    qkv = dense(bp["attn_qkv"], h, compute_dtype=cfg.compute_dtype)
    H = qkv.shape[-1] // (3 * hd)   # this rank's heads
    q, k, v = torch.split(qkv, H * hd, dim=-1)
    q = rotary_embedding(q.reshape(B, T, H, hd), positions)
    k = rotary_embedding(k.reshape(B, T, H, hd), positions)
    return q, k, v.reshape(B, T, H, hd)


def _row(p: Params, x: torch.Tensor, cd, sp: Optional[SpmdContext]
         ) -> torch.Tensor:
    """A row-parallel dense layer: the product of this rank's rows,
    summed across ``tp``, then the bias."""
    if sp is None:
        return dense(p, x, compute_dtype=cd)
    y = sp.reduce_from(x.to(cd) @ p["kernel"].to(cd), "tp")
    return y + p["bias"].to(y.dtype)


def _mlp(cfg: GPTConfig, bp: Params, h: torch.Tensor,
         sp: Optional[SpmdContext]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN half: the dense MLP or the routed experts → (h, aux)."""
    cd = cfg.compute_dtype
    if cfg.moe_experts > 0:
        return moe_ffn(bp["moe"], h, k=cfg.moe_k,
                       capacity_factor=cfg.moe_capacity_factor,
                       compute_dtype=cd, comm=sp)
    if sp is not None:
        h = sp.copy_to(h, "tp")
    h = gelu(dense(bp["mlp_up"], h, compute_dtype=cd))
    return (_row(bp["mlp_down"], h, cd, sp),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _finish_block(cfg: GPTConfig, bp: Params, x: torch.Tensor,
                  attn: torch.Tensor,
                  gen: Optional[torch.Generator] = None,
                  sp: Optional[SpmdContext] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Output projection, residual, and the MLP half of the block; with
    ``gen``, dropout on both branches before their residual adds.
    Returns (x, aux), aux the MoE load-balancing loss (0 when dense)."""
    B, T, _ = x.shape
    attn = _row(bp["attn_out"], attn.reshape(B, T, -1), cfg.compute_dtype,
                sp)
    x = x + _dropout(attn, cfg.dropout, gen, sp)
    h, aux = _mlp(cfg, bp, layernorm(bp["ln2"], x), sp)
    return x + _dropout(h, cfg.dropout, gen, sp), aux


def _block(cfg: GPTConfig, bp: Params, x: torch.Tensor,
           positions: torch.Tensor,
           dropout_seed: Optional[int] = None,
           sp: Optional[SpmdContext] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-LN transformer block. x: [B, T, D] in compute dtype.
    Dropout is on when ``dropout_seed`` (this layer's) is given. Returns
    (x, aux)."""
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
    q, k, v = _qkv(cfg, bp, x, positions, sp)
    impl = resolved_attention_impl(cfg, x.device)
    blk = min(cfg.attention_block_size, 128)
    if sp is not None and sp.sp > 1:
        attn = ring_attention(q, k, v, axis_name="sp", mesh=sp.mesh)
    elif impl == "mha":
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
    return _finish_block(cfg, bp, x, attn, gen, sp)


def _block_at(cfg: GPTConfig, params: Params, i: int, x: torch.Tensor,
              positions: torch.Tensor, dropout_seed: Optional[int],
              sp: Optional[SpmdContext]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block ``i``. Over a mesh its weights are gathered here, inside the
    remat region, so the backward gathers them again (FSDP) instead of
    keeping every layer's gathered weights."""
    bp = _layer(params, i) if sp is None else _layer_local(sp, cfg, params, i)
    return _block(cfg, bp, x, positions, dropout_seed, sp)


def _run_block(cfg: GPTConfig, params: Params, i: int, x: torch.Tensor,
               positions: torch.Tensor, seed: Optional[int],
               sp: Optional[SpmdContext], remat: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block ``i``, checkpointed under :func:`_remat_policy` when
    ``remat``."""
    if remat:
        return checkpoint(_block_at, cfg, params, i, x, positions, seed, sp,
                          use_reentrant=False, context_fn=_remat_context)
    return _block_at(cfg, params, i, x, positions, seed, sp)


def _pipelined(params: Params, cfg: GPTConfig, x: torch.Tensor,
               positions: torch.Tensor, seeds: list,
               sp: SpmdContext, remat: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block stack as a GPipe pipeline over ``pp``: this rank runs its
    stage's layers on each of ``pipeline_microbatches`` microbatches of
    its rows. The carrier is ``{"x": [B, T, D], "aux": [B]}``, each
    layer's MoE aux spread over the microbatch's rows (summing recovers
    it); the total is the mean over microbatches. Each layer's dropout
    seed is shared by every microbatch, as in the JAX package."""
    M = max(cfg.pipeline_microbatches, 1)
    n_local = cfg.n_layers // sp.pp
    first = sp.pp_rank * n_local

    def stage_fn(blocks, carrier):
        h, aux = carrier["x"], carrier["aux"]
        stage = {"blocks": blocks}
        for j in range(n_local):
            h, a = _run_block(cfg, stage, j, h, positions, seeds[first + j],
                              sp, remat)
            aux = aux + a / h.shape[0]
        return {"x": h, "aux": aux}

    carrier = {"x": x, "aux": torch.zeros(x.shape[0], dtype=torch.float32,
                                          device=x.device)}
    out = pipeline_apply(stage_fn, params["blocks"], carrier, mesh=sp.mesh,
                         num_microbatches=M)
    return out["x"], out["aux"].sum() / M


def _seq_block(t: Optional[torch.Tensor], sp: Optional[SpmdContext]
               ) -> Optional[torch.Tensor]:
    """This rank's rows of a batch tensor [B, T] and, over ``sp``, its
    block of the sequence: a tensor split over ``sp`` (``TOKENS_SPEC``)
    is that block already; a whole one is cut to it."""
    if t is None:
        return None
    split = split_over(t, "sp", 1)
    t = local_rows(t)
    if sp is None or sp.sp == 1 or split:
        return t
    T = t.shape[1]
    if T % sp.sp:
        raise ValueError(f"sequence length {T} does not divide over the "
                         f"'sp' axis of size {sp.sp}")
    n = T // sp.sp
    return t[:, sp.sp_rank * n:(sp.sp_rank + 1) * n]


def _embed(params: Params, cfg: GPTConfig, tokens: torch.Tensor,
           sp: Optional[SpmdContext]) -> torch.Tensor:
    """Token embeddings in the compute dtype; over ``tp`` each rank looks
    up the ids of its vocabulary block and the blocks are summed."""
    if sp is None:
        return embedding(params["embed"], tokens,
                         compute_dtype=cfg.compute_dtype)
    table = sp.local(params["embed"]["table"], keep={"tp": 0})
    if sp.tp == 1:
        return table[tokens].to(cfg.compute_dtype)
    Vl = table.shape[0]
    ids = tokens.long() - sp.tp_rank * Vl
    inside = (ids >= 0) & (ids < Vl)
    x = table[ids.clamp(0, Vl - 1)] * inside[..., None]
    return sp.reduce_from(x, "tp").to(cfg.compute_dtype)


def _logits(params: Params, cfg: GPTConfig, x: torch.Tensor,
            sp: Optional[SpmdContext] = None) -> torch.Tensor:
    """Logits in fp32; over ``tp``, this rank's block of the vocabulary."""
    if sp is None:
        if cfg.tie_embeddings:
            return x.float() @ params["embed"]["table"].float().T
        return dense(params["lm_head"], x, compute_dtype=torch.float32)
    x = sp.copy_to(x.float(), "tp")
    if cfg.tie_embeddings:
        table = sp.local(params["embed"]["table"], keep={"tp": 0})
        return x @ table.float().T
    return x @ sp.local(params["lm_head"]["kernel"], keep={"tp": 1}).float()


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
    on the parameters' device. ``aux`` is the MoE load-balancing loss
    summed over the layers, 0 for the dense GPT. Over a mesh (DTensor
    parameters) the logits are this rank's rows and vocabulary block.

    Dropout is on only when ``training``, ``dropout_seed`` is given and
    ``cfg.dropout > 0``; the per-layer seeds are derived before the loop,
    as the JAX package splits per-layer keys outside its scan. With
    ``cfg.remat`` and autograd recording, each block is checkpointed under
    :func:`_remat_policy`."""
    sp = spmd_of(params["embed"]["table"])
    tokens = _seq_block(tokens, sp)
    T = tokens.shape[1]
    first = 0 if sp is None else sp.sp_rank * T   # global positions
    positions = torch.arange(first, first + T, device=tokens.device)
    x = _embed(params, cfg, tokens, sp)
    seeds = [None] * cfg.n_layers
    if training and dropout_seed is not None and cfg.dropout > 0.0:
        seeds = [fold_seed(dropout_seed, i) for i in range(cfg.n_layers)]
    remat = cfg.remat and torch.is_grad_enabled()
    if split_over(params["blocks"]["ln1"]["scale"], "pp", 0) or (
            sp is not None and sp.pp > 1 and cfg.pipeline_microbatches > 1):
        # blocks not split over pp are cut to the stage's layers there
        x, aux_total = _pipelined(params, cfg, x, positions, seeds, sp,
                                  remat)
    else:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, seed in enumerate(seeds):
            x, aux = _run_block(cfg, params, i, x, positions, seed, sp,
                                remat)
            aux_total = aux_total + aux
    norm = params["final_norm"]
    if sp is not None:
        norm = {k: sp.local(v) for k, v in norm.items()}
    x = layernorm(norm, x)
    return _logits(params, cfg, x, sp).float(), aux_total


def apply(params: Params, cfg: GPTConfig, tokens: torch.Tensor, *,
          training: bool = False,
          dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Forward pass → logits [B, T, V] (fp32); see :func:`_forward`. Over
    a mesh, a DTensor split over the batch axes."""
    logits, _ = _forward(params, cfg, tokens, training=training,
                         dropout_seed=dropout_seed)
    sp = spmd_of(params["embed"]["table"])
    if sp is None:
        return logits
    from torch.distributed.tensor import DTensor

    logits = sp.gather_replicated(logits, logits.dim() - 1, "tp")
    B, T, V = logits.shape
    B, T = B * sp.batch_shards, T * sp.sp
    return DTensor.from_local(
        logits, sp.mesh, placements_for(P(BATCH_AXES, "sp"), sp.mesh),
        run_check=False, shape=(B, T, V), stride=(T * V, V, 1))


def loss_fn(params: Params, cfg: GPTConfig, tokens: torch.Tensor,
            targets: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
            training: bool = False,
            dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Mean next-token cross-entropy (fp32), plus ``moe_aux_weight`` times
    the MoE aux loss. targets/mask: [B, T], shifted on the whole sequence
    (before any split over ``sp``). Over a mesh the mean is the global
    batch's, the same value on every rank, and each rank's backward
    yields its own rows' (and tokens') share of the gradients."""
    logits, aux = _forward(params, cfg, tokens, training=training,
                           dropout_seed=dropout_seed)
    sp = spmd_of(params["embed"]["table"])
    targets = _seq_block(targets, sp)
    per_tok = (softmax_cross_entropy(logits, targets) if sp is None
               else sp.cross_entropy(logits, targets))
    if sp is None:
        if mask is None:
            ce = per_tok.mean()
        else:
            maskf = mask.float()
            ce = (per_tok * maskf).sum() / maskf.sum().clamp_min(1.0)
    elif mask is None:
        # the blocks are equal: the global mean is the mean of the means
        ce = sp.reduce_from(per_tok.mean() / (sp.batch_shards * sp.sp),
                            *BATCH_AXES, "sp")
    else:
        maskf = _seq_block(mask, sp).float()
        count = sp.sum_(maskf.sum(), *BATCH_AXES, "sp").clamp_min(1.0)
        ce = sp.reduce_from((per_tok * maskf).sum() / count,
                            *BATCH_AXES, "sp")
    if cfg.moe_experts > 0:
        ce = ce + cfg.moe_aux_weight * aux
    return ce


def _check_scratch(pool: torch.Tensor) -> None:
    """Refuse a pool [L, N, bs, H, hd] that is not a view of the
    ``[L, N + 1, bs, H, hd]`` allocation ``init_kv_pools`` makes: every
    layer needs the scratch block behind its N blocks, and a plain pool's
    "scratch" would be the next layer's block 0. Checked once for the
    whole pool, before the first write."""
    L, N, bs, H, hd = pool.shape
    block = bs * H * hd
    layout = ((N + 1) * block, block, H * hd, hd, 1)
    need = (pool.storage_offset() + L * (N + 1) * block) * pool.element_size()
    if pool.stride() != layout or pool.untyped_storage().nbytes() < need:
        raise ValueError("paged KV pools must come from "
                         "serving.kv_cache.init_kv_pools (each layer needs "
                         "its scratch block)")


def _with_scratch(pool_l: torch.Tensor) -> torch.Tensor:
    """This layer's pool [N, bs, H, hd] (of a pool that passed
    :func:`_check_scratch`) as flat slots [(N + 1) * bs, H, hd]: the
    N*bs real slots, then the hidden scratch block where masked tokens'
    K/V land, so the scatter has a fixed shape."""
    N, bs, H, hd = pool_l.shape
    return pool_l.as_strided(((N + 1) * bs, H, hd), (H * hd, hd, 1))


def _block_paged(cfg: GPTConfig, bp: Params, x: torch.Tensor,
                 positions: torch.Tensor, k_pool_l: torch.Tensor,
                 v_pool_l: torch.Tensor, scatter_idx: torch.Tensor,
                 gather_idx: torch.Tensor,
                 attn_mask: torch.Tensor) -> torch.Tensor:
    """One pre-LN block on the paged-KV serving path.

    x: [B, T, D] new tokens only. k_pool_l/v_pool_l: [N, bs, H, hd], this
    layer's view of the pools, written IN PLACE: the flattened [B*T]
    new K/V go to flat slots ``scatter_idx``, where masked tokens point at
    the scratch block (the JAX scatter's mode="drop" drops them). Two
    sequences never share a written block, so real slots are
    collision-free. Attention then gathers the whole paged context
    through ``gather_idx`` ([B, S]) under ``attn_mask`` ([B, 1, T, S]).
    """
    B, T, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(cfg, bp, x, positions)
    k_flat = _with_scratch(k_pool_l)
    v_flat = _with_scratch(v_pool_l)
    k_flat.index_copy_(0, scatter_idx, k.reshape(B * T, H, hd))
    v_flat.index_copy_(0, scatter_idx, v.reshape(B * T, H, hd))
    # slot j of the gathered context is sequence position j
    attn = mha(q, k_flat[gather_idx], v_flat[gather_idx], causal=False,
               mask=attn_mask)
    return _finish_block(cfg, bp, x, attn)[0]


def _paged_backbone(params: Params, cfg: GPTConfig, tokens: torch.Tensor,
                    positions: torch.Tensor, token_mask: torch.Tensor,
                    k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """Embed → paged transformer stack → final layernorm; returns the
    normed hidden states [B, T, D] and updates the pools in place. Every
    shape here follows the arguments' shapes alone, and nothing reads a
    value back to the host."""
    B, T = tokens.shape
    N, bs = k_pool.shape[1], k_pool.shape[2]
    W = block_tables.shape[1]
    S = W * bs
    dev = tokens.device
    positions = positions.long()
    tables = block_tables.long()
    _check_scratch(k_pool)
    _check_scratch(v_pool)

    # scatter slots for the new tokens: pool block backing position p is
    # block_tables[b, p // bs]; masked tokens go to the scratch slot N*bs
    # (their positions may run past the table: clamp the lookup)
    blk = torch.gather(tables, 1, (positions // bs).clamp(max=W - 1))
    scatter_idx = torch.where(token_mask, blk * bs + positions % bs,
                              torch.full_like(blk, N * bs)).reshape(B * T)
    gather_idx = (tables[:, :, None] * bs
                  + torch.arange(bs, device=dev)[None, None, :]).reshape(B, S)
    # context slot j == sequence position j: causal = "j <= my position"
    attn_mask = ((torch.arange(S, device=dev)[None, None, :]
                  <= positions[:, :, None]) & token_mask[:, :, None])[:, None]

    x = embedding(params["embed"], tokens, compute_dtype=cfg.compute_dtype)
    for i in range(cfg.n_layers):
        x = _block_paged(cfg, _layer(params, i), x, positions, k_pool[i],
                         v_pool[i], scatter_idx, gather_idx, attn_mask)
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
      k_pool/v_pool: [L, N, block, H, hd] paged pools from
                  ``init_kv_pools``, updated IN PLACE (where the JAX
                  engine donates them to the jitted call).
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


def forward_paged_logits(params: Params, cfg: GPTConfig,
                         tokens: torch.Tensor, positions: torch.Tensor,
                         token_mask: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_tables: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-token paged forward returning logits at *every* position:
    the speculative verify step, where the target scores ``[last
    committed token, draft_1 .. draft_k]`` in one call (``T == k + 1``).

    Same arguments as :func:`forward_paged` minus ``last_index``; returns
    ``(logits [B, T, V] fp32, k_pool, v_pool)``. K/V for all masked-in
    tokens are written to the pool — rejected drafts leave stale entries
    past the accepted frontier, which is safe: attention masks slots
    beyond the query's own position, and the next iteration's scatter
    overwrites them before they ever become visible.
    """
    x = _paged_backbone(params, cfg, tokens, positions, token_mask, k_pool,
                        v_pool, block_tables)
    return _logits(params, cfg, x).float(), k_pool, v_pool


def extend_with_identity_layers(params: Params, cfg: GPTConfig,
                                extra_layers: int
                                ) -> Tuple[Params, GPTConfig]:
    """Append ``extra_layers`` exact-identity residual blocks.

    A pre-LN block whose ``attn_out`` and ``mlp_down`` projections
    (kernel AND bias) are zero adds exactly zero to the residual stream:
    the extended model's logits equal the original's, while every call
    pays the deeper model's weight traffic and op count. The pair
    (original, extended) is then a speculative-decoding testbed whose
    draft is perfectly distilled: greedy acceptance is exactly 1.0.
    Returns ``(params, cfg)`` for the deepened model; the new layers copy
    layer 0's other weights.
    """
    if extra_layers <= 0:
        return params, cfg
    if cfg.moe_experts > 0:
        raise ValueError("identity extension supports dense blocks only")
    zero_adds = ("attn_out", "mlp_down")

    def pad(name: str, leaf: torch.Tensor) -> torch.Tensor:
        tile = leaf[:1].expand(extra_layers, *leaf.shape[1:])
        if name in zero_adds:
            tile = torch.zeros_like(tile)
        return torch.cat([leaf, tile], dim=0)

    out = dict(params)
    out["blocks"] = {name: {k: pad(name, v) for k, v in sub.items()}
                     for name, sub in params["blocks"].items()}
    return out, dataclasses.replace(cfg, n_layers=cfg.n_layers + extra_layers)


def slice_prefix_layers(params: Params, cfg: GPTConfig, n_layers: int
                        ) -> Tuple[Params, GPTConfig]:
    """Keep only the first ``n_layers`` stacked blocks (embedding, final
    norm and head shared, as views) — the draft half of the identity
    testbed, and a layer-sliced draft of any stacked-block model.
    Returns ``(params, cfg)``."""
    if not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"n_layers must be in [1, {cfg.n_layers}], "
                         f"got {n_layers}")
    out = dict(params)
    out["blocks"] = _stacked(params["blocks"], lambda v: v[:n_layers])
    return out, dataclasses.replace(cfg, n_layers=n_layers)


def param_count(params: Params) -> int:
    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                yield from leaves(v)
        else:
            yield t
    return sum(int(x.numel()) for x in leaves(params))
