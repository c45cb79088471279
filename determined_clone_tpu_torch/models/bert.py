"""BERT — the port of ``determined_clone_tpu/models/bert.py``:
bidirectional encoder for masked-LM pretraining and fine-tuning
(BASELINE config #4 fine-tunes it through the Core API).

Same construction as the JAX model: stacked-block params (``[L, ...]``
leading dim) walked by a loop in place of ``lax.scan``, products in
``compute_dtype`` (params fp32), bidirectional ``mha`` with padded *keys*
pushed to ``NEG_INF``, learned position and segment embeddings, the MLM
projection tied to the token embedding, and a [CLS] pooler and head for
fine-tunes.

Over a mesh: with the parameters DTensors placed by
``BERT_SHARDING_RULES`` (the JAX package's Megatron + fsdp layout) and
the batch DTensors split over ``dp`` × ``fsdp``, each rank runs its share
of the JAX program (``parallel/spmd.py``), as the GPT does: weights
sharded over ``fsdp`` all-gathered per layer; ``tp`` splits the heads,
the FFN width and the vocabulary (a vocab-parallel embedding, and the
tied MLM head contracting over the same table block, whose
cross-entropy's logsumexp spans ``tp``); outputs and losses are the
global batch's.

One departure, in bf16 only: the blocks multiply their output by the pad
mask *in the activations' dtype*. The JAX block multiplies by the fp32
mask, which promotes a bf16 carry to fp32, and ``lax.scan`` refuses the
change of carry type — the JAX model runs in fp32 only. The mask is 0 or
1, so the product is exact either way and fp32 results are the same.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.ops.attention import mha
from determined_clone_tpu_torch.ops.layers import (
    dense,
    dense_init,
    embedding_init,
    gelu,
    layernorm,
    layernorm_init,
    softmax_cross_entropy,
    trunc_normal,
)
from determined_clone_tpu_torch.parallel.sharding import (
    P,
    ShardingRules,
    batch_spec,
    placements_for,
)
from determined_clone_tpu_torch.parallel.spmd import (
    SpmdContext,
    local_rows,
    spmd_of,
)
from determined_clone_tpu_torch.training.optim import leaves

Params = Dict[str, Any]

# Megatron-style TP + fsdp layout, the JAX package's, mirroring the GPT's
# rules: column-parallel up-projections shard the output dim on tp and
# row-parallel down-projections the input dim; the embedding is
# vocab-parallel and the tied MLM projection contracts over the same
# sharded table.
BERT_SHARDING_RULES = ShardingRules(rules=[
    (r"embed/table$",              P("tp", "fsdp")),        # [V, D]
    (r"blocks/attn_qkv/kernel$",   P(None, "fsdp", "tp")),  # [L, D, 3D] col
    (r"blocks/attn_out/kernel$",   P(None, "tp", "fsdp")),  # [L, D, D]  row
    (r"blocks/mlp_up/kernel$",     P(None, "fsdp", "tp")),  # [L, D, F]  col
    (r"blocks/mlp_down/kernel$",   P(None, "tp", "fsdp")),  # [L, F, D]  row
    (r"blocks/.*(bias|scale)$",    P(None)),
    (r"(pos_embed|seg_embed|embed_norm/|mlm_bias)", P()),
    (r"(pooler|cls_head)/",        P()),                    # small heads
])


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522      # bert-base wordpiece vocab
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    n_segments: int = 2
    n_classes: int = 2           # fine-tune head (e.g. GLUE pair tasks)
    compute_dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @staticmethod
    def tiny() -> "BertConfig":
        return BertConfig(vocab_size=256, n_layers=2, d_model=64, n_heads=4,
                          d_ff=128, max_seq_len=64, n_classes=2,
                          compute_dtype=torch.float32, remat=False)


def init(gen: torch.Generator, cfg: BertConfig,
         device: DeviceLike = "cuda") -> Params:
    dev = resolve_device(device)
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype
    out_std = 0.02 / (2 * L) ** 0.5

    def normal(shape, stddev=0.02):
        return trunc_normal(gen, shape, stddev=stddev, dtype=dt, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    blocks: Params = {
        "ln1": {"scale": ones(L, D), "bias": zeros(L, D)},
        "attn_qkv": {"kernel": normal((L, D, 3 * D)),
                     "bias": zeros(L, 3 * D)},
        "attn_out": {"kernel": normal((L, D, D), out_std),
                     "bias": zeros(L, D)},
        "ln2": {"scale": ones(L, D), "bias": zeros(L, D)},
        "mlp_up": {"kernel": normal((L, D, F)), "bias": zeros(L, F)},
        "mlp_down": {"kernel": normal((L, F, D), out_std),
                     "bias": zeros(L, D)},
    }
    return {
        "embed": embedding_init(gen, cfg.vocab_size, D, dtype=dt, device=dev),
        "pos_embed": normal((cfg.max_seq_len, D)),
        "seg_embed": normal((cfg.n_segments, D)),
        "embed_norm": layernorm_init(D, dtype=dt, device=dev),
        "blocks": blocks,
        "pooler": dense_init(gen, D, D, dtype=dt, device=dev),
        "cls_head": dense_init(gen, D, cfg.n_classes, dtype=dt, device=dev),
        # MLM output bias (the projection is tied to the embedding table)
        "mlm_bias": zeros(cfg.vocab_size),
    }


def _layer_local(sp: SpmdContext, cfg: BertConfig, blocks: Params,
                 i: int) -> Params:
    """Layer ``i``'s weights as this rank computes with them: gathered
    over every axis but ``tp``; its heads of the fused q|k|v projection,
    its block of the FFN width and its rows of the row-parallel
    projections."""

    def leaf(name, key, **kw):
        return sp.local(blocks[name][key], index=i, **kw)

    def heads(t):  # [..., 3D] -> this rank's heads of q, k and v
        return sp.qkv_heads(t, cfg.n_heads, cfg.head_dim)

    return {
        "ln1": {k: leaf("ln1", k) for k in blocks["ln1"]},
        "ln2": {k: leaf("ln2", k) for k in blocks["ln2"]},
        "attn_qkv": {"kernel": heads(leaf("attn_qkv", "kernel",
                                          split=("tp",))),
                     "bias": heads(leaf("attn_qkv", "bias", split=("tp",)))},
        "attn_out": {"kernel": leaf("attn_out", "kernel", keep={"tp": 0}),
                     "bias": leaf("attn_out", "bias")},
        "mlp_up": {"kernel": leaf("mlp_up", "kernel", keep={"tp": 1}),
                   "bias": leaf("mlp_up", "bias", keep={"tp": 0})},
        "mlp_down": {"kernel": leaf("mlp_down", "kernel", keep={"tp": 0}),
                     "bias": leaf("mlp_down", "bias")},
    }


def _dense_in(p: Params, x: torch.Tensor, cd,
              sp: Optional[SpmdContext]) -> torch.Tensor:
    """A column-parallel dense layer (this rank's output block)."""
    if sp is not None:
        x = sp.copy_to(x, "tp")
    return dense(p, x, compute_dtype=cd)


def _dense_out(p: Params, x: torch.Tensor, cd,
               sp: Optional[SpmdContext]) -> torch.Tensor:
    """A row-parallel dense layer: the product of this rank's rows,
    summed across ``tp``, then the bias."""
    if sp is None:
        return dense(p, x, compute_dtype=cd)
    y = sp.reduce_from(x.to(cd) @ p["kernel"].to(cd), "tp")
    return y + p["bias"].to(y.dtype)


def _block(cfg: BertConfig, p: Params, x: torch.Tensor,
           pad_mask: torch.Tensor,
           sp: Optional[SpmdContext] = None) -> torch.Tensor:
    B, T, _ = x.shape
    hd, cd = cfg.head_dim, cfg.compute_dtype
    h = layernorm(p["ln1"], x)
    qkv = _dense_in(p["attn_qkv"], h, cd, sp)
    Dl = qkv.shape[-1] // 3   # this rank's heads
    q, k, v = torch.split(qkv, Dl, dim=-1)
    # bidirectional attention; padded KEYS are pushed to NEG_INF so real
    # tokens never mix in padding (zeroed pad activations still carry a
    # layernorm bias, so zeroing the values alone would not be enough)
    Hl = Dl // hd
    attn = mha(q.reshape(B, T, Hl, hd), k.reshape(B, T, Hl, hd),
               v.reshape(B, T, Hl, hd), causal=False,
               mask=pad_mask[:, None, None, :] > 0)
    x = x + _dense_out(p["attn_out"], attn.reshape(B, T, Dl), cd, sp)
    h = layernorm(p["ln2"], x)
    h = gelu(_dense_in(p["mlp_up"], h, cd, sp))
    x = x + _dense_out(p["mlp_down"], h, cd, sp)
    return x * pad_mask[..., None].to(x.dtype)  # keep padded positions inert


def _block_at(cfg: BertConfig, blocks: Params, i: int, x: torch.Tensor,
              pad_mask: torch.Tensor,
              sp: Optional[SpmdContext]) -> torch.Tensor:
    """Block ``i``; over a mesh its weights are gathered here, inside the
    remat region (the backward gathers them again)."""
    if sp is None:
        lp = {name: {k: v[i] for k, v in sub.items()}
              for name, sub in blocks.items()}
    else:
        lp = _layer_local(sp, cfg, blocks, i)
    return _block(cfg, lp, x, pad_mask, sp)


def _mesh_of(params: Params) -> Optional[SpmdContext]:
    sp = spmd_of(params["embed"]["table"])
    if sp is not None and sp.sp > 1:
        raise ValueError(f"an 'sp' axis of size {sp.sp}: sequence "
                         f"parallelism is the GPT's; BERT has none")
    return sp


def _small(params: Params, name: str, sp: Optional[SpmdContext]) -> Params:
    """A replicated sub-tree as this rank computes with it."""
    if sp is None:
        return params[name]
    return {k: sp.local(v) for k, v in params[name].items()}


def _encode(params: Params, cfg: BertConfig, tokens: torch.Tensor,
            segments: Optional[torch.Tensor], pad_mask: Optional[torch.Tensor],
            sp: Optional[SpmdContext]) -> torch.Tensor:
    """This rank's rows of :func:`encode`'s output."""
    tokens = local_rows(tokens)
    B, T = tokens.shape
    segments = (torch.zeros_like(tokens) if segments is None
                else local_rows(segments))
    if pad_mask is None:
        pad_mask = torch.ones((B, T), dtype=torch.float32,
                              device=tokens.device)
    pad_mask = local_rows(pad_mask)
    if sp is None:
        table, pos, seg = (params["embed"]["table"], params["pos_embed"],
                           params["seg_embed"])
        x = table[tokens]
    else:
        # vocab-parallel: each rank looks up the ids of its block
        table = sp.local(params["embed"]["table"], keep={"tp": 0})
        pos, seg = sp.local(params["pos_embed"]), sp.local(params["seg_embed"])
        Vl = table.shape[0]
        ids = tokens.long() - sp.tp_rank * Vl
        inside = (ids >= 0) & (ids < Vl)
        x = sp.reduce_from(table[ids.clamp(0, Vl - 1)] * inside[..., None],
                           "tp")
    x = x + pos[None, :T] + seg[segments]
    x = layernorm(_small(params, "embed_norm", sp), x).to(cfg.compute_dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        if remat:
            x = checkpoint(_block_at, cfg, params["blocks"], i, x, pad_mask,
                           sp, use_reentrant=False)
        else:
            x = _block_at(cfg, params["blocks"], i, x, pad_mask, sp)
    return x


def _global(out: torch.Tensor, sp: Optional[SpmdContext]) -> torch.Tensor:
    """This rank's rows of an output as the DTensor of the global batch."""
    if sp is None:
        return out
    from torch.distributed.tensor import DTensor

    shape = (out.shape[0] * sp.batch_shards, *out.shape[1:])
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(out, sp.mesh, placements_for(
        batch_spec(out.dim() - 1), sp.mesh), run_check=False,
        shape=shape, stride=tuple(stride))


def encode(params: Params, cfg: BertConfig, tokens: torch.Tensor,
           segments: Optional[torch.Tensor] = None,
           pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: int [B, T] → sequence output [B, T, D] (compute dtype).

    ``pad_mask``: float [B, T], 1 for real tokens and 0 for padding
    (default all ones). Padded positions are zeroed after every block and
    must be excluded from any loss. Over a mesh, a DTensor split over the
    batch axes.
    """
    sp = _mesh_of(params)
    return _global(_encode(params, cfg, tokens, segments, pad_mask, sp), sp)


def pooled(params: Params, cfg: BertConfig, seq_out: torch.Tensor
           ) -> torch.Tensor:
    """[CLS] pooler: tanh(dense(first token)) → [B, D]."""
    sp = _mesh_of(params)
    return torch.tanh(dense(_small(params, "pooler", sp),
                            local_rows(seq_out)[:, 0],
                            compute_dtype=cfg.compute_dtype))


def _classify(params: Params, cfg: BertConfig, tokens: torch.Tensor,
              segments: Optional[torch.Tensor],
              pad_mask: Optional[torch.Tensor],
              sp: Optional[SpmdContext]) -> torch.Tensor:
    seq = _encode(params, cfg, tokens, segments, pad_mask, sp)
    h = torch.tanh(dense(_small(params, "pooler", sp), seq[:, 0],
                         compute_dtype=cfg.compute_dtype))
    return dense(_small(params, "cls_head", sp), h,
                 compute_dtype=cfg.compute_dtype).float()


def classify(params: Params, cfg: BertConfig, tokens: torch.Tensor,
             segments: Optional[torch.Tensor] = None,
             pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fine-tune head → logits [B, n_classes] (fp32); over a mesh a
    DTensor split over the batch axes."""
    sp = _mesh_of(params)
    return _global(_classify(params, cfg, tokens, segments, pad_mask, sp),
                   sp)


def _mlm_logits(params: Params, cfg: BertConfig, tokens: torch.Tensor,
                segments: Optional[torch.Tensor],
                pad_mask: Optional[torch.Tensor],
                sp: Optional[SpmdContext]) -> torch.Tensor:
    """This rank's rows and, over ``tp``, its vocabulary block."""
    seq = _encode(params, cfg, tokens, segments, pad_mask, sp)
    if sp is None:
        table, bias = params["embed"]["table"], params["mlm_bias"]
    else:
        seq = sp.copy_to(seq, "tp")
        table = sp.local(params["embed"]["table"], keep={"tp": 0})
        bias = sp.local(params["mlm_bias"], keep={"tp": 0})
    logits = torch.einsum("btd,vd->btv", seq, table.to(cfg.compute_dtype))
    return (logits + bias).float()


def mlm_logits(params: Params, cfg: BertConfig, tokens: torch.Tensor,
               segments: Optional[torch.Tensor] = None,
               pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked-LM logits [B, T, V] (fp32), projection tied to the
    embedding; over a mesh a DTensor split over the batch axes."""
    sp = _mesh_of(params)
    logits = _mlm_logits(params, cfg, tokens, segments, pad_mask, sp)
    if sp is not None:
        logits = sp.gather_replicated(logits, 2, "tp")
    return _global(logits, sp)


def classify_loss(params: Params, cfg: BertConfig, tokens: torch.Tensor,
                  labels: torch.Tensor,
                  segments: Optional[torch.Tensor] = None,
                  pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy of the fine-tune head; over a mesh the global
    batch's."""
    sp = _mesh_of(params)
    logits = _classify(params, cfg, tokens, segments, pad_mask, sp)
    loss = softmax_cross_entropy(logits, local_rows(labels)).mean()
    return loss if sp is None else sp.batch_sum(loss / sp.batch_shards)


def mlm_loss(params: Params, cfg: BertConfig, tokens: torch.Tensor,
             targets: torch.Tensor, mask: torch.Tensor,
             segments: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MLM objective: ``mask`` [B, T] selects the positions whose
    ``targets`` count (the 15% that were masked or corrupted)."""
    sp = _mesh_of(params)
    logits = _mlm_logits(params, cfg, tokens, segments, None, sp)
    targets, m = local_rows(targets).reshape(-1), local_rows(mask).reshape(-1)
    logits = logits.reshape(-1, logits.shape[-1])
    m = m.float()
    if sp is None:
        per_tok = softmax_cross_entropy(logits, targets)
        return (per_tok * m).sum() / m.sum().clamp_min(1.0)
    per_tok = sp.cross_entropy(logits, targets)
    count = sp.batch_sum_(m.sum()).clamp_min(1.0)
    return sp.batch_sum((per_tok * m).sum() / count)


def param_count(params: Params) -> int:
    return sum(int(p.numel()) for p in leaves(params))
