"""BERT — the port of ``determined_clone_tpu/models/bert.py``:
bidirectional encoder for masked-LM pretraining and fine-tuning
(BASELINE config #4 fine-tunes it through the Core API).

Same construction as the JAX model: stacked-block params (``[L, ...]``
leading dim) walked by a loop in place of ``lax.scan``, products in
``compute_dtype`` (params fp32), bidirectional ``mha`` with padded *keys*
pushed to ``NEG_INF``, learned position and segment embeddings, the MLM
projection tied to the token embedding, and a [CLS] pooler and head for
fine-tunes. ``BERT_SHARDING_RULES`` comes with the parallelism slice.

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
from determined_clone_tpu_torch.training.optim import leaves

Params = Dict[str, Any]


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


def _block(cfg: BertConfig, p: Params, x: torch.Tensor,
           pad_mask: torch.Tensor) -> torch.Tensor:
    B, T, D = x.shape
    H, hd, cd = cfg.n_heads, cfg.head_dim, cfg.compute_dtype
    h = layernorm(p["ln1"], x)
    qkv = dense(p["attn_qkv"], h, compute_dtype=cd)
    q, k, v = torch.split(qkv, D, dim=-1)
    # bidirectional attention; padded KEYS are pushed to NEG_INF so real
    # tokens never mix in padding (zeroed pad activations still carry a
    # layernorm bias, so zeroing the values alone would not be enough)
    attn = mha(q.reshape(B, T, H, hd), k.reshape(B, T, H, hd),
               v.reshape(B, T, H, hd), causal=False,
               mask=pad_mask[:, None, None, :] > 0)
    x = x + dense(p["attn_out"], attn.reshape(B, T, D), compute_dtype=cd)
    h = layernorm(p["ln2"], x)
    h = gelu(dense(p["mlp_up"], h, compute_dtype=cd))
    x = x + dense(p["mlp_down"], h, compute_dtype=cd)
    return x * pad_mask[..., None].to(x.dtype)  # keep padded positions inert


def encode(params: Params, cfg: BertConfig, tokens: torch.Tensor,
           segments: Optional[torch.Tensor] = None,
           pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: int [B, T] → sequence output [B, T, D] (compute dtype).

    ``pad_mask``: float [B, T], 1 for real tokens and 0 for padding
    (default all ones). Padded positions are zeroed after every block and
    must be excluded from any loss.
    """
    B, T = tokens.shape
    if segments is None:
        segments = torch.zeros_like(tokens)
    if pad_mask is None:
        pad_mask = torch.ones((B, T), dtype=torch.float32,
                              device=tokens.device)
    x = (params["embed"]["table"][tokens] + params["pos_embed"][None, :T]
         + params["seg_embed"][segments])
    x = layernorm(params["embed_norm"], x).to(cfg.compute_dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        lp = {name: {k: v[i] for k, v in sub.items()}
              for name, sub in blocks.items()}
        if remat:
            x = checkpoint(_block, cfg, lp, x, pad_mask, use_reentrant=False)
        else:
            x = _block(cfg, lp, x, pad_mask)
    return x


def pooled(params: Params, cfg: BertConfig, seq_out: torch.Tensor
           ) -> torch.Tensor:
    """[CLS] pooler: tanh(dense(first token)) → [B, D]."""
    return torch.tanh(dense(params["pooler"], seq_out[:, 0],
                            compute_dtype=cfg.compute_dtype))


def classify(params: Params, cfg: BertConfig, tokens: torch.Tensor,
             segments: Optional[torch.Tensor] = None,
             pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fine-tune head → logits [B, n_classes] (fp32)."""
    seq = encode(params, cfg, tokens, segments, pad_mask)
    return dense(params["cls_head"], pooled(params, cfg, seq),
                 compute_dtype=cfg.compute_dtype).float()


def mlm_logits(params: Params, cfg: BertConfig, tokens: torch.Tensor,
               segments: Optional[torch.Tensor] = None,
               pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked-LM logits [B, T, V] (fp32), projection tied to the
    embedding."""
    seq = encode(params, cfg, tokens, segments, pad_mask)
    table = params["embed"]["table"].to(cfg.compute_dtype)
    logits = torch.einsum("btd,vd->btv", seq, table) + params["mlm_bias"]
    return logits.float()


def classify_loss(params: Params, cfg: BertConfig, tokens: torch.Tensor,
                  labels: torch.Tensor,
                  segments: Optional[torch.Tensor] = None,
                  pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logits = classify(params, cfg, tokens, segments, pad_mask)
    return softmax_cross_entropy(logits, labels).mean()


def mlm_loss(params: Params, cfg: BertConfig, tokens: torch.Tensor,
             targets: torch.Tensor, mask: torch.Tensor,
             segments: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MLM objective: ``mask`` [B, T] selects the positions whose
    ``targets`` count (the 15% that were masked or corrupted)."""
    logits = mlm_logits(params, cfg, tokens, segments)
    per_tok = softmax_cross_entropy(logits.reshape(-1, cfg.vocab_size),
                                    targets.reshape(-1))
    m = mask.reshape(-1).float()
    return (per_tok * m).sum() / m.sum().clamp_min(1.0)


def param_count(params: Params) -> int:
    return sum(int(p.numel()) for p in leaves(params))
