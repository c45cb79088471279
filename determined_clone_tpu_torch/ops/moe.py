"""Mixture-of-Experts FFN — the port of ``determined_clone_tpu/ops/moe.py``.

The semantics are the JAX package's, exactly: capacity
``C = ceil(N/E · cf)`` slots per expert over the whole (global) token
axis; the top-k choices processed in priority order, each expert's
running count carried from one choice to the next, so earlier choices
claim capacity first; a choice past its expert's capacity is dropped
(the token falls through the residual); the chosen gates renormalised
to sum to 1, cast to the compute dtype before the combine; and the
Switch load-balancing loss ``E · Σ_e f_e·P_e`` over first choices.

The JAX package routes with dense one-hot ``[N, E, C]`` dispatch and
combine tensors, so every op is a static-shape einsum for the MXU
(:func:`moe_ffn_dense` keeps that form as the reference). On the card
the port dispatches by index (:func:`moe_ffn`): each kept choice's slot
``(expert, position)`` is computed from the same counts, the experts'
rows are gathered into ``[E, C, D]``, two ``torch.bmm`` products run
the experts, and each token gathers back its k expert rows and sums
them under its gates. Shapes stay static (dropped choices point at a
scratch slot), so the paged forward can be captured in a CUDA graph.

Over a mesh (``comm``, a ``parallel.spmd.SpmdContext``) the routing is
the JAX program's on the global token array, whose order runs row by row
and, within a row, by ``sp`` rank: a token's slot counts the tokens of
the batch blocks before its own, of the earlier rows of its block on
every ``sp`` rank, and of its own row on the lower ``sp`` ranks (prefixes
over all-gathered counts per row), C comes from the global N, and the aux
loss's means run over every token. Under ``ep`` each rank runs its own
experts and all-gathers their outputs; under ``tp`` each expert's FFN
width is split, its down projection summed across ``tp``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from determined_clone_tpu_torch.ops.layers import gelu, trunc_normal

Params = Dict[str, Any]


def moe_init(gen: torch.Generator, n_experts: int, d_model: int, d_ff: int,
             dtype=torch.float32, out_stddev: float = 0.02,
             device: Any = None) -> Params:
    """Expert-stacked FFN params: leading [E] expert dim (sharded over ep)."""
    E, D, F = n_experts, d_model, d_ff
    return {
        "router": {"kernel": trunc_normal(gen, (D, E), stddev=0.02,
                                          dtype=dtype, device=device)},
        "up": {"kernel": trunc_normal(gen, (E, D, F), stddev=0.02,
                                      dtype=dtype, device=device),
               "bias": torch.zeros((E, F), dtype=dtype, device=device)},
        "down": {"kernel": trunc_normal(gen, (E, F, D), stddev=out_stddev,
                                        dtype=dtype, device=device),
                 "bias": torch.zeros((E, D), dtype=dtype, device=device)},
    }


def expert_capacity(n_tokens: int, n_experts: int,
                    capacity_factor: float) -> int:
    return max(1, math.ceil(n_tokens / n_experts * capacity_factor))


class LocalComm:
    """The one-rank ``comm``: every batch block is this one, every expert
    and the whole FFN width are local."""
    token_shards = 1
    ep = tp = 1
    ep_rank = tp_rank = 0

    def token_offsets(self, row_counts):
        return torch.zeros_like(row_counts), row_counts.sum(0)

    def token_sum(self, x):
        return x

    def token_sum_(self, x):
        return x

    def to_experts(self, x):
        return x

    def reduce_tp(self, x):
        return x

    def gather_ep(self, x):
        return x


LOCAL = LocalComm()


def route(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row, highest first; ties to the lowest expert index,
    as ``jax.lax.top_k`` breaks them (a stable descending sort)."""
    top_probs, top_idx = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    return top_probs[:, :k], top_idx[:, :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    # a comparison, not F.one_hot: no range check, so no host sync
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _gates(params: Params, tokens: torch.Tensor, k: int):
    # router in fp32 for a stable softmax
    logits = tokens.float() @ params["router"]["kernel"].float()
    probs = torch.softmax(logits, dim=-1)                       # [N, E]
    top_probs, top_idx = route(probs, k)                        # [N, k]
    top_probs = top_probs / top_probs.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_probs, top_idx


def _aux_loss(probs, top_idx, E, n_global, comm) -> torch.Tensor:
    """Switch load-balancing loss over first choices: the dispatch
    fractions ``f`` and mean router probabilities ``P`` of the global
    batch."""
    f = comm.token_sum_(_one_hot(top_idx[:, 0], E).float().sum(0)) / n_global
    p = comm.token_sum(probs.sum(0)) / n_global
    return E * (f * p).sum()


def moe_ffn(params: Params, x: torch.Tensor, *, k: int = 2,
            capacity_factor: float = 1.25,
            compute_dtype=torch.bfloat16, comm: Any = None,
            stats: Optional[Dict[str, Any]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert FFN by index. x: [B, T, D] → ([B, T, D],
    aux_loss scalar fp32). ``params``' expert leaves hold this rank's
    experts and FFN width (all of them on one rank). ``stats``, when
    given, receives ``keep`` ([N, k] bool: the choices not dropped) and
    the capacity ``C``."""
    comm = comm or LOCAL
    B, T, D = x.shape
    N = B * T
    E = params["router"]["kernel"].shape[-1]
    n_global = N * comm.token_shards
    C = expert_capacity(n_global, E, capacity_factor)
    k = min(k, E)
    E_loc = params["up"]["kernel"].shape[0]
    e0 = comm.ep_rank * E_loc

    tokens = x.reshape(N, D)
    probs, top_probs, top_idx = _gates(params, tokens, k)

    with torch.no_grad():
        onehot = _one_hot(top_idx, E)                           # [N, k, E]
        row_counts = onehot.reshape(B, T, k, E).sum(1)          # [B, k, E]
        counts = row_counts.sum(0)                              # [k, E]
        # per row: the tokens before it elsewhere in the global order
        before, total = comm.token_offsets(row_counts)
        # slots claimed by earlier choices, globally and on this block
        g_base = (torch.cumsum(total, 0) - total)[None] + before
        g_base = g_base[:, None].expand(B, T, k, E).reshape(N, k, E)
        l_base = torch.cumsum(counts, 0) - counts
        # scanned along the last dim of the transpose: scans down the
        # 8192 rows took 31.6 ms of a 432 ms MoE GPT step on an H100
        # (chip_smoke.py phase 11's profile)
        cols = onehot.reshape(N, k * E).T.contiguous()
        excl = (torch.cumsum(cols, 1) - cols).T.reshape(N, k, E)  # [N, k, E]
        pos = ((excl + g_base) * onehot).sum(-1)                # global slot
        lpos = ((excl + l_base) * onehot).sum(-1)               # local slot
        keep = pos < C
        # the kept choices of a block are a prefix of its order, so at
        # most min(C, N) local slots per expert
        C_loc = min(C, N)
        mine = keep & (top_idx >= e0) & (top_idx < e0 + E_loc)
        scratch = E_loc * C_loc
        slot = torch.where(mine, (top_idx - e0) * C_loc + lpos,
                           torch.full_like(lpos, scratch))
        src = torch.full((scratch + 1,), N, dtype=torch.long,
                         device=x.device)
        token = torch.arange(N, device=x.device)[:, None].expand(N, k)
        src.scatter_(0, slot.reshape(-1), token.reshape(-1))
        src = src[:scratch].reshape(E_loc, C_loc)               # token ids
        back = torch.where(keep, top_idx * C_loc + lpos,
                           torch.zeros_like(lpos))               # [N, k]

    cd = compute_dtype
    xin = comm.to_experts(tokens).to(cd)
    xpad = torch.cat([xin, xin.new_zeros(1, D)])
    # index_select, not xpad[src]: its backward is a scatter-add, where
    # advanced indexing's sorts the indices first; each token sits in at
    # most k slots, so for k <= 2 the sum's order cannot change it
    xe = xpad.index_select(0, src.reshape(-1)).reshape(E_loc, C_loc, D)
    h = torch.bmm(xe, params["up"]["kernel"].to(cd))
    h = gelu(h + params["up"]["bias"].to(cd)[:, None, :])
    ye = comm.reduce_tp(torch.bmm(h, params["down"]["kernel"].to(cd)))
    ye = ye + params["down"]["bias"].to(cd)[:, None, :]
    ye = comm.gather_ep(ye).reshape(E * C_loc, D)               # all experts
    gate = (top_probs * keep).to(cd)                            # [N, k]
    rows = ye.index_select(0, back.reshape(-1)).reshape(N, k, D)
    y = (gate.float()[..., None] * rows.float()).sum(1).to(cd)

    if stats is not None:
        stats.update(keep=keep, capacity=C)
    aux = _aux_loss(probs, top_idx, E, n_global, comm)
    return y.reshape(B, T, D).to(x.dtype), aux.float()


def moe_ffn_dense(params: Params, x: torch.Tensor, *, k: int = 2,
                  capacity_factor: float = 1.25,
                  compute_dtype=torch.bfloat16,
                  stats: Optional[Dict[str, Any]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's one-hot einsum form, line for line, on one rank:
    the reference :func:`moe_ffn` is held against. Builds the dense
    ``[N, E, C]`` dispatch and combine tensors; nothing on the main path
    calls it."""
    B, T, D = x.shape
    N = B * T
    E = params["router"]["kernel"].shape[-1]
    C = expert_capacity(N, E, capacity_factor)
    k = min(k, E)
    tokens = x.reshape(N, D)
    probs, top_probs, top_idx = _gates(params, tokens, k)

    dispatch = torch.zeros((N, E, C), dtype=torch.bool, device=x.device)
    combine = torch.zeros((N, E, C), dtype=torch.float32, device=x.device)
    counts = torch.zeros((E,), dtype=torch.long, device=x.device)
    keeps = []
    for i in range(k):
        mask_i = _one_hot(top_idx[:, i], E)                     # [N, E]
        pos_i = torch.cumsum(mask_i, 0) - mask_i + counts[None, :]
        pos = (pos_i * mask_i).sum(-1)                          # [N]
        keep = pos < C
        keeps.append(keep)
        counts = counts + mask_i.sum(0)
        onehot_pos = _one_hot(pos, C).float()                   # [N, C]
        d_i = (mask_i.float()[:, :, None] * onehot_pos[:, None, :]
               * keep.float()[:, None, None])
        dispatch = dispatch | (d_i > 0)
        combine = combine + d_i * top_probs[:, i][:, None, None]

    cd = compute_dtype
    xe = torch.einsum("nec,nd->ecd", dispatch.to(cd), tokens.to(cd))
    h = torch.einsum("ecd,edf->ecf", xe, params["up"]["kernel"].to(cd))
    h = gelu(h + params["up"]["bias"].to(cd)[:, None, :])
    ye = torch.einsum("ecf,efd->ecd", h, params["down"]["kernel"].to(cd))
    ye = ye + params["down"]["bias"].to(cd)[:, None, :]
    y = torch.einsum("nec,ecd->nd", combine.to(cd), ye)

    if stats is not None:
        stats.update(keep=torch.stack(keeps, 1), capacity=C)
    aux = _aux_loss(probs, top_idx, E, N, LOCAL)
    return y.reshape(B, T, D).to(x.dtype), aux.float()
