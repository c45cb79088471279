"""The per-rank program over a mesh: differentiable collectives and the
compute view of a sharded parameter.

The JAX package writes each model once and lets XLA's partitioner insert
the collectives its PartitionSpecs imply. The port stores parameters,
optimizer state and batches as DTensors on those specs
(``parallel/sharding.py``) and runs each rank's share of the model on
plain local tensors, with the collectives placed by hand in FSDP and
Megatron style:

- a weight sharded over ``fsdp`` (or any axis the compute does not
  split) is all-gathered before use, and its gradient reduce-scattered
  (summed) back onto the shard — :func:`gather`;
- ``tp`` splits attention heads, the FFN width and the vocabulary, and
  ``ep`` the experts: a rank keeps its own block of such a weight.
  Activations enter a split region through :func:`copy_to` (identity
  forward, all-reduce of the gradient) and partial sums leave it through
  :func:`reduce_from` (all-reduce forward, identity backward);
- the batch is split over ``dp`` × ``fsdp``: losses are the global
  batch's (a :func:`reduce_from` over those axes), and after the
  backward each gradient is summed over the batch axes it is not
  sharded on (:meth:`SpmdContext.reduce_grads`).

Collectives over an axis of size 1 are skipped, so a one-rank mesh runs
the one-card program. Reductions run in fp32 whatever the tensor's dtype.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BATCH_AXES = ("dp", "fsdp")


def _is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's own local tensor — the same object on every call, so it
    can be an autograd leaf (autograd through ``DTensor.to_local`` spends
    its time in placement bookkeeping) — else ``t``."""
    if not _is_dtensor(t):
        return t
    with torch.no_grad():
        return t.to_local()


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    x = x.contiguous()
    wire = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    if x.dtype == torch.bfloat16:
        parts = [p.view(torch.bfloat16) for p in parts]
    return torch.cat(parts, dim)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.detach().float().clone() if x.dtype != torch.float32 else \
        x.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out.to(x.dtype)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward reduce-scatters (sums)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.dim, ctx.group, ctx.n, ctx.rank = dim, group, n, rank
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        return g.chunk(ctx.n, ctx.dim)[ctx.rank].contiguous(), None, None, \
            None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather along ``dim`` for a consumer that every rank of the
    group runs alike: the backward keeps this rank's block of the (equal)
    gradients."""

    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.dim, ctx.n, ctx.rank = dim, n, rank
        return _all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.rank].contiguous(), None, None, \
            None, None


class _CopyTo(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward; identity backward (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class SpmdContext:
    """One rank's view of a DeviceMesh: axis sizes, its coordinate, the
    process group of each axis of size > 1, and the collectives above."""

    def __init__(self, mesh: Any) -> None:
        self.mesh = mesh
        names = tuple(mesh.mesh_dim_names)
        self.names = names
        self.sizes = {a: mesh.size(i) for i, a in enumerate(names)}
        self.coord = dict(zip(names, mesh.get_coordinate()))
        self.groups = {a: mesh.get_group(a) for a in names
                       if self.sizes[a] > 1}
        self.batch_shards = math.prod(self.sizes.get(a, 1)
                                      for a in BATCH_AXES)
        # dp-major: the batch block of (dp, fsdp) coordinate (i, j)
        self.batch_index = (self.coord.get("dp", 0) * self.sizes.get("fsdp", 1)
                            + self.coord.get("fsdp", 0))
        self.tp, self.tp_rank = self.sizes.get("tp", 1), self.coord.get("tp", 0)
        self.ep, self.ep_rank = self.sizes.get("ep", 1), self.coord.get("ep", 0)

    # -- collectives ---------------------------------------------------------

    def _axes(self, axes: Iterable[str]) -> List[str]:
        return [a for a in axes if self.sizes.get(a, 1) > 1]

    def gather(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        if self.sizes.get(axis, 1) == 1:
            return x
        return _Gather.apply(x, dim, self.groups[axis], self.sizes[axis],
                             self.coord[axis])

    def gather_replicated(self, x: torch.Tensor, dim: int,
                          axis: str) -> torch.Tensor:
        if self.sizes.get(axis, 1) == 1:
            return x
        return _GatherReplicated.apply(x, dim, self.groups[axis],
                                       self.sizes[axis], self.coord[axis])

    def copy_to(self, x: torch.Tensor, *axes: str) -> torch.Tensor:
        for a in self._axes(axes):
            x = _CopyTo.apply(x, self.groups[a])
        return x

    def reduce_from(self, x: torch.Tensor, *axes: str) -> torch.Tensor:
        for a in self._axes(axes):
            x = _ReduceFrom.apply(x, self.groups[a])
        return x

    def sum_(self, x: torch.Tensor, *axes: str,
             op=dist.ReduceOp.SUM) -> torch.Tensor:
        """A plain all-reduce (no gradient) over ``axes``."""
        for a in self._axes(axes):
            x = _all_reduce(x, self.groups[a], op)
        return x

    def gather_batch(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of every batch block stacked on a new leading dim, in
        batch order (dp-major), without gradient."""
        x = x[None]
        if self.sizes.get("fsdp", 1) > 1:
            x = _all_gather(x, 0, self.groups["fsdp"], self.sizes["fsdp"])
        if self.sizes.get("dp", 1) > 1:
            x = _all_gather(x, 0, self.groups["dp"], self.sizes["dp"])
        return x

    # -- parameters ----------------------------------------------------------

    def local(self, t: torch.Tensor, *, keep: Optional[Dict[str, int]] = None,
              split: Sequence[str] = (), index: Optional[int] = None
              ) -> torch.Tensor:
        """The compute view of parameter ``t`` (a DTensor, or a plain
        tensor replicated everywhere), differentiable.

        ``index`` first selects along dimension 0 (a layer of a stacked
        block). ``keep`` maps an axis to the dimension (after ``index``)
        whose block of that axis this rank computes with: a stored shard
        stays as it is, a replicated tensor is cut to the block. Every
        other sharded dimension is all-gathered. ``split`` names axes over
        which the caller will use a part of the whole tensor of its own
        choosing (the heads of a fused projection): their gradients are
        summed over the axis."""
        keep = keep or {}
        placements: Sequence[Any] = ()
        if _is_dtensor(t):
            placements = t.placements
            t = local_tensor(t)
        shift = 0
        if index is not None:
            t, shift = t[index], 1
        from torch.distributed.tensor import Shard

        sharded = {}
        for md in reversed(range(len(placements))):
            pl, axis = placements[md], self.names[md]
            if not isinstance(pl, Shard) or self.sizes[axis] == 1:
                continue
            d = pl.dim - shift
            if d < 0:
                raise ValueError(f"dimension 0 is sharded over {axis!r}; "
                                 f"cannot index it")
            sharded[axis] = d
            if axis in keep:
                if keep[axis] != d:
                    raise ValueError(f"axis {axis!r} shards dimension {d}, "
                                     f"the compute splits {keep[axis]}")
                continue
            t = self.gather(t, d, axis)
        for axis, d in keep.items():
            n = self.sizes.get(axis, 1)
            if n > 1 and axis not in sharded:
                t = self.copy_to(t, axis).chunk(n, d)[self.coord[axis]]
        for axis in split:
            if self.sizes.get(axis, 1) > 1 and axis not in sharded:
                t = self.copy_to(t, axis)
        return t

    def reduce_grads(self, params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor]) -> None:
        """Sum the local gradient of each DTensor parameter, in place, over
        the batch axes the parameter is replicated on: the ranks of those
        axes computed it from their own rows. (Over an axis the parameter
        is sharded on, the all-gather's backward has summed already.)"""
        from torch.distributed.tensor import Shard

        for p, local in zip(params, grads):
            if not _is_dtensor(p):
                continue
            for md, pl in enumerate(p.placements):
                axis = self.names[md]
                if (axis in BATCH_AXES and self.sizes[axis] > 1
                        and not isinstance(pl, Shard)):
                    local.copy_(_all_reduce(local, self.groups[axis]))

    # -- the MoE routing's protocol (ops/moe.py) -----------------------------

    def token_offsets(self, counts: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the counts of the batch blocks before this one, the total)."""
        if self.batch_shards == 1:
            return torch.zeros_like(counts), counts
        every = self.gather_batch(counts)
        return every[:self.batch_index].sum(0), every.sum(0)

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduce_from(x, *BATCH_AXES)

    def batch_sum_(self, x: torch.Tensor) -> torch.Tensor:
        return self.sum_(x, *BATCH_AXES)

    def to_experts(self, x: torch.Tensor) -> torch.Tensor:
        return self.copy_to(x, "tp", "ep")

    def reduce_tp(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduce_from(x, "tp")

    def gather_ep(self, x: torch.Tensor) -> torch.Tensor:
        return self.gather_replicated(x, 0, "ep")


def spmd_of(t: Any) -> Optional[SpmdContext]:
    """The SpmdContext of a DTensor's mesh, None for a plain tensor."""
    return SpmdContext(t.device_mesh) if _is_dtensor(t) else None


def local_rows(t: Any) -> torch.Tensor:
    """A batch's local rows: the local tensor of a DTensor, else ``t``."""
    return local_tensor(t)
