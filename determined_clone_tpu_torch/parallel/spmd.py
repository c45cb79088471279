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
- the batch is split over ``dp`` × ``fsdp`` (and the GPT's sequence
  over ``sp``): losses are the global batch's (a :func:`reduce_from`
  over those axes), and after the backward each gradient is summed over
  the data axes it is not sharded on (:meth:`SpmdContext.reduce_grads`);
- ``pp`` and ``sp`` move activations between neighbours of a ring
  (:meth:`SpmdContext.shift`: one ``batch_isend_irecv`` whose backward
  is the reverse shift), for the GPipe pipeline (``parallel/
  pipeline.py``) and ring attention (``ops/attention.py``);
- a model with no collectives of its own (mnist, ResNet: the default
  ``ShardingRules()``) runs through :func:`replicated_program`: every
  sharded leaf gathered whole before the model runs, each gradient
  summed back onto its shard, the result the global batch's mean.

Collectives over an axis of size 1 are skipped, so a one-rank mesh runs
the one-card program. Reductions run in fp32 whatever the tensor's dtype.
Every collective goes through :func:`_all_gather`, :func:`_all_reduce`
or :func:`_p2p`, which report it to ``telemetry/collectives.py`` (a
no-op unless a step's first call is being recorded).
"""
from __future__ import annotations

import math
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist

from determined_clone_tpu_torch.core._serialization import (
    tree_map_with_path,
    tree_paths_and_leaves,
)
from determined_clone_tpu_torch.telemetry import collectives

BATCH_AXES = ("dp", "fsdp")
# the axes that split the data: the ranks along them compute other rows
# (or, over sp, other tokens), so a parameter replicated over one of them
# has its gradient summed over it
DATA_AXES = BATCH_AXES + ("sp",)


def _is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def split_over(t: Any, axis: str, dim: int) -> bool:
    """True for a DTensor whose dimension ``dim`` is sharded over mesh
    axis ``axis`` (placements name no axis of size 1)."""
    if not _is_dtensor(t):
        return False
    from torch.distributed.tensor import Shard

    return any(isinstance(pl, Shard) and pl.dim == dim and name == axis
               for pl, name in zip(t.placements,
                                   t.device_mesh.mesh_dim_names))


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
    collectives.note("all-gather", group, n * wire.nbytes)
    if x.dtype == torch.bfloat16:
        parts = [p.view(torch.bfloat16) for p in parts]
    return torch.cat(parts, dim)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    # a contiguous copy: NCCL refuses strided tensors (a convolution's
    # channels-last weight gradient is one)
    out = x.detach().float().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    collectives.note("all-reduce", group, out.nbytes)
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


def _wire(t: torch.Tensor) -> torch.Tensor:
    """bf16 travels as int16 (gloo has no bf16); other dtypes as they are."""
    t = t.contiguous()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


# the groups a point-to-point call has opened, kept alive so that an id
# is never reused by another group
_P2P_OPENED: Dict[int, Any] = {}


def _p2p(sends: Sequence[torch.Tensor], dst: Optional[int],
         like: Sequence[torch.Tensor], src: Optional[int], group
         ) -> List[torch.Tensor]:
    """One ``batch_isend_irecv`` on ``group`` (peers are group ranks):
    ``sends`` to ``dst`` and tensors shaped as ``like`` from ``src``;
    either side may be None. Returns the received tensors."""
    if id(group) not in _P2P_OPENED:
        # NCCL wants every rank of a group in its first call; the ticks
        # of a pipeline pair only some ranks, so open the group with an
        # all-reduce first
        probe = torch.zeros(1, device=sends[0].device if sends
                            else like[0].device)
        dist.all_reduce(probe, group=group)
        collectives.note("all-reduce", group, probe.nbytes)
        _P2P_OPENED[id(group)] = group
    ops, out = [], []
    if dst is not None:
        peer = dist.get_global_rank(group, dst)
        ops += [dist.P2POp(dist.isend, _wire(t), peer, group) for t in sends]
    if src is not None:
        peer = dist.get_global_rank(group, src)
        out = [torch.empty_like(t, memory_format=torch.contiguous_format)
               for t in like]
        ops += [dist.P2POp(dist.irecv, _wire(t), peer, group) for t in out]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        # a permute's result is each participant's payload: the tensors
        # this rank moves (sent, else received)
        collectives.note("collective-permute", group,
                         sum(t.nbytes for t in (sends if dst is not None
                                                else out)))
    return out


class _Shift(torch.autograd.Function):
    """Send ``xs`` to group rank ``dst`` and receive their like from
    ``src`` (either None: no send, or no receive — then the outputs are
    the zeros of ``xs``). The backward runs the reverse: the received
    tensors' gradients go to ``src``, and ``xs``' come from ``dst``.
    Every rank of a ring calls it alike, so the sends and receives pair
    up in the forward and again in the backward."""

    @staticmethod
    def forward(ctx, src, dst, group, *xs):
        ctx.src, ctx.dst, ctx.group = src, dst, group
        got = _p2p(xs, dst, xs, src, group)
        return tuple(got) if src is not None else tuple(
            torch.zeros_like(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        back = _p2p(gs, ctx.src, gs, ctx.dst, ctx.group)
        if ctx.dst is None:
            back = [None] * len(gs)
        return (None, None, None, *back)


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
        self.pp, self.pp_rank = self.sizes.get("pp", 1), self.coord.get("pp", 0)
        self.sp, self.sp_rank = self.sizes.get("sp", 1), self.coord.get("sp", 0)
        # the blocks of the global token array: batch blocks times sp's
        self.token_shards = self.batch_shards * self.sp

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

    def shift(self, xs: Sequence[torch.Tensor], axis: str, *,
              send: bool = True, recv: bool = True
              ) -> Tuple[torch.Tensor, ...]:
        """``xs`` sent to the next rank of ``axis`` (coordinate + 1, mod
        its size) while the previous rank's are received, differentiably
        (the backward shifts the gradients back). ``send=False`` or
        ``recv=False`` leaves out this rank's half, which its neighbour
        must leave out alike; without a receive the result is zeros."""
        n, c = self.sizes[axis], self.coord[axis]
        return _Shift.apply((c - 1) % n if recv else None,
                            (c + 1) % n if send else None,
                            self.groups[axis], *xs)

    def qkv_heads(self, t: torch.Tensor, n_heads: int,
                  head_dim: int) -> torch.Tensor:
        """This rank's heads of q, k and v from a fused ``[..., 3·D]``
        projection (Megatron's column split is not head-aligned on the
        stored ``[3D]`` blocks, so the caller takes the whole and keeps
        its heads)."""
        if self.tp == 1:
            return t
        n = n_heads // self.tp
        t = t.reshape(*t.shape[:-1], 3, n_heads, head_dim)
        t = t[..., self.tp_rank * n:(self.tp_rank + 1) * n, :]
        return t.reshape(*t.shape[:-3], 3 * n * head_dim)

    def cross_entropy(self, logits: torch.Tensor, targets: torch.Tensor
                      ) -> torch.Tensor:
        """Per-token loss of logits whose last dimension is this rank's
        block of the vocabulary over ``tp`` (Megatron's vocab-parallel
        cross-entropy: the logsumexp and the target's logit span every
        block); plain cross-entropy when ``tp`` is 1."""
        from determined_clone_tpu_torch.ops.layers import (
            softmax_cross_entropy,
        )

        if self.tp == 1:
            return softmax_cross_entropy(logits, targets)
        logits, Vl = logits.float(), logits.shape[-1]
        with torch.no_grad():
            m = self.sum_(logits.max(-1).values, "tp", op=dist.ReduceOp.MAX)
        z = self.reduce_from((logits - m[..., None]).exp().sum(-1), "tp")
        t = targets.long() - self.tp_rank * Vl
        inside = (t >= 0) & (t < Vl)
        picked = logits.gather(-1, t.clamp(0, Vl - 1)[..., None]).squeeze(-1)
        picked = self.reduce_from(picked * inside, "tp")
        return m + z.log() - picked

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
        block); when ``pp`` splits dimension 0 (a pipeline stage's
        layers), ``index`` counts within this rank's block. ``keep`` maps an axis to the dimension (after ``index``)
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
            if d < 0 and axis == "pp":
                continue   # the stage's own layers, indexed above
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

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """Parameter ``t`` whole on this rank, differentiable: gathered
        over every axis that shards it. The backward sums the gradient
        over the data axes among them (their ranks computed other rows)
        and keeps this rank's block over the rest (they computed
        alike)."""
        if not _is_dtensor(t):
            return t
        from torch.distributed.tensor import Shard

        placements, t = t.placements, local_tensor(t)
        for md in reversed(range(len(placements))):
            pl, axis = placements[md], self.names[md]
            if isinstance(pl, Shard) and self.sizes[axis] > 1:
                t = (self.gather if axis in DATA_AXES
                     else self.gather_replicated)(t, pl.dim, axis)
        return t

    def reduce_grads(self, params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor]) -> None:
        """Sum the local gradient of each DTensor parameter, in place, over
        the data axes the parameter is replicated on: the ranks of those
        axes computed it from their own rows (or tokens). (Over an axis
        the parameter is sharded on, the all-gather's backward has summed
        already.)"""
        from torch.distributed.tensor import Shard

        for p, local in zip(params, grads):
            if not _is_dtensor(p):
                continue
            for md, pl in enumerate(p.placements):
                axis = self.names[md]
                if (axis in DATA_AXES and self.sizes[axis] > 1
                        and not isinstance(pl, Shard)):
                    local.copy_(_all_reduce(local, self.groups[axis]))

    # -- the MoE routing's protocol (ops/moe.py) -----------------------------

    def token_offsets(self, row_counts: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``row_counts`` [B, ...]: this rank's counts per local row. The
        global token order runs row by row and, within a row, by ``sp``
        rank. Returns (per row, the counts of the tokens before this
        rank's part of it that the rank's own earlier rows do not hold —
        the batch blocks before this one, the other ``sp`` ranks' part of
        the earlier rows, the lower ``sp`` ranks' part of this row; the
        global total)."""
        counts = row_counts.sum(0)
        within = torch.zeros_like(row_counts)
        if self.sp > 1:
            rows = _all_gather(row_counts[None], 0, self.groups["sp"],
                               self.sp)                       # [sp, B, ...]
            whole = rows.sum(0)
            within = (torch.cumsum(whole, 0) - whole
                      - (torch.cumsum(row_counts, 0) - row_counts)
                      + rows[:self.sp_rank].sum(0))
            counts = whole.sum(0)
        if self.batch_shards == 1:
            return within, counts
        every = self.gather_batch(counts)
        return within + every[:self.batch_index].sum(0), every.sum(0)

    def token_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over every rank holding other tokens, differentiably."""
        return self.reduce_from(x, *DATA_AXES)

    def token_sum_(self, x: torch.Tensor) -> torch.Tensor:
        return self.sum_(x, *DATA_AXES)

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


def replicated_program(fn: Callable[..., Any], params: Any, *batch: Any,
                       **kwargs: Any) -> Any:
    """``fn(params, *batch, rows=..., **kwargs)`` run as the JAX package
    runs a model that places no collectives of its own (the default
    ``ShardingRules()``: large leaves scattered over ``fsdp``,
    ``_auto_fsdp_spec``) — parameters whole in the forward, optimizer
    state scattered.

    Over a mesh (DTensor ``params``): every leaf gathered whole
    (:meth:`SpmdContext.whole`, the gradient summed back onto its shard),
    each batch leaf this rank's rows, and ``fn``'s result — a tensor or a
    dict of tensors, each a mean over the rows — made the global batch's
    mean. ``rows=(first, total)`` tells ``fn`` which rows of the global
    batch it holds (dropout draws its masks at the global shape). Without
    a mesh ``fn`` runs as it is, with ``rows=None``. The data must not be
    split over ``sp``: these models have no sequence parallelism."""
    first = next((t for _p, t in tree_paths_and_leaves(params)
                  if _is_dtensor(t)), None)
    sp = spmd_of(first)
    if sp is None:
        return fn(params, *batch, rows=None, **kwargs)
    if sp.sp > 1:
        raise ValueError(f"an 'sp' axis of size {sp.sp}: sequence "
                         f"parallelism is the GPT's (models/gpt.py); this "
                         f"model has none")
    whole = tree_map_with_path(lambda _p, t: sp.whole(t)
                               if isinstance(t, torch.Tensor) else t, params)
    local = [tree_map_with_path(lambda _p, t: local_rows(t), b)
             for b in batch]
    n = next(t for _p, t in tree_paths_and_leaves(local)
             if isinstance(t, torch.Tensor)).shape[0]
    out = fn(whole, *local, rows=(sp.batch_index * n, sp.batch_shards * n),
             **kwargs)

    def mean(v: torch.Tensor) -> torch.Tensor:
        return sp.batch_sum(v / sp.batch_shards)

    if isinstance(out, dict):
        return {k: mean(v) for k, v in out.items()}
    return mean(out)
