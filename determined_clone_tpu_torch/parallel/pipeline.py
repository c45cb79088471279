"""Pipeline parallelism over the mesh's ``pp`` axis — GPipe microbatching;
the port of ``determined_clone_tpu/parallel/pipeline.py``.

Model blocks keep their stacked ``[L, ...]`` leading layer dim and that
dim is split over ``pp`` (``pipeline_stage_spec``); each rank runs its
stage's L/P layers. Where the JAX package rotates activations with
``lax.ppermute`` inside a ``shard_map`` that is manual over ``pp`` only,
the port's ranks send them to the next stage with point-to-point
transfers (``SpmdContext.shift``: one ``batch_isend_irecv`` per tick
whose backward sends the gradients back). Every other axis keeps its own
collectives, placed by the stage function.

Schedule: GPipe. For M microbatches and P stages the loop runs M + P - 1
ticks; at tick t stage s works on microbatch t - s when that is in
range. Stage 0 takes a fresh microbatch, the others what the stage
before sent at the previous tick; only the last stage's outputs are
kept, and the result is replicated over ``pp`` (a sum of the outputs
masked to the last stage). Two departures from the JAX loop: a stage
computes nothing on the ticks where it has no microbatch (the JAX scan
runs every stage on every tick and discards the idle ticks' results,
so the numbers are the same), and the carrier travels in its own dtype
(the JAX loop widens it to fp32 on the CPU, around an XLA bug).
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

from determined_clone_tpu_torch.core._serialization import (
    tree_map_with_path,
    tree_paths_and_leaves,
)
from determined_clone_tpu_torch.parallel.sharding import P, PartitionSpec
from determined_clone_tpu_torch.parallel.spmd import (
    SpmdContext,
    local_tensor,
    split_over,
)

StageFn = Callable[[Any, Any], Any]


def _keystr(path: str) -> str:
    """A tree path as ``jax.tree_util.keystr`` prints it."""
    return "".join(f"[{int(k)}]" if k.isdigit() else f"[{k!r}]"
                   for k in path.split("/"))


def pipeline_stage_spec() -> PartitionSpec:
    """PartitionSpec for stacked-layer params entering the pipeline: the
    leading [L] layer dim is split over pp into per-stage slices."""
    return P("pp")


def pipeline_apply(stage_fn: StageFn, stacked_params: Any, x: Any, *,
                   mesh: Any, num_microbatches: int,
                   axis_name: str = "pp") -> Any:
    """Run carrier ``x`` through all pipeline stages of a stacked-layer
    model.

    ``stage_fn(local_params, x_mb) -> y_mb`` applies ONE stage's layers:
    it receives the stage's slice of ``stacked_params`` and one
    microbatch of the carrier, and must keep the carrier's structure,
    shapes and dtypes (side outputs such as MoE aux losses ride along as
    extra leaves with a leading batch dim).

    ``stacked_params`` is a tree whose every leaf has a leading layer dim
    divisible by the pp size. A DTensor leaf split over pp on that dim
    reaches ``stage_fn`` as it is: its local tensor is the stage's
    layers (``SpmdContext.local(..., index=j)`` reads layer j of them
    and gathers its other sharded dims). A plain tensor leaf holds all
    L layers on every rank and is cut to the stage's block, its gradient
    summed over pp; so is a DTensor leaf not split over pp, after it is
    gathered whole over the axes that shard it (its stage block reaches
    ``stage_fn`` as a plain tensor). ``x`` is this rank's carrier (its
    rows of the batch), a tree whose every leaf has a leading batch dim
    divisible by ``num_microbatches``; microbatch m is the m-th block of
    those rows.

    ``mesh`` is the DeviceMesh; at pp size 1 ``stage_fn`` runs directly
    on all of ``x``.
    """
    sp = SpmdContext(mesh)
    n_stages = sp.sizes.get(axis_name, 1)
    if n_stages == 1:
        return stage_fn(stacked_params, x)
    M = num_microbatches
    for path, leaf in tree_paths_and_leaves(x):
        if leaf.dim() == 0:
            raise ValueError(
                f"carrier leaf {_keystr(path)} is 0-d; every carrier leaf needs "
                f"a leading batch dim to split into microbatches (carry "
                f"scalars as [B]-shaped rows instead)")
        if leaf.shape[0] % M != 0:
            raise ValueError(
                f"carrier leaf batch dim {leaf.shape[0]} not divisible by "
                f"num_microbatches={M}")
    stage = sp.coord[axis_name]

    def stage_slice(path: str, leaf: Any) -> Any:
        n = leaf.shape[0]
        if n % n_stages:
            raise ValueError(
                f"stacked leaf {_keystr(path)} has {n} layers, not divisible by "
                f"the {axis_name!r} axis size {n_stages}")
        if split_over(leaf, axis_name, 0):
            return leaf
        # a DTensor not split over pp is made whole over the axes that
        # shard it (its gradient summed back onto its shard) and cut like
        # a plain tensor, as the JAX program reshards the stack
        return sp.copy_to(sp.whole(leaf), axis_name).chunk(n_stages,
                                                           0)[stage]

    local = tree_map_with_path(stage_slice, stacked_params)
    # stage 0 alone reads the input: summing its cotangent over pp gives
    # every rank the input's gradient, as a replicated input's transpose
    x = tree_map_with_path(lambda _p, a: sp.copy_to(a, axis_name), x)
    paths, leaves = zip(*tree_paths_and_leaves(x))
    mbs = [a.chunk(M, 0) for a in leaves]

    def carrier(flat: List[torch.Tensor]) -> Any:
        by_path = dict(zip(paths, flat))
        return tree_map_with_path(lambda p, _a: by_path[p], x)

    # A rank whose half of a shift is missing (nothing to send, or
    # nothing received) still needs the shift in its autograd graph, on a
    # path to a parameter: its backward carries the neighbour's gradient.
    # Templates hang off a parameter (times 0), and unread outputs join
    # the result (times 0).
    grads = [local_tensor(t) for _p, t in tree_paths_and_leaves(local)
             if local_tensor(t).requires_grad] + [
                 a for a in leaves if a.requires_grad]
    seed = (grads[0].reshape(-1)[:1].sum() * 0.0) if grads else None
    dangling: List[torch.Tensor] = [] if stage == 0 else list(leaves)

    def template() -> List[torch.Tensor]:
        zs = [torch.zeros_like(m[0]) for m in mbs]
        if seed is None:
            return zs
        return [z + seed.to(z.dtype) if z.is_floating_point() else z
                for z in zs]

    def active(s: int, t: int) -> bool:
        return 0 <= t - s < M

    recv: List[torch.Tensor] = []
    outs: List[List[torch.Tensor]] = []
    for t in range(M + n_stages - 1):
        out = None
        if active(stage, t):
            inp = [m[t] for m in mbs] if stage == 0 else recv
            y = stage_fn(local, carrier(inp))
            out = [a for _p, a in tree_paths_and_leaves(y)]
            if stage == n_stages - 1:
                outs.append(out)
        send = out is not None and stage < n_stages - 1
        take = stage > 0 and active(stage - 1, t)
        if send or take:
            got = list(sp.shift(out if send else template(), axis_name,
                                 send=send, recv=take))
            if take:
                recv = got
            else:
                dangling += got
    if stage == n_stages - 1:
        mine = [torch.cat(parts, 0) for parts in zip(*outs)]
    else:
        mine = [torch.zeros_like(a) for a in leaves]
    tied = [a.reshape(-1)[:1].sum() * 0.0 for a in dangling
            if a.requires_grad]
    if tied:   # on every output leaf: the caller may read any of them
        tie = sum(tied)
        mine = [a + tie.to(a.dtype) if a.is_floating_point() else a
                for a in mine]
    # the last stage's outputs, replicated: the backward passes the loss's
    # cotangent to the last stage once (identity), not once per rank
    return carrier([sp.reduce_from(a, axis_name) for a in mine])


def pipeline_bubble_fraction(num_microbatches: int, n_stages: int) -> float:
    """Idle fraction of the GPipe schedule — exposed for the autotuner."""
    return (n_stages - 1) / (num_microbatches + n_stages - 1)
