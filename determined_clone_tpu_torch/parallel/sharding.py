"""Partition specs as DTensor placements — the port of
``determined_clone_tpu/parallel/sharding.py``.

The rule logic is the JAX package's, copied as pure Python: ordered
(regex, PartitionSpec) rules, first match wins; leaves no rule matches
get the automatic ZeRO-3 spec (the largest fsdp-divisible dimension),
and axes of size 1 are dropped. A ``PartitionSpec`` here is a tuple of
entries (``None``, an axis name, or a tuple of axis names), as JAX's is,
so specs compare entry for entry with the JAX package's.

A spec becomes DTensor placements on a ``DeviceMesh`` with
:func:`placements_for`: the mesh dimension of each named axis gets
``Shard(d)``, every other ``Replicate()``. A tensor dimension sharded
over two axes, ``("dp", "fsdp")``, is split by dp first and each dp
block by fsdp — dp-major, as JAX splits it and as DTensor nests shards
in mesh order. :func:`shard_index` gives the rank's block of a global
tensor; ``shard_put`` builds each rank's DTensor from its own block of
a value every rank holds (no broadcast), ``constrain`` redistributes.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from determined_clone_tpu_torch.core._serialization import (
    tree_map_with_path,
    tree_paths_and_leaves,
)
from determined_clone_tpu_torch.parallel.mesh import axis_sizes


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: one entry per tensor dimension."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh — ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


@dataclasses.dataclass
class ShardingRules:
    """Ordered (regex, PartitionSpec) rules; first match wins.

    ``fsdp_axis`` enables the automatic ZeRO-3 fallback for unmatched leaves;
    set it to None for pure-TP or replicated layouts. ``mesh`` may be a
    DeviceMesh, a MeshSpec or a dict of axis sizes.
    """

    rules: Sequence[Tuple[str, PartitionSpec]] = ()
    fsdp_axis: Optional[str] = "fsdp"

    def spec_for(self, path: str, leaf: Any, mesh: Any) -> PartitionSpec:
        sizes = axis_sizes(mesh)
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                return _drop_trivial_axes(spec, sizes)
        if self.fsdp_axis and self.fsdp_axis in sizes:
            return _auto_fsdp_spec(leaf, sizes, self.fsdp_axis)
        return P()

    def shardings_for(self, tree: Any, mesh: Any) -> Any:
        """A tree of NamedShardings congruent with ``tree``."""
        return tree_map_with_path(
            lambda path, leaf: NamedSharding(
                mesh, self.spec_for(path, leaf, mesh)), tree)


def _trim(entries: Sequence[Any]) -> PartitionSpec:
    """Build a P with trailing Nones stripped (PartitionSpec('x', None) and
    PartitionSpec('x') shard identically but compare unequal)."""
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def _drop_trivial_axes(spec: PartitionSpec, sizes: dict) -> PartitionSpec:
    """Remove axes of size 1 from a spec, as the JAX package does."""
    def prune(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if sizes.get(a, 1) > 1)
            return kept if len(kept) > 1 else (kept[0] if kept else None)
        return entry if sizes.get(entry, 1) > 1 else None

    return _trim([prune(e) for e in spec])


def _auto_fsdp_spec(leaf: Any, sizes: dict, axis: str) -> PartitionSpec:
    """ZeRO-3 default policy: shard the largest dim divisible by the fsdp
    size; replicate small/indivisible leaves (biases, scalars, norms)."""
    n = sizes[axis]
    shape = tuple(getattr(leaf, "shape", ()))
    # Only matrix-shaped leaves are worth scattering; vectors (biases, norm
    # scales) are bandwidth-trivial and stay replicated.
    if n <= 1 or len(shape) < 2:
        return P()
    best_dim, best_size = -1, 0
    for i, s in enumerate(shape):
        if s % n == 0 and s > best_size:
            best_dim, best_size = i, s
    if best_dim < 0 or best_size < 2 * n:  # don't shard tiny leaves
        return P()
    entries: List[Any] = [None] * len(shape)
    entries[best_dim] = axis
    return _trim(entries)


def batch_spec(extra_dims: int = 0) -> PartitionSpec:
    """Sharding for data batches: leading batch dim split over (dp, fsdp) —
    fsdp ranks are data-parallel workers in ZeRO semantics."""
    return P(("dp", "fsdp"), *([None] * extra_dims))


def batch_seq_spec() -> PartitionSpec:
    """[batch, seq, ...] activations with the sequence dim over sp."""
    return P(("dp", "fsdp"), "sp")


def placements_for(spec: PartitionSpec, mesh: Any) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (one per mesh dim)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = (() if entry is None else
                tuple(entry) if isinstance(entry, (tuple, list)) else (entry,))
        idx = [names.index(a) for a in axes if mesh.size(names.index(a)) > 1]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of one dimension must "
                             f"follow the mesh order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses axis {names[i]!r} twice")
            out[i] = Shard(d)
    return tuple(out)


def shard_index(shape: Sequence[int], mesh: Any, placements: Sequence[Any]
                ) -> List[List[int]]:
    """[[start, stop], ...] of this rank's block of a tensor of global
    ``shape``: each sharding mesh dim, in mesh order, splits the range
    the earlier ones left. Raises for an indivisible dimension (JAX
    refuses those too)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    idx = [[0, int(s)] for s in shape]
    for md, pl in enumerate(placements):
        if not isinstance(pl, Shard):
            continue
        n = mesh.size(md)
        start, stop = idx[pl.dim]
        if (stop - start) % n:
            raise ValueError(f"dimension {pl.dim} of {tuple(shape)} does not "
                             f"divide over mesh axis "
                             f"{mesh.mesh_dim_names[md]!r} of size {n}")
        c = (stop - start) // n
        idx[pl.dim] = [start + coord[md] * c, start + (coord[md] + 1) * c]
    return idx


def replica_count(mesh: Any, placements: Sequence[Any]) -> int:
    """How many ranks hold each block: the product of the mesh dims the
    tensor is replicated over."""
    from torch.distributed.tensor import Shard

    return math.prod(mesh.size(i) for i, pl in enumerate(placements)
                     if not isinstance(pl, Shard))


def local_block(x: torch.Tensor, mesh: Any, placements: Sequence[Any]
                ) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` (a view)."""
    for d, (a, b) in enumerate(shard_index(x.shape, mesh, placements)):
        x = x.narrow(d, a, b - a)
    return x


def to_dtensor(x: torch.Tensor, sharding: NamedSharding):
    """The DTensor of global value ``x`` (the same on every rank) placed
    by ``sharding``: each rank keeps its own block, nothing is sent."""
    from torch.distributed.tensor import DTensor

    pl = sharding.placements
    # a tensor of its own, not a view of x: it becomes an autograd leaf
    local = local_block(x.detach(), sharding.mesh, pl).clone(
        memory_format=torch.contiguous_format)
    return DTensor.from_local(local, sharding.mesh, pl, run_check=False,
                              shape=tuple(x.shape), stride=_stride(x.shape))


def host_block(x: Any, sharding: NamedSharding) -> Any:
    """This rank's block of a host array of global shape (numpy)."""
    idx = shard_index(np.shape(x), sharding.mesh, sharding.placements)
    return x[tuple(slice(a, b) for a, b in idx)]


def from_block(local: torch.Tensor, sharding: NamedSharding):
    """The DTensor whose block on this rank is ``local`` (each sharded
    dimension of the global shape is the block's times its axes' sizes)."""
    from torch.distributed.tensor import DTensor, Shard

    pl = sharding.placements
    shape = list(local.shape)
    for md, p in enumerate(pl):
        if isinstance(p, Shard):
            shape[p.dim] *= sharding.mesh.size(md)
    return DTensor.from_local(local, sharding.mesh, pl, run_check=False,
                              shape=tuple(shape), stride=_stride(shape))


def _stride(shape: Sequence[int]) -> tuple:
    out, acc = [], 1
    for s in reversed(tuple(shape)):
        out.append(acc)
        acc *= int(s)
    return tuple(reversed(out))


def replicated(mesh: Any, tree: Any) -> Any:
    """NamedShardings that fully replicate ``tree``."""
    return tree_map_with_path(lambda _p, _l: NamedSharding(mesh, P()), tree)


def shard_put(tree: Any, shardings: Any) -> Any:
    """Every tensor leaf of ``tree`` as a DTensor on its sharding (a
    congruent tree of NamedShardings) — ``distribute_tensor``'s layout
    without its broadcast, since every rank holds the same value."""
    flat = dict(tree_paths_and_leaves(shardings, is_leaf=_is_sharding))
    return tree_map_with_path(
        lambda path, leaf: to_dtensor(leaf, flat[path])
        if isinstance(leaf, torch.Tensor) else leaf, tree)


def _is_sharding(node: Any) -> bool:
    return isinstance(node, NamedSharding)


def constrain(tree: Any, mesh: Any, spec: PartitionSpec) -> Any:
    """Every DTensor leaf redistributed to ``spec`` — the port's
    ``with_sharding_constraint``."""
    pl = placements_for(_drop_trivial_axes(spec, axis_sizes(mesh)), mesh)
    return tree_map_with_path(
        lambda _p, leaf: leaf.redistribute(mesh, pl)
        if hasattr(leaf, "redistribute") else leaf, tree)
