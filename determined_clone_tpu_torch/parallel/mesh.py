"""Device meshes — the port of ``determined_clone_tpu/parallel/mesh.py``.

Every parallelism strategy is an axis of one mesh, a
``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=AXES`` over the ranks of the initialised
``torch.distributed`` world (one rank per card, ``exec/launch.py``):

  axis   meaning
  -----  ---------------------------------------------
  dp     data parallel (batch split)
  fsdp   fully-sharded data parallel (ZeRO-3)
  tp     tensor (megatron) parallel
  pp     pipeline parallel
  sp     sequence/context parallel
  ep     expert parallel (MoE)

Unused axes keep size 1, so one PartitionSpec vocabulary works at every
scale. Ranks fill the mesh in row-major order over ``AXES``, as the JAX
package reshapes its device list, so rank ``r`` of the port holds the
shards of device ``r`` of the JAX mesh. ``MeshSpec`` is copied unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

# Canonical axis order. dp and fsdp are outermost (gradient/param reduction
# scopes ride DCN across hosts if they must); tp/sp innermost (highest-traffic
# collectives stay on ICI neighbors).
AXES: Tuple[str, ...] = ("dp", "fsdp", "pp", "ep", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. -1 for at most one axis means "absorb remaining
    devices" (like a -1 in a reshape)."""

    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1

    def axis_sizes(self) -> Tuple[int, ...]:
        return (self.dp, self.fsdp, self.pp, self.ep, self.sp, self.tp)

    def resolve(self, n_devices: int) -> "MeshSpec":
        """Fill in the -1 axis given a device count; validate the product."""
        sizes = list(self.axis_sizes())
        wild = [i for i, s in enumerate(sizes) if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {self}")
        fixed = math.prod(s for s in sizes if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"cannot fit mesh {self} on {n_devices} devices: fixed axes "
                    f"product {fixed} does not divide {n_devices}"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {self} wants {fixed} devices but {n_devices} are available"
            )
        for name, s in zip(AXES, sizes):
            if s < 1:
                raise ValueError(f"mesh axis {name} must be >= 1, got {s}")
        return MeshSpec(*sizes)

    @staticmethod
    def from_dict(d: dict) -> "MeshSpec":
        unknown = set(d) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; valid: {AXES}")
        return MeshSpec(**{k: int(v) for k, v in d.items()})

    def to_dict(self) -> dict:
        return {a: s for a, s in zip(AXES, self.axis_sizes())}


def _mesh_of(device_type: str, ranks: np.ndarray):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, ranks.tolist(), mesh_dim_names=AXES)


def _world_ranks(ranks: Optional[Sequence[int]]) -> list:
    import torch.distributed as dist

    if ranks is None:
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised (start "
                               "the ranks with exec/launch.py)")
        return list(range(dist.get_world_size()))
    return [int(r) for r in ranks]


def default_device_type() -> str:
    """``cuda`` for an NCCL world, else ``cpu``."""
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(spec: Optional[MeshSpec] = None,
              ranks: Optional[Sequence[int]] = None, *,
              device_type: Optional[str] = None):
    """A DeviceMesh over ``ranks`` (default: the whole world) reshaped
    row-major to ``spec``'s axis sizes — ``jax.sharding.Mesh`` over the
    device list ``make_mesh`` reshapes, rank for device."""
    ranks = _world_ranks(ranks)
    spec = (spec or MeshSpec()).resolve(len(ranks))
    arr = np.asarray(ranks).reshape(spec.axis_sizes())
    return _mesh_of(device_type or default_device_type(), arr)


def make_multislice_mesh(ici_spec: MeshSpec, dcn_spec: MeshSpec,
                         ranks: Optional[Sequence[int]] = None, *,
                         device_type: Optional[str] = None):
    """The hybrid mesh of the JAX package: ``ici_spec`` factorises the
    ranks within one slice (here: one host's cards), ``dcn_spec`` across
    slices, and each combined axis is slice-major — the same rank order
    as the JAX function's device order. Ranks must enumerate
    slice-major."""
    ranks = _world_ranks(ranks)
    if any(s == -1 for s in dcn_spec.axis_sizes()):
        raise ValueError("dcn_spec must be fully specified (no -1 axes)")
    n_slices = math.prod(dcn_spec.axis_sizes())
    if len(ranks) % n_slices != 0:
        raise ValueError(
            f"{len(ranks)} devices do not split into {n_slices} slices")
    ici = ici_spec.resolve(len(ranks) // n_slices)
    dcn_sizes, ici_sizes = dcn_spec.axis_sizes(), ici.axis_sizes()
    arr = np.asarray(ranks).reshape(*dcn_sizes, *ici_sizes)
    n = len(AXES)
    order = [j for i in range(n) for j in (i, n + i)]
    combined = tuple(d * s for d, s in zip(dcn_sizes, ici_sizes))
    return _mesh_of(device_type or default_device_type(),
                    arr.transpose(order).reshape(combined))


def single_device_mesh(device_type: Optional[str] = None):
    """A 1×1×…×1 mesh over this rank alone: the same code path unsharded
    (the single-slot trial)."""
    import torch.distributed as dist

    return make_mesh(MeshSpec(dp=1), [dist.get_rank()],
                     device_type=device_type)


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh, a MeshSpec or a dict of sizes — the
    JAX ``mesh.shape``; a spec's -1 axis counts as 1 until resolved."""
    if isinstance(mesh, MeshSpec):
        return {a: max(s, 1) for a, s in mesh.to_dict().items()}
    if isinstance(mesh, dict):
        return {a: int(mesh.get(a, 1)) for a in AXES}
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def mesh_axis_size(mesh: Any, *axes: str) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes.get(a, 1) for a in axes)


def data_parallel_submesh_size(mesh: Any) -> int:
    """Total batch-sharding degree: dp × fsdp (fsdp shards the batch too —
    ZeRO semantics: data-parallel gradients, sharded params/optimizer)."""
    return mesh_axis_size(mesh, "dp", "fsdp")
