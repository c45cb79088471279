"""Parallelism: meshes, partition specs and the GPipe pipeline — the
port of ``determined_clone_tpu/parallel``. ``spmd`` holds the per-rank
collectives the JAX package leaves to XLA's partitioner;
``scaling_bench`` (run as a module) measures scaling over ranks.
"""
from determined_clone_tpu_torch.parallel.mesh import (
    AXES,
    MeshSpec,
    data_parallel_submesh_size,
    make_mesh,
    make_multislice_mesh,
    mesh_axis_size,
    single_device_mesh,
)
from determined_clone_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_bubble_fraction,
    pipeline_stage_spec,
)
from determined_clone_tpu_torch.parallel.sharding import (
    NamedSharding,
    P,
    PartitionSpec,
    ShardingRules,
    batch_seq_spec,
    batch_spec,
    constrain,
    placements_for,
    replicated,
    shard_put,
    tree_paths_and_leaves,
)

__all__ = [
    "AXES",
    "MeshSpec",
    "data_parallel_submesh_size",
    "make_mesh",
    "make_multislice_mesh",
    "mesh_axis_size",
    "single_device_mesh",
    "pipeline_apply",
    "pipeline_bubble_fraction",
    "pipeline_stage_spec",
    "NamedSharding",
    "P",
    "PartitionSpec",
    "ShardingRules",
    "batch_spec",
    "batch_seq_spec",
    "constrain",
    "placements_for",
    "replicated",
    "shard_put",
    "tree_paths_and_leaves",
]
