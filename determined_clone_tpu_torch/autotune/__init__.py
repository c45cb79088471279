"""Autotune — parallelism-config search (the DeepSpeed-Autotune analogue),
the port's copy of ``determined_clone_tpu/autotune``: a search over the
mesh factorization (dp/fsdp/tp/sp), rematerialization and per-card batch,
driven by measured throughput, either locally (``autotune`` with a
``measure`` such as ``gpt_bench.make_gpt_measure``) or as a cluster
experiment (a grid over generated candidates, ``samples_per_second``
maximized)."""
from determined_clone_tpu_torch.autotune.core import (
    AutotuneResult,
    autotune,
    make_autotune_experiment_config,
    mesh_candidates,
)

__all__ = [
    "AutotuneResult",
    "autotune",
    "make_autotune_experiment_config",
    "mesh_candidates",
]
