"""core.Context and core.init() — the Core API entry point; the port's
copy of ``determined_clone_tpu/core/_context.py``.

``init()`` bundles the distributed, train, checkpoint, preempt and
searcher contexts. Off-cluster every component gets its local form: one
rank, checkpoints in the config's storage (or a temporary directory),
metrics in memory (or a JSONL file), preemption from a flag file named by
``DCT_PREEMPT_FILE``, and one searcher operation to
``searcher.max_length``. A config ``faults:`` block, or else
``DCT_FAULT_PLAN``, activates a fault plan. ``telemetry``, ``profiler``
and ``tensorboard`` stay None: the port has no telemetry yet
(``observability.enabled`` raises in the config), and a caller may set
``profiler`` to an object with the JAX package's ``record_batch_timing``
method, which the trainer calls once per chunk.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Any, Iterator, Optional

from determined_clone_tpu_torch import faults as faults_mod
from determined_clone_tpu_torch.config.experiment import (
    CheckpointStorageConfig,
    ExperimentConfig,
)
from determined_clone_tpu_torch.core._checkpoint import (
    CheckpointContext,
    LocalCheckpointRegistry,
)
from determined_clone_tpu_torch.core._distributed import DistributedContext
from determined_clone_tpu_torch.core._preempt import (
    FilePreemptionSource,
    NeverPreempt,
    PreemptContext,
    PreemptionSource,
)
from determined_clone_tpu_torch.core._searcher import (
    LocalSearcherSource,
    SearcherContext,
    SearcherOperationSource,
)
from determined_clone_tpu_torch.core._train import (
    LocalMetricsBackend,
    MetricsBackend,
    TrainContext,
)
from determined_clone_tpu_torch.storage import base as storage_base


class Context:
    def __init__(self, *, distributed: DistributedContext, train: TrainContext,
                 checkpoint: CheckpointContext, preempt: PreemptContext,
                 searcher: SearcherContext,
                 info: Optional[Any] = None) -> None:
        self.distributed = distributed
        self.train = train
        self.checkpoint = checkpoint
        self.preempt = preempt
        self.searcher = searcher
        self.info = info
        self.profiler: Optional[Any] = None
        self.tensorboard: Optional[Any] = None
        self.telemetry: Optional[Any] = None

    def close(self) -> None:
        self.preempt.close()
        self.distributed.close()

    def __enter__(self) -> "Context":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@contextlib.contextmanager
def init(
    *,
    config: Optional[ExperimentConfig] = None,
    distributed: Optional[DistributedContext] = None,
    storage_path: Optional[str] = None,
    metrics_backend: Optional[MetricsBackend] = None,
    preemption_source: Optional[PreemptionSource] = None,
    searcher_source: Optional[SearcherOperationSource] = None,
    checkpoint_registry: Optional[Any] = None,
    trial_id: Optional[int] = None,
) -> Iterator[Context]:
    """Build a Context. With no arguments this is fully local: single rank,
    tmpdir checkpoint storage, in-memory metrics — the unmanaged mode."""
    config = config or ExperimentConfig.from_dict({})
    dist = distributed or DistributedContext.single()

    # a config `faults:` block wins; otherwise DCT_FAULT_PLAN. Config plans
    # are cached by payload so counters survive restart legs.
    fault_plan = None
    if (config.faults is not None and config.faults.enabled
            and config.faults.rules):
        fault_plan = faults_mod.activate_from_config(
            {"seed": config.faults.seed, "rules": config.faults.rules})
    elif faults_mod.active_plan() is None:
        faults_mod.install_from_env()

    cleanup_dir: Optional[tempfile.TemporaryDirectory] = None
    if config.checkpoint_storage is not None:
        storage = storage_base.build(config.checkpoint_storage)
        registry_base = (config.checkpoint_storage.host_path
                         or config.checkpoint_storage.container_path or ".")
    else:
        if storage_path is None:
            cleanup_dir = tempfile.TemporaryDirectory(prefix="dct-ckpt-")
            storage_path = cleanup_dir.name
        storage = storage_base.build(
            CheckpointStorageConfig(type="shared_fs", host_path=storage_path))
        registry_base = storage_path

    registry = checkpoint_registry or LocalCheckpointRegistry(
        os.path.join(registry_base, "checkpoints.jsonl"))
    checkpoint = CheckpointContext(dist, storage, registry, trial_id=trial_id)

    train = TrainContext(
        metrics_backend or LocalMetricsBackend(),
        is_chief=dist.is_chief,
        metric=config.searcher.metric,
        smaller_is_better=config.searcher.smaller_is_better,
    )

    source = preemption_source
    if source is None:
        flag = os.environ.get("DCT_PREEMPT_FILE")
        source = FilePreemptionSource(flag) if flag else NeverPreempt()
    preempt = PreemptContext(dist, source).start()

    if searcher_source is None:
        searcher_source = LocalSearcherSource(config.searcher.max_length)
    searcher = SearcherContext(searcher_source, is_chief=dist.is_chief)

    ctx = Context(distributed=dist, train=train, checkpoint=checkpoint,
                  preempt=preempt, searcher=searcher)
    try:
        yield ctx
    finally:
        if fault_plan is not None:
            faults_mod.deactivate(fault_plan)
        ctx.close()
        if cleanup_dir is not None:
            cleanup_dir.cleanup()
