"""core.Context and core.init() — the Core API entry point; the port's
copy of ``determined_clone_tpu/core/_context.py``.

``init()`` bundles the distributed, train, checkpoint, preempt and
searcher contexts. Off-cluster every component gets its local form: one
rank unless ``distributed`` is given (``exec/launch.py``'s
``init_from_env()`` returns the rank's context), checkpoints in the config's storage (or a temporary directory),
metrics in memory (or a JSONL file), preemption from a flag file named by
``DCT_PREEMPT_FILE``, and one searcher operation to
``searcher.max_length``. A config ``faults:`` block, or else
``DCT_FAULT_PLAN``, activates a fault plan.

``telemetry`` is built first, as in the JAX package, from the config's
``observability:`` block (``telemetry.telemetry_from_config``; None when
it is off): its goodput ledger takes the trial id (the journal's file is
named by it), and its registry goes to the fault plan and the preemption
watcher. On exit the Chrome trace is written when ``trace_path`` is set
and the telemetry closed (the flight segment and the goodput journal
flushed). ``profiler`` and ``tensorboard`` stay None; a caller may set
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
from determined_clone_tpu_torch.telemetry import telemetry_from_config


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

    # telemetry first: the preemption watcher and the fault plan want its
    # registry (None when observability is off)
    telemetry = telemetry_from_config(config)
    registry_arg = telemetry.registry if telemetry is not None else None
    if (telemetry is not None and telemetry.goodput is not None
            and trial_id is not None):
        # the goodput journal file is named by trial id, so identity must
        # land before the ledger's first durable write (first publish)
        telemetry.goodput.set_identity(trial_id=trial_id)

    # a config `faults:` block wins; otherwise DCT_FAULT_PLAN. Config plans
    # are cached by payload so counters survive restart legs.
    fault_plan = None
    if (config.faults is not None and config.faults.enabled
            and config.faults.rules):
        fault_plan = faults_mod.activate_from_config(
            {"seed": config.faults.seed, "rules": config.faults.rules},
            registry=registry_arg)
    elif faults_mod.active_plan() is None:
        faults_mod.install_from_env()

    cleanup_dir: Optional[tempfile.TemporaryDirectory] = None
    if config.checkpoint_storage is not None:
        storage = storage_base.build(config.checkpoint_storage)
        registry_base = (config.checkpoint_storage.host_path
                         or config.checkpoint_storage.container_path or ".")
    else:
        if storage_path is None:
            if dist.size > 1:
                raise ValueError(
                    f"{dist.size} ranks need one checkpoint storage: pass "
                    f"storage_path or set checkpoint_storage")
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
    preempt = PreemptContext(dist, source, registry=registry_arg).start()

    if searcher_source is None:
        searcher_source = LocalSearcherSource(config.searcher.max_length)
    searcher = SearcherContext(searcher_source, is_chief=dist.is_chief)

    ctx = Context(distributed=dist, train=train, checkpoint=checkpoint,
                  preempt=preempt, searcher=searcher)
    ctx.telemetry = telemetry
    try:
        yield ctx
    finally:
        try:
            if ctx.telemetry is not None and ctx.telemetry.trace_path:
                ctx.telemetry.export_chrome_trace()
        finally:
            if ctx.telemetry is not None:
                ctx.telemetry.close()
            if fault_plan is not None:
                faults_mod.deactivate(fault_plan)
            ctx.close()
            if cleanup_dir is not None:
                cleanup_dir.cleanup()
