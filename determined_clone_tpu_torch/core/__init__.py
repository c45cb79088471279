"""Core API — the port's copy of ``determined_clone_tpu/core`` for one
rank off-cluster: ``init()``, the train, searcher, preempt and checkpoint
contexts, and the checkpoint serialization. The master-backed sources,
``init_unmanaged`` and multi-rank groups wait (``ROADMAP.md``)."""
from determined_clone_tpu_torch.core._checkpoint import (
    CheckpointContext,
    CheckpointCorruptError,
    CheckpointRegistry,
    LocalCheckpointRegistry,
    NullCheckpointRegistry,
    validate_checkpoint_dir,
    verify_manifest_digests,
)
from determined_clone_tpu_torch.core._context import Context, init
from determined_clone_tpu_torch.core._distributed import (
    DistributedContext,
    DistributedError,
)
from determined_clone_tpu_torch.core._preempt import (
    FilePreemptionSource,
    NeverPreempt,
    PreemptContext,
    PreemptMode,
    PreemptionSource,
)
from determined_clone_tpu_torch.core._searcher import (
    LocalSearcherSource,
    SearcherContext,
    SearcherOperation,
    SearcherOperationSource,
)
from determined_clone_tpu_torch.core._serialization import (
    load_pytree,
    save_pytree,
)
from determined_clone_tpu_torch.core._train import (
    LocalMetricsBackend,
    MetricsBackend,
    TrainContext,
)

__all__ = [
    "CheckpointContext",
    "CheckpointCorruptError",
    "CheckpointRegistry",
    "LocalCheckpointRegistry",
    "NullCheckpointRegistry",
    "validate_checkpoint_dir",
    "verify_manifest_digests",
    "Context",
    "init",
    "DistributedContext",
    "DistributedError",
    "FilePreemptionSource",
    "NeverPreempt",
    "PreemptContext",
    "PreemptMode",
    "PreemptionSource",
    "LocalSearcherSource",
    "SearcherContext",
    "SearcherOperation",
    "SearcherOperationSource",
    "load_pytree",
    "save_pytree",
    "LocalMetricsBackend",
    "MetricsBackend",
    "TrainContext",
]
