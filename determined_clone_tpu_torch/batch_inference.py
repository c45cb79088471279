"""Sharded offline batch processing with checkpointed progress — the
port's copy of ``determined_clone_tpu/batch_inference.py``
(``jax_batch_process`` becomes :func:`torch_batch_process`).

Split a dataset across the gang, run a user-defined processor over its
batches, checkpoint progress so a preempted or restarted job resumes
where it left off, and cooperate with preemption. The processor gets the
whole Core API context; rank r owns batches r, r+size, ...

    class Embedder(BatchProcessor):
        def __init__(self, context):
            super().__init__(context)
            self.params = gpt.init(gen, cfg)      # on the card
        @torch.no_grad()
        def process_batch(self, batch, batch_idx):
            out = gpt.apply(self.params, cfg, batch.cuda())
            ...write out...

    torch_batch_process(Embedder, dataset, batch_size=32,
                        checkpoint_interval=10)

The progress checkpoints are the JAX package's (the merged per-rank
high-water marks in ``metadata.json``, a ``progress-rank-<r>.txt`` file
per rank), so either package resumes the other's run.
"""
from __future__ import annotations

import contextlib
import logging
import math
from typing import Any, Dict, Optional, Sequence, Type

from determined_clone_tpu_torch import core

logger = logging.getLogger(__name__)

# warn-once guard for dropped-example reporting (the trainer's
# eval_examples_dropped contract): the counter is always exact in the
# summary and the metric, the log line fires once per process
_dropped_warned = False


class BatchProcessor:
    """User subclass. Override process_batch; the hooks are optional."""

    def __init__(self, context: "core.Context") -> None:
        self.context = context

    def process_batch(self, batch: Any, batch_idx: int) -> None:
        raise NotImplementedError

    def on_checkpoint_start(self) -> None:
        """Called before each progress checkpoint (flush outputs here)."""

    def on_finish(self) -> None:
        """Called once after this rank's final batch."""


def _progress_key(rank: int) -> str:
    return f"rank_{rank}_batches_completed"


def torch_batch_process(
    processor_cls: Type[BatchProcessor],
    dataset: Sequence[Any],
    *,
    batch_size: int = 1,
    checkpoint_interval: int = 10,
    core_context: Optional["core.Context"] = None,
    latest_checkpoint: Optional[str] = None,
    max_batches: Optional[int] = None,
) -> Dict[str, Any]:
    """Run the processor over the dataset; returns a summary dict.

    ``dataset`` needs ``len()`` and slicing (a list, an array, a tensor).
    Progress is checkpointed every ``checkpoint_interval`` batches per
    rank (each rank reports its own high-water mark, merged by the
    chief); pass the returned ``storage_id`` back as ``latest_checkpoint``
    to resume, skipping the batches already done.
    """
    with contextlib.ExitStack() as stack:
        ctx = core_context
        if ctx is None:
            ctx = stack.enter_context(core.init())
        dist = ctx.distributed
        rank, size = dist.rank, dist.size

        n_batches = math.ceil(len(dataset) / batch_size)
        if max_batches is not None:
            n_batches = min(n_batches, max_batches)
        # examples beyond the planned batch range are dropped (max_batches
        # clips the tail, on a fresh run or a resume whose plan tightened):
        # counted exactly, warned once
        examples_dropped = max(0, len(dataset) - n_batches * batch_size)

        # resume: skip this rank's completed batches. The sharding
        # arithmetic only lines up if batch_size and the gang size match
        # the original run — shifted boundaries would drop or duplicate
        # data.
        completed = 0
        if latest_checkpoint:
            meta = ctx.checkpoint.get_metadata(latest_checkpoint)
            old_bs = meta.get("batch_size")
            if old_bs is not None and int(old_bs) != batch_size:
                raise ValueError(
                    f"resume batch_size {batch_size} != checkpointed "
                    f"{old_bs}; progress indices would not line up")
            old_size = meta.get("world_size")
            if old_size is not None and int(old_size) != size:
                raise ValueError(
                    f"resume world size {size} != checkpointed {old_size}; "
                    f"per-rank progress would map to different data")
            completed = int(meta.get(_progress_key(rank), 0))

        processor = processor_cls(ctx)
        processed = completed
        storage_id: Optional[str] = latest_checkpoint
        preempted = False
        since_ckpt = 0

        def save_progress() -> Optional[str]:
            # COLLECTIVE: metadata.json is chief-written, so per-rank
            # progress is allgathered and the chief persists the merge
            processor.on_checkpoint_start()
            merged: Dict[str, Any] = {"batch_size": batch_size,
                                      "world_size": size,
                                      "n_batches": n_batches}
            for d in dist.allgather({_progress_key(rank): processed}):
                merged.update(d)
            with ctx.checkpoint.store_path(
                metadata=merged, shard=size > 1,
            ) as (path, holder):
                # progress lives in the metadata; the marker file keeps a
                # single-rank save from being empty
                with open(f"{path}/progress-rank-{rank}.txt", "w") as f:
                    f.write(str(processed))
            return holder.get("storage_id")

        # every rank runs the SAME trip count even when n_batches % size
        # != 0: save_progress and should_preempt are collectives
        steps = math.ceil(n_batches / size)
        for local_pos in range(steps):
            idx = rank + local_pos * size
            if local_pos >= completed and idx < n_batches:
                lo = idx * batch_size
                batch = dataset[lo:min(lo + batch_size, len(dataset))]
                processor.process_batch(batch, idx)
                processed += 1
            since_ckpt += 1

            if since_ckpt >= checkpoint_interval:
                storage_id = save_progress() or storage_id
                since_ckpt = 0
            if ctx.preempt.should_preempt():  # chief-coordinated: the
                preempted = True              # same answer on every rank
                break

        if since_ckpt > 0 or preempted:
            storage_id = save_progress() or storage_id
        if not preempted:
            processor.on_finish()

        if examples_dropped:
            global _dropped_warned
            if not _dropped_warned:
                _dropped_warned = True
                logger.warning(
                    "batch inference dropped %d examples outside the "
                    "processed batch range (max_batches clipping or a "
                    "shrunken dataset on resume); raise max_batches or "
                    "re-run without a stale checkpoint for full coverage",
                    examples_dropped)
            tel = getattr(ctx, "telemetry", None)
            if tel is not None and getattr(tel, "registry", None) is not None:
                tel.registry.gauge(
                    "batch_inference_examples_dropped",
                    "examples outside the processed batch range this run "
                    "(max_batches clipping / shrunken dataset on resume)"
                ).set(examples_dropped)

        return {
            "rank": rank,
            "batches_processed": processed,
            "total_batches": n_batches,
            "examples_dropped": examples_dropped,
            "preempted": preempted,
            "storage_id": storage_id,
        }
