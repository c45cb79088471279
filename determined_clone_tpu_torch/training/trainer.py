"""Trainer — the training loop; the port of
``determined_clone_tpu/training/trainer.py``.

The loop has the JAX loop's shape: train in ``scheduling_unit`` chunks
per searcher operation, report training metrics once per chunk (one host
sync, ``MetricAccumulator.result()``), validate and checkpoint on their
period boundaries, cooperate with preemption, save a final checkpoint,
and on restore replay the data stream to the batch after the last one
trained. Checkpoints are the JAX package's (``core/_serialization.py``),
so a run may resume in either package from the other's checkpoint.

Hot-loop options (config ``optimizations:`` block):

- **Prefetch** (``prefetch_depth``, default 2): a background thread pulls
  host batches and starts their copies to the card (pinned memory, a side
  stream) into a bounded queue of ``prefetch_depth * steps_per_dispatch``
  batches; the step's stream waits on each copy's event. Depth 0 copies
  inline.
- **Fused dispatch** (``steps_per_dispatch=k``): k batches per call of
  the k-step train step, their metrics summed on the device. Chunk and
  target remainders smaller than k use the single step, so the batch
  order and the per-step seeds are those of the unfused loop.

Seeds: the params are drawn from a generator seeded with
``fold_seed(experiment_seed, 0)``, the state's seed is
``fold_seed(experiment_seed, 1)`` and validation's
``fold_seed(experiment_seed, 2)`` — the port's counterparts of the JAX
loop's split and ``fold_in`` of ``PRNGKey(experiment_seed)``; the random
streams themselves differ between the frameworks.

The JAX loop's telemetry branch (spans, the XLA compile capture, the
anomaly detector, the MFU gauges, the device memory monitor) waits for
the port's telemetry (``ROADMAP.md``); ``core.telemetry`` is always None
here.
"""
from __future__ import annotations

import functools
import json
import logging
import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from determined_clone_tpu_torch import faults
from determined_clone_tpu_torch.config.length import Length
from determined_clone_tpu_torch.core._checkpoint import CheckpointCorruptError
from determined_clone_tpu_torch.core._serialization import (
    load_pytree,
    save_pytree,
)
from determined_clone_tpu_torch.ops.layers import fold_seed
from determined_clone_tpu_torch.training.metrics import MetricAccumulator
from determined_clone_tpu_torch.training.optim import leaves
from determined_clone_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from determined_clone_tpu_torch.training.trial import TorchTrial
from determined_clone_tpu_torch.utils.data import (
    CudaStager,
    batch_leaves,
    batch_to_device,
    make_device_feeder,
)

CKPT_STATE_DIR = "state"

logger = logging.getLogger(__name__)


def _skip_batches(it: Iterator[Any], n: int) -> int:
    """Fast-forward ``n`` batches of ``it``; returns how many were skipped
    (< n once exhausted). Iterators exposing ``skip_batches`` (e.g.
    ``utils.data.BatchIterator``) skip by index arithmetic; anything else
    falls back to materialize-and-discard."""
    if n <= 0:
        return 0
    fast = getattr(it, "skip_batches", None)
    if fast is not None:
        return int(fast(n))
    skipped = 0
    while skipped < n:
        try:
            next(it)
        except StopIteration:
            break
        skipped += 1
    return skipped


class Trainer:
    def __init__(self, trial: TorchTrial) -> None:
        self.trial = trial
        self.config = trial.context.config
        self.core = trial.context.core
        self.device = trial.context.device

    # -- length resolution --------------------------------------------------

    def _to_batches(self, length: Optional[Any], default: int = 0) -> int:
        if length is None:
            return default
        if isinstance(length, int):
            return length
        if isinstance(length, Length):
            return length.to_batches(
                self.trial.global_batch_size, self.config.records_per_epoch)
        raise TypeError(f"cannot resolve training length {length!r}")

    # -- checkpoint save/restore -------------------------------------------

    def _save(self, state: TrainState, batches_trained: int,
              reason: str, metric=None) -> str:
        """Write the state and upload it as one committed checkpoint.
        ``metric`` is the searcher metric at save time, when validation
        ran at this batch count."""
        faults.point("training.checkpoint_save")
        metadata = {
            "steps_completed": batches_trained,
            "reason": reason,
            "global_batch_size": self.trial.global_batch_size,
        }
        if metric is not None:
            metadata["validation_metric"] = float(metric)
        with self.core.checkpoint.store_path(metadata=metadata) as (path,
                                                                    holder):
            save_pytree(f"{path}/{CKPT_STATE_DIR}", state)
        return holder.get("storage_id", "")

    def _restore(self, storage_id: str, like: TrainState) -> tuple:
        """Restore with fallback: a checkpoint refused by commit-protocol
        validation (crash mid-upload, torn write) falls back through the
        registry's committed checkpoints, newest first."""
        ck = self.core.checkpoint
        candidates = [storage_id] + [
            sid for sid in ck.committed_checkpoints() if sid != storage_id]
        first_err: Optional[CheckpointCorruptError] = None
        for sid in candidates:
            try:
                return self._restore_one(sid, like)
            except CheckpointCorruptError as e:
                if first_err is None:
                    first_err = e
                logger.warning(
                    "checkpoint %s refused (%s); falling back to the "
                    "previous committed checkpoint", sid, e.reason)
        raise first_err if first_err is not None else RuntimeError(
            f"no restorable checkpoint for {storage_id}")

    def _restore_one(self, storage_id: str, like: TrainState) -> tuple:
        with self.core.checkpoint.restore_path(storage_id) as path:
            state = load_pytree(f"{path}/{CKPT_STATE_DIR}", like)
            mpath = f"{path}/metadata.json"
            meta: dict = {}
            if os.path.exists(mpath):
                with open(mpath) as f:
                    meta = json.load(f)
        for p in leaves(state.params):
            p.requires_grad_(True)
        return state, int(meta.get("steps_completed", 0))

    # -- the loop -----------------------------------------------------------

    def fit(self, latest_checkpoint: Optional[str] = None) -> Dict[str, Any]:
        try:
            return self._fit_inner(latest_checkpoint)
        except BaseException:
            # join local uploads without publishing anything (none is in
            # flight in the port: its saves are synchronous); the error
            # stays primary
            self.core.checkpoint.abort_async()
            raise

    def _fit_inner(self, latest_checkpoint: Optional[str] = None
                   ) -> Dict[str, Any]:
        trial, config, dev = self.trial, self.config, self.device

        seed = config.experiment_seed
        gen = torch.Generator(device=dev).manual_seed(fold_seed(seed, 0))
        params = trial.initial_params(gen)
        tx = trial.optimizer()
        state = create_train_state(params, tx, fold_seed(seed, 1))

        data_iter = iter(trial.training_data())
        try:
            first_batch = next(data_iter)
        except StopIteration:
            raise RuntimeError("training_data() yielded no batches") from None

        batches_trained = 0
        if latest_checkpoint:
            state, batches_trained = self._restore(latest_checkpoint, state)

        opt = config.optimizations
        k = max(1, int(opt.steps_per_dispatch))
        prefetch_depth = max(0, int(opt.prefetch_depth))

        train_step = make_train_step(trial.loss, tx)
        # k batches per call; remainders smaller than k use the single
        # step, so batch order and per-step seeds match the unfused loop
        fused_step = (make_train_step(trial.loss, tx, steps_per_dispatch=k)
                      if k > 1 else None)
        eval_step = make_eval_step(trial.eval_metrics, seed=fold_seed(seed, 2))

        sched_unit = config.scheduling_unit
        val_period = self._to_batches(config.min_validation_period, 0)
        ckpt_period = self._to_batches(config.min_checkpoint_period, 0)
        policy = config.checkpoint_policy
        smaller = config.searcher.smaller_is_better
        searcher_metric = config.searcher.metric

        # skip already-trained batches on restore so data order lines up;
        # index-capable iterators fast-forward by arithmetic
        restored = batches_trained > 0
        if restored:
            to_skip = batches_trained - 1  # first_batch discarded below
            while to_skip > 0:
                skipped = _skip_batches(data_iter, to_skip)
                to_skip -= skipped
                if to_skip > 0:
                    # epoch exhausted mid-replay: roll into the next one
                    data_iter = iter(trial.training_data())
                    if skipped == 0:
                        # the previous epoch was already drained, so the
                        # fresh one must move — probe one batch to rule out
                        # an empty dataset (would otherwise loop forever)
                        if _skip_batches(data_iter, 1) == 0:
                            raise RuntimeError(
                                "training_data() yielded no batches while "
                                "replaying restored progress")
                        to_skip -= 1

        def batches() -> Iterator[Any]:
            if not restored:
                yield first_batch
            yield from data_iter
            while True:  # repeat dataset
                yield from iter(trial.training_data())

        # on the card, the prefetcher's producer starts each copy on a side
        # stream and the consumer's stream waits for it; inline, a batch is
        # copied on the step's own stream
        if prefetch_depth and dev.type == "cuda":
            stager = CudaStager(dev)
            put, ready = stager.put, stager.ready
        else:
            put, ready = functools.partial(batch_to_device, device=dev), None

        feed = make_device_feeder(
            batches(), put, depth=prefetch_depth * k if prefetch_depth else 0,
            name="train-prefetch", ready=ready)

        acc = MetricAccumulator()
        last_val: Dict[str, float] = {}
        best_val: Optional[float] = None
        last_val_at = batches_trained
        last_ckpt_at = batches_trained
        preempted = False
        result: Dict[str, Any] = {}

        # an optional profiler a caller may set on the Core context
        # (record_batch_timing)
        profiler = self.core.profiler
        eval_dropped = {"examples": 0, "warned": False}

        def validate() -> Dict[str, float]:
            vdata = trial.validation_data()
            if vdata is None:
                return {}

            def full_batches() -> Iterator[Any]:
                # drop a shape-mismatched remainder batch (the JAX loop's
                # drop_remainder contract, kept so both report the same)
                first_shapes = None
                for vb in vdata:
                    arrays = batch_leaves(vb)
                    shapes = tuple(np.shape(a) for a in arrays)
                    if first_shapes is None:
                        first_shapes = shapes
                    elif shapes != first_shapes:
                        eval_dropped["examples"] += (
                            int(np.shape(arrays[0])[0])
                            if arrays and np.ndim(arrays[0]) else 1)
                        continue
                    yield vb

            vacc = MetricAccumulator()
            vfeed = make_device_feeder(full_batches(), put,
                                       depth=prefetch_depth,
                                       name="eval-prefetch", ready=ready)
            try:
                for vbatch in vfeed:
                    vacc.add(eval_step(state, vbatch))
            finally:
                vfeed.close()
            metrics = vacc.result() if len(vacc) else {}
            if eval_dropped["examples"] and not eval_dropped["warned"]:
                eval_dropped["warned"] = True
                logger.warning(
                    "validation dropped %d examples in shape-mismatched "
                    "remainder batches (drop_remainder contract); pad or "
                    "size the eval set to a batch multiple for full "
                    "coverage", eval_dropped["examples"])
            if metrics:
                self.core.train.report_validation_metrics(batches_trained,
                                                          metrics)
            return metrics

        # the prefetcher must join on EVERY exit — normal completion,
        # preemption, or a mid-chunk exception
        try:
            for op in self.core.searcher.operations():
                if op.length is None:
                    raise RuntimeError(
                        "searcher.max_length is not set: the searcher "
                        "operation has no training target. Set "
                        "searcher.max_length in the experiment config (e.g. "
                        "{'batches': 1000}) or provide a searcher_source.")
                target = self._to_batches(op.length, 0)
                while batches_trained < target and not preempted:
                    chunk_end = min(
                        target,
                        (batches_trained // sched_unit + 1) * sched_unit)
                    t0 = time.perf_counter()
                    n0 = batches_trained
                    while batches_trained < chunk_end:
                        faults.point("training.pre_step")
                        if (fused_step is not None
                                and chunk_end - batches_trained >= k):
                            group = [next(feed) for _ in range(k)]
                            state, metrics = fused_step(state, *group)
                            acc.add(metrics, count=k)
                            batches_trained += k
                        else:
                            state, metrics = train_step(state, next(feed))
                            acc.add(metrics)
                            batches_trained += 1
                        faults.point("training.post_step")
                    # ---- reporting boundary (one host sync per chunk) ----
                    train_metrics = acc.result()
                    dt = time.perf_counter() - t0
                    t_wait = feed.take_queue_wait()
                    t_host = feed.take_host_time()
                    train_metrics["batches_per_second"] = (
                        (batches_trained - n0) / dt)
                    train_metrics["samples_per_second"] = (
                        (batches_trained - n0) * trial.global_batch_size / dt)
                    self.core.train.report_training_metrics(batches_trained,
                                                            train_metrics)
                    if profiler is not None:
                        profiler.record_batch_timing(
                            batches_trained, dataloading_s=t_host,
                            compute_s=max(dt - t_wait, 0.0),
                            queue_wait_s=t_wait, steps_per_dispatch=k,
                            prefetch_depth=prefetch_depth)
                    op.report_progress(batches_trained)

                    if val_period and batches_trained - last_val_at >= val_period:
                        last_val = validate()
                        last_val_at = batches_trained
                        if searcher_metric in last_val:
                            v = last_val[searcher_metric]
                            if best_val is None or (
                                    v < best_val if smaller else v > best_val):
                                best_val = v
                                if policy == "best":
                                    self._save(state, batches_trained, "best",
                                               metric=v)
                                    last_ckpt_at = batches_trained

                    # a metric describes the saved weights only when
                    # validation ran at THIS batch count
                    def fresh_metric():
                        if last_val_at == batches_trained:
                            return last_val.get(searcher_metric)
                        return None

                    if ckpt_period and batches_trained - last_ckpt_at >= ckpt_period:
                        if policy != "none":
                            self._save(state, batches_trained, "periodic",
                                       metric=fresh_metric())
                        last_ckpt_at = batches_trained

                    if self.core.preempt.should_preempt():
                        preempted = True

                if preempted:
                    self._save(state, batches_trained, "preemption",
                               metric=fresh_metric())
                    self.core.train.report_early_exit("preempted")
                    break

                # op complete: ensure a fresh validation at the boundary
                final_val = validate()
                if final_val:
                    last_val = final_val
                    last_val_at = batches_trained
                    if searcher_metric in final_val:
                        v = final_val[searcher_metric]
                        if best_val is None or (
                                v < best_val if smaller else v > best_val):
                            best_val = v
                op.complete(last_val.get(searcher_metric, float("nan")))
        finally:
            feed.close()

        if not preempted and policy != "none" and batches_trained > last_ckpt_at:
            metric = (last_val.get(searcher_metric)
                      if last_val_at == batches_trained else None)
            self._save(state, batches_trained, "final", metric=metric)

        self.core.checkpoint.wait_async()

        result.update(
            batches_trained=batches_trained,
            last_validation=last_val,
            best_validation=best_val,
            preempted=preempted,
        )
        self._final_state = state
        return result
