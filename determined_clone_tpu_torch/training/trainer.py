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

Mesh path (the JAX loop's ``_fit_inner`` with a mesh): when the trial's
context has a mesh (``slots_per_trial`` ranks started by
``exec/launch.py``), the state is placed by ``state_shardings`` on the
trial's ``sharding_rules()`` and each batch by its ``batch_spec``: every
rank reads the global batch from the trial's stream and keeps its own
rows. Restores go into the same placements; reports and searcher
progress come from the chief only (the Core API contexts gate them);
saves are sharded (``shard=dist.size > 1``): each rank writes its blocks
into ``shard-{rank}.npz`` and the manifests merge, in the JAX package's
format.

Seeds: the params are drawn from a generator seeded with
``fold_seed(experiment_seed, 0)``, the state's seed is
``fold_seed(experiment_seed, 1)`` and validation's
``fold_seed(experiment_seed, 2)`` — the port's counterparts of the JAX
loop's split and ``fold_in`` of ``PRNGKey(experiment_seed)``; the random
streams themselves differ between the frameworks.

Telemetry (the ``observability:`` block; ``core.telemetry``) is the JAX
loop's branch, at the same points of the loop: restore fallbacks
counted, ``checkpoint_restore``, ``restore_replay``, ``checkpoint_save``,
``validate`` and ``host_sync`` spanned; each train step's first call
captured as its compile (``telemetry/compile.py``: seconds, fingerprint,
FLOPs counted by ``FlopCounterMode``, and over a mesh its collectives)
and every call a ``train_dispatch`` span synced to the device's
completion, its steady durations fed to the step-time anomaly detector;
eval steps ``eval_dispatch`` spans; the feeder's pulls ``dataload_wait``
spans; per chunk the analytic and measured MFU against the card's peak
(``mfu_peak_info`` carries the peak's and the FLOP count's provenance),
the device memory gauges and their peak, and ``Telemetry.publish``.
When telemetry is off the loop runs the unwrapped step and feeder, and
adds nothing per step.
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
from determined_clone_tpu_torch.core._serialization import (
    tree_map_with_path,
    tree_paths_and_leaves,
)
from determined_clone_tpu_torch.ops.layers import fold_seed
from determined_clone_tpu_torch.parallel.sharding import (
    NamedSharding,
    PartitionSpec,
    from_block,
    host_block,
)
from determined_clone_tpu_torch.telemetry import flops as flops_mod
from determined_clone_tpu_torch.telemetry.collectives import mesh_axis_sizes
from determined_clone_tpu_torch.telemetry.compile import (
    MfuComparator,
    StepTimeAnomalyDetector,
    capture_compile,
)
from determined_clone_tpu_torch.telemetry.device import (
    DeviceMemoryMonitor,
    block_until_ready,
)
from determined_clone_tpu_torch.telemetry.spans import null_span
from determined_clone_tpu_torch.training.metrics import MetricAccumulator
from determined_clone_tpu_torch.training.optim import leaves
from determined_clone_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
    mark_trainable,
    param_count,
    shard_state,
    state_shardings,
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


def _same(batch: Any) -> Any:
    return batch


def _batch_placement(mesh: Any, specs: Any):
    """(split, place) for batches on ``mesh`` by their spec tree: split
    keeps this rank's block of each host array, place makes each card
    tensor the DTensor whose block it is."""
    flat = dict(tree_paths_and_leaves(
        specs, is_leaf=lambda n: isinstance(n, PartitionSpec)))
    shardings = {path: NamedSharding(mesh, spec)
                 for path, spec in flat.items()}

    def split(batch: Any) -> Any:
        return tree_map_with_path(
            lambda path, x: host_block(x, shardings[path]), batch)

    def place(batch: Any) -> Any:
        return tree_map_with_path(
            lambda path, x: from_block(x, shardings[path])
            if isinstance(x, torch.Tensor) else x, batch)

    return split, place


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
        dist = self.core.distributed
        metadata = {
            "steps_completed": batches_trained,
            "reason": reason,
            "global_batch_size": self.trial.global_batch_size,
        }
        if metric is not None:
            metadata["validation_metric"] = float(metric)
        with self._span("checkpoint_save", reason=reason):
            with self.core.checkpoint.store_path(
                    metadata=metadata, shard=dist.size > 1) as (path, holder):
                save_pytree(f"{path}/{CKPT_STATE_DIR}", state,
                            host_id=dist.rank)
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
                tel = self._telemetry
                if tel is not None:
                    tel.registry.counter(
                        "checkpoint_restore_fallbacks",
                        "restores that fell back past an uncommitted/"
                        "corrupt checkpoint").inc()
        raise first_err if first_err is not None else RuntimeError(
            f"no restorable checkpoint for {storage_id}")

    def _restore_one(self, storage_id: str, like: TrainState) -> tuple:
        with self._span("checkpoint_restore"):
            with self.core.checkpoint.restore_path(storage_id) as path:
                state = load_pytree(f"{path}/{CKPT_STATE_DIR}", like)
                mpath = f"{path}/metadata.json"
                meta: dict = {}
                if os.path.exists(mpath):
                    with open(mpath) as f:
                        meta = json.load(f)
        mark_trainable(state.params)
        return state, int(meta.get("steps_completed", 0))

    @property
    def _telemetry(self):
        return getattr(self.core, "telemetry", None)

    @staticmethod
    def _resolve_step_flops(trial: TorchTrial, state: TrainState) -> tuple:
        """(FLOPs per optimizer step, source label). Prefers the trial's
        analytic count; falls back to 6*N_params*tokens. A trial hook that
        raises downgrades to the fallback — FLOPs accounting must never
        fail training."""
        try:
            f = trial.train_step_flops()
        except Exception:  # noqa: BLE001 - observability is best-effort
            f = None
        if f is not None:
            return float(getattr(f, "total", f)), "analytic"
        n_params = param_count(state.params)
        try:
            tokens_per_sample = int(trial.tokens_per_sample() or 1)
        except Exception:  # noqa: BLE001 - observability is best-effort
            tokens_per_sample = 1
        tokens = trial.global_batch_size * max(1, tokens_per_sample)
        return flops_mod.dense_train_flops_per_token(n_params) * tokens, \
            "dense_6n"

    @property
    def _span(self):
        """The tracer's span factory, or the shared no-op when telemetry is
        off — boundary-only call sites (save/restore/sync), never per
        batch."""
        tel = self._telemetry
        return tel.tracer.span if tel is not None else null_span

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
        mesh = trial.context.mesh

        seed = config.experiment_seed
        gen = torch.Generator(device=dev).manual_seed(fold_seed(seed, 0))
        params = trial.initial_params(gen)
        tx = trial.optimizer()
        state = create_train_state(params, tx, fold_seed(seed, 1))
        if mesh is not None:
            # every rank drew the same params; each keeps its blocks
            state = shard_state(state, state_shardings(
                state, mesh, trial.sharding_rules()))

        data_iter = iter(trial.training_data())
        try:
            first_batch = next(data_iter)
        except StopIteration:
            raise RuntimeError("training_data() yielded no batches") from None
        # over a mesh a host batch is cut to this rank's rows before its
        # copy to the card (split), and the copy becomes a DTensor (place)
        split = place = _same
        if mesh is not None:
            split, place = _batch_placement(mesh,
                                            trial.batch_spec(first_batch))

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

        # telemetry (observability: block; None when disabled — the hot
        # loop below then runs the *unwrapped* steps and feeder, so the
        # disabled path adds nothing per step). The sync makes each
        # train_dispatch span cover the device's work, not the enqueue.
        tel = self._telemetry
        span = tel.tracer.span if tel is not None else null_span
        platform = "gpu" if dev.type == "cuda" else "cpu"
        step_capture = fused_capture = None
        anomaly = memmon = None
        if tel is not None:
            # each step program's first call is its compile, captured
            # (telemetry/compile.py): seconds, fingerprint and counted
            # FLOPs land in the registry after that call
            identity = {"hparams": trial.context.hparams,
                        "dtypes": sorted({str(p.dtype) for p in
                                          leaves(state.params)}),
                        "mesh": (mesh_axis_sizes(mesh)
                                 if mesh is not None else None)}
            train_step = step_capture = capture_compile(
                train_step, program="train_step", identity=identity,
                registry=tel.registry, mesh=mesh, platform=platform)
            if fused_step is not None:
                fused_step = fused_capture = capture_compile(
                    fused_step, program=f"train_step_fused_k{k}",
                    identity=identity, registry=tel.registry, mesh=mesh,
                    platform=platform)
            # rolling median/MAD straggler detection over steady-state
            # dispatch durations (compiles are excluded by wrap_jit)
            anomaly = StepTimeAnomalyDetector(
                tel.registry, tracer=tel.tracer,
                window=tel.anomaly_window,
                threshold=tel.anomaly_threshold,
                min_samples=tel.anomaly_min_samples)
            memmon = DeviceMemoryMonitor(tel.registry)
            train_step = tel.wrap_jit("train_dispatch", train_step,
                                      sync=block_until_ready,
                                      observe=anomaly.observe)
            if fused_step is not None:
                fused_step = tel.wrap_jit("train_dispatch", fused_step,
                                          sync=block_until_ready,
                                          observe=anomaly.observe)
            eval_step = tel.wrap_jit("eval_dispatch", eval_step,
                                     sync=block_until_ready)

        # analytic FLOPs/MFU accounting (telemetry/flops.py) — resolved
        # once here, reported per chunk; only when telemetry is on
        step_flops = 0.0
        flops_source = peak_label = ""
        peak_total = 0.0
        mfu_cmp = None
        if tel is not None:
            step_flops, flops_source = self._resolve_step_flops(trial, state)
            n_devices = mesh.size() if mesh is not None else 1
            peak, peak_label = flops_mod.peak_flops_estimate(platform)
            peak_total = peak * max(1, n_devices)

        def measured_step_flops() -> float:
            """The counted FLOPs of one batch's step (the fused program
            covers k batches), once a step program has been captured."""
            for capture, per in ((fused_capture, k), (step_capture, 1)):
                if (capture is not None and capture.record is not None
                        and capture.record.flops):
                    return capture.record.flops / per
            return 0.0

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
            # spanned so the goodput ledger books replay as restore badput
            with self._span("restore_replay", batches=batches_trained - 1):
                to_skip = batches_trained - 1  # first_batch discarded below
                while to_skip > 0:
                    skipped = _skip_batches(data_iter, to_skip)
                    to_skip -= skipped
                    if to_skip > 0:
                        # epoch exhausted mid-replay: roll into the next one
                        data_iter = iter(trial.training_data())
                        if skipped == 0:
                            # the previous epoch was already drained, so
                            # the fresh one must move — probe one batch to
                            # rule out an empty dataset (would otherwise
                            # loop forever)
                            if _skip_batches(data_iter, 1) == 0:
                                raise RuntimeError(
                                    "training_data() yielded no batches "
                                    "while replaying restored progress")
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
            map(split, batches()), put,
            depth=prefetch_depth * k if prefetch_depth else 0,
            name="train-prefetch", ready=ready,
            tracer=tel.tracer if tel is not None else None,
            registry=tel.registry if tel is not None else None)
        if tel is not None:
            feed = tel.wrap_feeder(feed)

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

            with span("validate"):
                vacc = MetricAccumulator()
                vfeed = make_device_feeder(
                    map(split, full_batches()), put, depth=prefetch_depth,
                    name="eval-prefetch", ready=ready,
                    tracer=tel.tracer if tel is not None else None)
                try:
                    for vbatch in vfeed:
                        vacc.add(eval_step(state, place(vbatch)))
                finally:
                    vfeed.close()
                metrics = vacc.result() if len(vacc) else {}
            if eval_dropped["examples"]:
                if not eval_dropped["warned"]:
                    eval_dropped["warned"] = True
                    logger.warning(
                        "validation dropped %d examples in shape-mismatched "
                        "remainder batches (drop_remainder contract); pad "
                        "or size the eval set to a batch multiple for full "
                        "coverage", eval_dropped["examples"])
                if tel is not None:
                    tel.registry.gauge(
                        "eval_examples_dropped",
                        "eval examples lost to shape-mismatched remainder "
                        "batches this fit").set(eval_dropped["examples"])
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
                            group = [place(next(feed)) for _ in range(k)]
                            state, metrics = fused_step(state, *group)
                            acc.add(metrics, count=k)
                            batches_trained += k
                        else:
                            state, metrics = train_step(state,
                                                        place(next(feed)))
                            acc.add(metrics)
                            batches_trained += 1
                        faults.point("training.post_step")
                    # ---- reporting boundary (one host sync per chunk) ----
                    with span("host_sync"):
                        train_metrics = acc.result()
                    dt = time.perf_counter() - t0
                    t_wait = feed.take_queue_wait()
                    t_host = feed.take_host_time()
                    train_metrics["batches_per_second"] = (
                        (batches_trained - n0) / dt)
                    train_metrics["samples_per_second"] = (
                        (batches_trained - n0) * trial.global_batch_size / dt)
                    if tel is not None and step_flops:
                        # FLOPs throughput + MFU against the (known or
                        # assumed) peak; the provenance labels travel with
                        # the number
                        fps = step_flops * train_metrics["batches_per_second"]
                        mfu_val = flops_mod.mfu(fps, peak_total)
                        train_metrics["flops_per_sec"] = fps
                        train_metrics["mfu"] = mfu_val
                        reg = tel.registry
                        reg.gauge("samples_per_sec",
                                  "training throughput").set(
                            train_metrics["samples_per_second"])
                        reg.gauge("flops_per_sec",
                                  "analytic model FLOPs per second").set(fps)
                        reg.gauge("mfu",
                                  "model FLOPs utilization vs peak "
                                  "(provenance: mfu_peak_info labels)").set(
                            mfu_val)
                        reg.gauge("mfu_peak_flops",
                                  "peak FLOPs the MFU denominator assumes "
                                  "(all participating devices)").set(
                            peak_total)
                        reg.gauge(
                            "mfu_peak_info",
                            "constant 1; labels carry the peak provenance "
                            "and FLOPs-count source",
                            labels={"assumed": peak_label,
                                    "flops_source": flops_source}).set(1)
                        measured = measured_step_flops()
                        if measured and mfu_cmp is None:
                            mfu_cmp = MfuComparator(
                                reg, peak_flops_total=peak_total)
                        if mfu_cmp is not None:
                            train_metrics["mfu_measured"] = mfu_cmp.report(
                                measured_flops_per_batch=measured,
                                batches_per_second=train_metrics[
                                    "batches_per_second"],
                                analytic_mfu=mfu_val)
                    if memmon is not None:
                        # per-device gauges + the between-boundary peak
                        memmon.sample()
                        tel.registry.gauge(
                            "device_memory_peak_bytes",
                            "peak summed device bytes_in_use since the "
                            "previous chunk boundary").set(memmon.take_peak())
                    self.core.train.report_training_metrics(batches_trained,
                                                            train_metrics)
                    if profiler is not None:
                        profiler.record_batch_timing(
                            batches_trained, dataloading_s=t_host,
                            compute_s=max(dt - t_wait, 0.0),
                            queue_wait_s=t_wait, steps_per_dispatch=k,
                            prefetch_depth=prefetch_depth)
                    if tel is not None:
                        # batched telemetry shipping rides the chunk
                        # boundary
                        tel.publish(profiler, batches_trained)
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
