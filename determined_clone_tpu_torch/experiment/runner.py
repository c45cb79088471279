"""Local experiment runner — searcher-driven multi-trial orchestration;
the port's copy of ``determined_clone_tpu/experiment/runner.py``.

The single-process counterpart of the reference's experiment orchestrator
(master/internal/experiment.go:751 processOperations + trial.go): consumes
searcher operations, runs trials, feeds validation results back, snapshots
searcher state for crash-consistency (``experiment_snapshot.json``, the
JAX runner's JSON). The C++ master implements this same loop for the
cluster; this runner is the off-cluster / single-host mode
(≈ det experiment create --local).

Trials pause/resume between ValidateAfter boundaries via checkpoints — the
same mechanism the cluster uses when ASHA pauses a trial and later promotes
it. Every leg trains on ``device``: the card unless the caller asks for
``"cpu"`` (a CUDA device without CUDA raises, here at construction).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import uuid
from typing import Any, Dict, List, Optional, Type

from determined_clone_tpu_torch import core as core_mod
from determined_clone_tpu_torch.config.experiment import ExperimentConfig
from determined_clone_tpu_torch.config.length import Length
from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.searcher import (
    Close,
    Create,
    Searcher,
    Shutdown,
    ValidateAfter,
    build_method,
)
from determined_clone_tpu_torch.telemetry import MetricsRegistry, Telemetry
from determined_clone_tpu_torch.training.trainer import Trainer
from determined_clone_tpu_torch.training.trial import (
    TorchTrial,
    TrialContext,
)
from determined_clone_tpu_torch.utils import retry as retry_util


class _SampleCollector:
    """Duck-typed ProfilerAgent stand-in: ``Telemetry.publish`` feeds it,
    the runner forwards the collected batch to the in-process master."""

    def __init__(self) -> None:
        self.samples: List[Dict[str, Any]] = []

    def record(self, sample: Dict[str, Any]) -> None:
        self.samples.append(sample)

# Restart pacing (≈ the reference's trial restart delay): small enough that
# single-host test runs stay fast, but each consecutive failure doubles the
# wait so a persistently-broken trial doesn't spin the orchestration loop.
RESTART_BACKOFF = retry_util.RetryPolicy(
    name="runner_restart",
    max_attempts=1,  # the runner tracks attempts itself via max_restarts
    base_delay_s=0.25,
    max_delay_s=10.0,
)


@dataclasses.dataclass
class TrialRecord:
    request_id: int
    hparams: Dict[str, Any]
    units_done: int = 0
    latest_checkpoint: Optional[str] = None
    last_metric: Optional[float] = None
    best_metric: Optional[float] = None
    state: str = "active"  # active | paused | completed | errored
    restarts: int = 0
    metrics_path: Optional[str] = None


@dataclasses.dataclass
class ExperimentResult:
    trials: Dict[int, TrialRecord]
    best_trial: Optional[TrialRecord]
    shutdown: bool

    @property
    def n_trials(self) -> int:
        return len(self.trials)


class LocalExperimentRunner:
    def __init__(self, config: ExperimentConfig,
                 trial_cls: Type[TorchTrial], *,
                 storage_path: str,
                 mesh: Optional[Any] = None,
                 max_events: int = 10_000,
                 method: Optional[Any] = None,
                 registry: Optional[MetricsRegistry] = None,
                 restart_backoff: Optional[retry_util.RetryPolicy] = None,
                 master: Optional[Any] = None,
                 experiment_id: int = 1,
                 trace_id: Optional[str] = None,
                 device: DeviceLike = "cuda",
                 ) -> None:
        self.device = resolve_device(device)
        self.config = config
        self.trial_cls = trial_cls
        self.storage_path = storage_path
        self.mesh = mesh
        self.max_events = max_events
        self.registry = registry if registry is not None else MetricsRegistry()
        # observability plane: when an InProcessMaster is attached, trial
        # telemetry ships there after every leg (deduped by idempotency
        # key) and the runner contributes its own trace lane so `dct trace
        # export --experiment` can stitch runner + trials into one trace
        self.master = master
        self.experiment_id = int(experiment_id)
        self.trace_id = trace_id or (uuid.uuid4().hex
                                     if master is not None else None)
        self.telemetry: Optional[Telemetry] = None
        if master is not None:
            self.telemetry = Telemetry(
                enabled=True, max_events=max_events, ship_spans=True,
                ship_metrics=False, trace_id=self.trace_id,
                process_name="runner")
        self.restart_backoff = (restart_backoff if restart_backoff is not None
                                else RESTART_BACKOFF)
        self._restarts_total = self.registry.counter(
            "trial_restarts_total", "trial legs restarted after a failure")
        # method override: a user-provided SearchMethod (custom search via
        # searcher.LocalSearchRunner) instead of the built-in factory
        self.engine = Searcher(method if method is not None else build_method(
            config.searcher, config.hyperparameters,
            seed=config.experiment_seed))
        self.trials: Dict[int, TrialRecord] = {}
        self._snapshot_path = os.path.join(storage_path,
                                           "experiment_snapshot.json")

    # -- crash consistency (≈ master/internal/restore.go) -------------------

    def _snapshot(self) -> None:
        snap = {
            "searcher": self.engine.snapshot(),
            "trials": {
                str(rid): dataclasses.asdict(t) for rid, t in self.trials.items()
            },
        }
        tmp = self._snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(snap, f)
        os.replace(tmp, self._snapshot_path)

    def _units_to_length(self, units: int) -> Length:
        ml = self.config.searcher.max_length
        unit = ml.unit if ml is not None else None
        if unit is None:
            return Length.batches(units)
        return Length(unit, units)

    # -- one training leg ---------------------------------------------------

    def _run_to(self, rec: TrialRecord, target_units: int) -> float:
        """Train trial ``rec`` up to cumulative target_units; return the
        searcher metric from its final validation."""
        cfg = self.config
        metrics_backend = core_mod.LocalMetricsBackend(
            os.path.join(self.storage_path,
                         f"trial-{rec.request_id}-metrics.jsonl")
        )
        rec.metrics_path = metrics_backend.path
        searcher_source = core_mod.LocalSearcherSource(
            self._units_to_length(target_units)
        )
        # export the experiment trace id through the env so the trial's
        # telemetry (built inside core.init) joins this experiment's
        # trace — the same contract exec/trial.py uses across a real
        # process boundary
        prev_trace_env = os.environ.get("DCT_TRACE_ID")
        if self.trace_id:
            os.environ["DCT_TRACE_ID"] = self.trace_id
        leg_span = (self.telemetry.tracer.span(
            "trial_leg", trial_id=rec.request_id, restart=rec.restarts,
            target_units=target_units)
            if self.telemetry is not None else None)
        try:
            with core_mod.init(
                config=cfg,
                storage_path=self.storage_path,
                metrics_backend=metrics_backend,
                searcher_source=searcher_source,
                trial_id=rec.request_id,
            ) as cctx:
                if cctx.telemetry is not None:
                    cctx.telemetry.set_identity(
                        trace_id=self.trace_id,
                        process_name=f"trial-{rec.request_id}")
                try:
                    if leg_span is not None:
                        leg_span.__enter__()
                    # mesh None: the trial builds its own from the world
                    # and its ``mesh`` hparam, as the JAX context does
                    mesh = {} if self.mesh is None else {"mesh": self.mesh}
                    tctx = TrialContext(config=cfg, hparams=rec.hparams,
                                        core=cctx, device=self.device,
                                        **mesh)
                    trial = self.trial_cls(tctx)
                    trainer = Trainer(trial)
                    result = trainer.fit(
                        latest_checkpoint=rec.latest_checkpoint)
                finally:
                    if leg_span is not None:
                        leg_span.__exit__(None, None, None)
                    self._ship_trial_telemetry(rec, cctx)
        finally:
            if self.trace_id:
                if prev_trace_env is None:
                    os.environ.pop("DCT_TRACE_ID", None)
                else:
                    os.environ["DCT_TRACE_ID"] = prev_trace_env
        rec.units_done = target_units
        reg = core_mod.LocalCheckpointRegistry(self._registry_path())
        mine = [r for r in reg.list() if r.get("trial_id") == rec.request_id]
        if mine:
            rec.latest_checkpoint = mine[-1]["storage_id"]
        metric_name = cfg.searcher.metric
        last_val = result.get("last_validation") or {}
        if metric_name in last_val:
            return float(last_val[metric_name])
        raise RuntimeError(
            f"trial {rec.request_id} reported no searcher metric "
            f"{metric_name!r} (validation metrics: {sorted(last_val) or 'none'}). "
            f"Check searcher.metric against the trial's eval_metrics keys and "
            f"that validation_data()/min_validation_period are set."
        )

    def _ship_trial_telemetry(self, rec: TrialRecord, cctx: Any) -> None:
        """Forward the leg's telemetry snapshot + spans to the attached
        master. Failures never fail the leg (telemetry is lossy by
        contract); the batch carries an idempotency key so a replayed
        restart leg can't double-count."""
        if self.master is None or cctx.telemetry is None:
            return
        try:
            collector = _SampleCollector()
            cctx.telemetry.publish(collector)
            if collector.samples:
                self.master.ingest_trial(
                    rec.request_id, collector.samples,
                    idempotency_key=uuid.uuid4().hex)
        except Exception:  # noqa: BLE001 - observability is best-effort
            pass

    def _ship_runner_telemetry(self) -> None:
        """Contribute the runner's own lane (registry + spans) to the
        master so restarts and orchestration time show up cluster-wide."""
        if self.master is None:
            return
        try:
            self.master.ingest_component("runner", self.registry)
            if self.telemetry is not None:
                collector = _SampleCollector()
                self.telemetry.publish(collector)
                spans = [s for s in collector.samples
                         if s.get("group") == "span"]
                if spans:
                    self.master.ingest_component_spans(
                        "runner", spans, experiment_id=self.experiment_id)
        except Exception:  # noqa: BLE001 - observability is best-effort
            pass

    def _registry_path(self) -> str:
        """The checkpoint registry lives next to the checkpoint storage —
        same resolution as core.init (core/_context.py)."""
        cs = self.config.checkpoint_storage
        base = self.storage_path
        if cs is not None:
            base = cs.host_path or cs.container_path or self.storage_path
        return os.path.join(base, "checkpoints.jsonl")

    # -- the orchestration loop --------------------------------------------

    def run(self) -> ExperimentResult:
        exp_span = (self.telemetry.tracer.span(
            "experiment", experiment_id=self.experiment_id)
            if self.telemetry is not None else None)
        if exp_span is not None:
            exp_span.__enter__()
        try:
            return self._run_loop()
        finally:
            if exp_span is not None:
                exp_span.__exit__(None, None, None)
            self._ship_runner_telemetry()

    def _run_loop(self) -> ExperimentResult:
        queue = list(self.engine.initial_operations())
        events = 0
        shutdown = False
        while queue and events < self.max_events:
            events += 1
            op = queue.pop(0)
            if isinstance(op, Create):
                self.trials[op.request_id] = TrialRecord(
                    op.request_id, op.hparams
                )
                if self.master is not None:
                    self.master.register_trial(op.request_id,
                                               self.experiment_id)
                queue.extend(self.engine.trial_created(op.request_id))
            elif isinstance(op, ValidateAfter):
                rec = self.trials[op.request_id]
                if rec.state in ("completed", "errored"):
                    continue
                rec.state = "active"
                try:
                    metric = self._run_to(rec, op.length)
                except Exception as e:  # trial failure → searcher event
                    rec.restarts += 1
                    if rec.restarts > self.config.max_restarts:
                        rec.state = "errored"
                        queue.extend(self.engine.trial_exited_early(
                            op.request_id, f"error: {e}"
                        ))
                        self._snapshot()
                        continue
                    # Back off before the retry (exponential + full jitter)
                    # so a trial failing on shared-resource contention isn't
                    # immediately thrown back at the same hot spot, and
                    # snapshot first so a crash mid-backoff still records
                    # the restart count.
                    self._restarts_total.inc()
                    self._snapshot()
                    t0 = time.perf_counter()
                    retry_util.sleep_backoff(self.restart_backoff,
                                             rec.restarts)
                    if (self.telemetry is not None
                            and self.telemetry.goodput is not None):
                        # the backoff sleep is restart badput in the
                        # runner's own wall-clock account (the trial-side
                        # inter-leg gap is booked by the journal merge)
                        self.telemetry.goodput.note(
                            "restart_backoff", time.perf_counter() - t0)
                    queue.insert(0, op)  # retry from latest checkpoint
                    continue
                rec.last_metric = metric
                smaller = self.config.searcher.smaller_is_better
                if rec.best_metric is None or (
                    metric < rec.best_metric if smaller else metric > rec.best_metric
                ):
                    rec.best_metric = metric
                rec.state = "paused"
                queue.extend(self.engine.validation_completed(
                    op.request_id, metric, op.length
                ))
                self._snapshot()
            elif isinstance(op, Close):
                rec = self.trials.get(op.request_id)
                if rec and rec.state != "completed":
                    rec.state = "completed"
                    queue.extend(self.engine.trial_closed(op.request_id))
                self._snapshot()
            elif isinstance(op, Shutdown):
                shutdown = True
                break

        smaller = self.config.searcher.smaller_is_better
        scored = [t for t in self.trials.values() if t.best_metric is not None]
        best = None
        if scored:
            best = (min if smaller else max)(scored, key=lambda t: t.best_metric)
        return ExperimentResult(trials=self.trials, best_trial=best,
                                shutdown=shutdown)
