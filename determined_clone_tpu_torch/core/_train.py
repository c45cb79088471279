"""TrainContext — metric reporting; the port's copy of
``determined_clone_tpu/core/_train.py``.

Metrics leave the train step as device tensors; reporting converts once per
reporting period, not per batch, to avoid host syncs in the hot loop.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List, Optional


class MetricsBackend:
    """Sink for reported metrics: local JSONL off-cluster, master REST on."""

    def report(self, group: str, steps_completed: int,
               metrics: Dict[str, Any]) -> None:
        raise NotImplementedError


class LocalMetricsBackend(MetricsBackend):
    def __init__(self, path: Optional[str] = None) -> None:
        self.path = path
        self.records: List[Dict[str, Any]] = []
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def report(self, group: str, steps_completed: int,
               metrics: Dict[str, Any]) -> None:
        rec = {
            "group": group,
            "steps_completed": steps_completed,
            "metrics": metrics,
            "time": time.time(),
        }
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")


class TrainContext:
    def __init__(self, backend: MetricsBackend, *, is_chief: bool = True,
                 metric: Optional[str] = None,
                 smaller_is_better: bool = True) -> None:
        self._backend = backend
        self._is_chief = is_chief
        self._metric = metric
        self._smaller_is_better = smaller_is_better
        self._best_validation: Optional[float] = None

    def report_training_metrics(self, steps_completed: int,
                                metrics: Dict[str, Any]) -> None:
        if self._is_chief:
            self._backend.report("training", steps_completed,
                                 _to_json_metrics(metrics))

    def report_validation_metrics(self, steps_completed: int,
                                  metrics: Dict[str, Any]) -> None:
        metrics = _to_json_metrics(metrics)
        if self._metric and self._metric in metrics:
            v = float(metrics[self._metric])
            if self._best_validation is None or (
                v < self._best_validation if self._smaller_is_better
                else v > self._best_validation
            ):
                self._best_validation = v
        if self._is_chief:
            self._backend.report("validation", steps_completed, metrics)

    def get_experiment_best_validation(self) -> Optional[float]:
        return self._best_validation

    def report_early_exit(self, reason: str) -> None:
        if self._is_chief:
            self._backend.report("early_exit", 0, {"reason": reason})


def _to_json_metrics(metrics: Dict[str, Any]) -> Dict[str, Any]:
    """Convert device arrays / numpy scalars to plain floats; NaN/Inf are kept
    as strings so JSON stays valid (the reference stores them similarly)."""
    out: Dict[str, Any] = {}
    for k, v in metrics.items():
        try:
            f = float(v)
            out[k] = f if math.isfinite(f) else str(f)
        except (TypeError, ValueError):
            out[k] = v
    return out
