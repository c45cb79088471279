"""Search simulation — run a method against a synthetic metric landscape
without training anything (reference: master/pkg/searcher/simulate.go, used
by asha_test.go-style behavior tests); the port's copy of
``determined_clone_tpu/searcher/simulate.py``."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from determined_clone_tpu_torch.searcher.base import (
    Close,
    Create,
    Operation,
    Searcher,
    SearchMethod,
    Shutdown,
    ValidateAfter,
)

MetricFn = Callable[[Dict[str, Any], int], float]  # (hparams, units) -> metric


@dataclasses.dataclass
class SimTrial:
    request_id: int
    hparams: Dict[str, Any]
    target_units: Optional[int] = None
    trained_units: int = 0
    closed: bool = False
    metrics: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SimResult:
    trials: Dict[int, SimTrial]
    shutdown: bool
    events: int
    max_concurrent_seen: int

    @property
    def n_trials(self) -> int:
        return len(self.trials)

    def units_by_trial(self) -> Dict[int, int]:
        return {rid: t.trained_units for rid, t in self.trials.items()}


def simulate(method: SearchMethod, metric_fn: MetricFn, *,
             max_events: int = 100_000) -> SimResult:
    """Drive the method to completion: trials 'train' instantly and report
    metric_fn(hparams, units) at each ValidateAfter boundary."""
    engine = Searcher(method)
    trials: Dict[int, SimTrial] = {}
    queue: List[Operation] = list(engine.initial_operations())
    events = 0
    max_concurrent = 0

    def live_count() -> int:
        return sum(
            1 for t in trials.values() if not t.closed
        )

    while queue and events < max_events:
        events += 1
        op = queue.pop(0)
        if isinstance(op, Create):
            trials[op.request_id] = SimTrial(op.request_id, op.hparams)
            queue.extend(engine.trial_created(op.request_id))
            max_concurrent = max(max_concurrent, live_count())
        elif isinstance(op, ValidateAfter):
            t = trials[op.request_id]
            if t.closed:
                continue
            t.target_units = op.length
            t.trained_units = max(t.trained_units, op.length)
            m = metric_fn(t.hparams, t.trained_units)
            t.metrics.append(m)
            queue.extend(
                engine.validation_completed(op.request_id, m, t.trained_units)
            )
        elif isinstance(op, Close):
            t = trials.get(op.request_id)
            if t and not t.closed:
                t.closed = True
                queue.extend(engine.trial_closed(op.request_id))
        elif isinstance(op, Shutdown):
            return SimResult(trials, True, events, max_concurrent)
    return SimResult(trials, False, events, max_concurrent)
