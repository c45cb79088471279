"""Search methods: single, random, grid (reference: master/pkg/searcher/
random.go, grid.go) — the port's copy of
``determined_clone_tpu/searcher/methods.py``. ASHA lives in asha.py;
adaptive ASHA in adaptive.py."""
from __future__ import annotations

from typing import Any, Dict, List

from determined_clone_tpu_torch.searcher.base import (
    Close,
    Create,
    Operation,
    SearchMethod,
    Shutdown,
    ValidateAfter,
)


class _MaxLengthMixin:
    @property
    def max_units(self) -> int:
        """searcher.max_length resolved to scheduling units by the caller;
        stored in config.extra by the engine wiring, or derived simply."""
        cfg = self.config
        if cfg.max_length is None:
            raise ValueError(f"searcher '{cfg.name}' requires max_length")
        # units here are abstract: the trial-side resolves Length→batches.
        # For engine bookkeeping we use the raw value.
        return cfg.max_length.value


class SingleSearch(_MaxLengthMixin, SearchMethod):
    """One trial, one validation at max_length (reference single searcher)."""

    def __init__(self, config, space, seed=0):
        super().__init__(config, space, seed)
        self._done = False

    def initial_operations(self) -> List[Operation]:
        return [
            Create(-1, self.space.sample(self.rng)),
            ValidateAfter(0, self.max_units),
        ]

    def on_validation_completed(self, request_id, metric, units):
        self._done = True
        return [Close(request_id), Shutdown()]

    def on_trial_exited_early(self, request_id, reason):
        self._done = True
        return [Shutdown(failure=True)]

    def progress(self) -> float:
        return 1.0 if self._done else 0.0


class RandomSearch(_MaxLengthMixin, SearchMethod):
    """max_trials independent random trials (reference random.go)."""

    def __init__(self, config, space, seed=0):
        super().__init__(config, space, seed)
        self.created = 0
        self.completed = 0

    def initial_operations(self) -> List[Operation]:
        n = min(self.config.max_trials,
                self.config.max_concurrent_trials or self.config.max_trials)
        ops: List[Operation] = []
        for _ in range(n):
            ops.append(Create(-1, self.space.sample(self.rng)))
        self.created = n
        return ops

    def on_trial_created(self, request_id) -> List[Operation]:
        return [ValidateAfter(request_id, self.max_units)]

    def on_validation_completed(self, request_id, metric, units):
        self.completed += 1
        return [Close(request_id)] + self._refill_or_shutdown()

    def on_trial_exited_early(self, request_id, reason):
        # an errored trial still consumes its budget slot (reference
        # semantics: the search continues around failures)
        self.completed += 1
        return self._refill_or_shutdown()

    def _refill_or_shutdown(self) -> List[Operation]:
        if self.created < self.config.max_trials:
            self.created += 1
            return [Create(-1, self.space.sample(self.rng))]
        if self.completed >= self.config.max_trials:
            return [Shutdown()]
        return []

    def progress(self) -> float:
        return self.completed / max(1, self.config.max_trials)

    def snapshot(self) -> Dict[str, Any]:
        return {**super().snapshot(), "created": self.created,
                "completed": self.completed}

    def restore(self, snap) -> None:
        super().restore(snap)
        self.created = snap["created"]
        self.completed = snap["completed"]


class GridSearch(_MaxLengthMixin, SearchMethod):
    """Exhaustive cartesian grid (reference grid.go); max_trials caps it."""

    def __init__(self, config, space, seed=0):
        super().__init__(config, space, seed)
        self.points = list(space.grid())
        if config.max_trials > 1:
            self.points = self.points[: config.max_trials]
        self.completed = 0

    def initial_operations(self) -> List[Operation]:
        limit = self.config.max_concurrent_trials or len(self.points)
        ops: List[Operation] = []
        for hp in self.points[:limit]:
            ops.append(Create(-1, hp))
        self._launched = min(limit, len(self.points))
        return ops

    def on_trial_created(self, request_id) -> List[Operation]:
        return [ValidateAfter(request_id, self.max_units)]

    def on_validation_completed(self, request_id, metric, units):
        self.completed += 1
        return [Close(request_id)] + self._refill_or_shutdown()

    def on_trial_exited_early(self, request_id, reason):
        self.completed += 1
        return self._refill_or_shutdown()

    def _refill_or_shutdown(self) -> List[Operation]:
        if self._launched < len(self.points):
            op = Create(-1, self.points[self._launched])
            self._launched += 1
            return [op]
        if self.completed >= len(self.points):
            return [Shutdown()]
        return []

    def progress(self) -> float:
        return self.completed / max(1, len(self.points))

    def snapshot(self) -> Dict[str, Any]:
        return {**super().snapshot(), "completed": self.completed,
                "launched": self._launched}

    def restore(self, snap) -> None:
        super().restore(snap)
        self.completed = snap["completed"]
        self._launched = snap["launched"]
