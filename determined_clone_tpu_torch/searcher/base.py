"""Search-method engine: event-driven hyperparameter search — the port's
copy of ``determined_clone_tpu/searcher/base.py``.

Re-design of the reference's searcher core (master/pkg/searcher/searcher.go:48,
search_method.go:17, operations.go:111-295): a ``SearchMethod`` reacts to
trial lifecycle events by emitting operations —

  Create(request_id, hparams)      start a new trial
  ValidateAfter(request_id, units) train trial to a cumulative unit target,
                                    then validate & report
  Close(request_id)                stop a trial (checkpoint + finish)
  Shutdown()                       experiment complete

The engine is deliberately host-language-agnostic state-machine logic: the
same protocol is spoken by the Python trial harness (core/_searcher.py) and
by the C++ master's experiment orchestrator. Snapshot/restore makes search
crash-consistent (reference: searcher snapshots, restore.go).
"""
from __future__ import annotations

import abc
import dataclasses
import random as _random
from typing import Any, Dict, List, Optional

from determined_clone_tpu_torch.config.experiment import SearcherConfig
from determined_clone_tpu_torch.config.hyperparameters import (
    HyperparameterSpace,
)


# ---------------------------------------------------------------------------
# Operations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Operation:
    pass


@dataclasses.dataclass(frozen=True)
class Create(Operation):
    request_id: int
    hparams: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ValidateAfter(Operation):
    request_id: int
    length: int  # cumulative target, in searcher units (scheduling units)


@dataclasses.dataclass(frozen=True)
class Close(Operation):
    request_id: int


@dataclasses.dataclass(frozen=True)
class Shutdown(Operation):
    cancel: bool = False
    failure: bool = False


# ---------------------------------------------------------------------------
# Method interface + engine
# ---------------------------------------------------------------------------

class SearchMethod(abc.ABC):
    """Implementations are pure state machines over events.

    Built-in methods take (config, space, seed); user-defined custom methods
    (searcher/custom.py runners) may define any constructor — the base
    snapshot/restore only covers ``self.rng`` when present.
    """

    def __init__(self, config: Optional[SearcherConfig] = None,
                 space: Optional[HyperparameterSpace] = None,
                 seed: int = 0) -> None:
        self.config = config
        self.space = space
        self.rng = _random.Random(seed)

    @abc.abstractmethod
    def initial_operations(self) -> List[Operation]:
        ...

    @abc.abstractmethod
    def on_validation_completed(self, request_id: int, metric: float,
                                units: int) -> List[Operation]:
        ...

    def on_trial_created(self, request_id: int) -> List[Operation]:
        return []

    def on_trial_closed(self, request_id: int) -> List[Operation]:
        return []

    def on_trial_exited_early(self, request_id: int,
                              reason: str) -> List[Operation]:
        return []

    @abc.abstractmethod
    def progress(self) -> float:
        """0..1 completion estimate."""

    # crash-consistency (reference: searcher state snapshots)
    def snapshot(self) -> Dict[str, Any]:
        rng = getattr(self, "rng", None)
        return {"rng": rng.getstate()} if rng is not None else {}

    def restore(self, snap: Dict[str, Any]) -> None:
        state = snap.get("rng")
        if state is not None and getattr(self, "rng", None) is not None:
            # JSON roundtrips tuples to lists; normalize back
            a, b, c = state
            self.rng.setstate((a, tuple(b), c))


class Searcher:
    """Drives a SearchMethod; allocates request ids; tracks liveness.

    ≈ master/pkg/searcher/searcher.go:48 — the thin engine between the
    experiment orchestrator and the method.
    """

    def __init__(self, method: SearchMethod) -> None:
        self.method = method
        self.next_id = 0
        self.outstanding: Dict[int, Dict[str, Any]] = {}  # live trials
        self.closed: set = set()
        self.shutdown = False

    def _assign_ids(self, ops: List[Operation]) -> List[Operation]:
        out: List[Operation] = []
        for op in ops:
            if isinstance(op, Create):
                if op.request_id < 0:  # method asks engine to number it
                    op = Create(self.next_id, op.hparams)
                self.next_id = max(self.next_id, op.request_id + 1)
                self.outstanding[op.request_id] = {"hparams": op.hparams}
            elif isinstance(op, Close):
                self.closed.add(op.request_id)
                self.outstanding.pop(op.request_id, None)
            elif isinstance(op, Shutdown):
                self.shutdown = True
            out.append(op)
        return out

    def initial_operations(self) -> List[Operation]:
        return self._assign_ids(self.method.initial_operations())

    def trial_created(self, request_id: int) -> List[Operation]:
        return self._assign_ids(self.method.on_trial_created(request_id))

    def validation_completed(self, request_id: int, metric: float,
                             units: int) -> List[Operation]:
        return self._assign_ids(
            self.method.on_validation_completed(request_id, metric, units)
        )

    def trial_closed(self, request_id: int) -> List[Operation]:
        self.closed.add(request_id)
        self.outstanding.pop(request_id, None)
        return self._assign_ids(self.method.on_trial_closed(request_id))

    def trial_exited_early(self, request_id: int, reason: str) -> List[Operation]:
        self.outstanding.pop(request_id, None)
        return self._assign_ids(
            self.method.on_trial_exited_early(request_id, reason)
        )

    def progress(self) -> float:
        return self.method.progress()

    def snapshot(self) -> Dict[str, Any]:
        return {
            "method": self.method.snapshot(),
            "next_id": self.next_id,
            "closed": list(self.closed),
            "outstanding": {str(k): v for k, v in self.outstanding.items()},
            "shutdown": self.shutdown,
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        self.method.restore(snap["method"])
        self.next_id = snap["next_id"]
        self.closed = set(snap["closed"])
        self.outstanding = {int(k): v for k, v in snap["outstanding"].items()}
        self.shutdown = snap["shutdown"]
