"""Adaptive ASHA — a tournament of ASHA brackets with different early-stopping
aggressiveness (reference: master/pkg/searcher/adaptive_asha.go:71 +
tournament.go); the port's copy of
``determined_clone_tpu/searcher/adaptive.py``.

mode: aggressive → 1 bracket (max rungs, maximal early stopping);
      standard   → up to 3 brackets (num_rungs, -1, -2);
      conservative → one bracket per rung count down to 1.
The trial budget is split across brackets; each bracket is a full ASHASearch
and events are routed by request-id ownership.

NOTE: the orchestrator must call ``trial_created`` in the same order Creates
were emitted (both the Python runner and the C++ master do) — bracket ownership
of new ids is assigned FIFO.
"""
from __future__ import annotations

from typing import Any, Dict, List

from determined_clone_tpu_torch.searcher.asha import ASHASearch
from determined_clone_tpu_torch.searcher.base import (
    Create,
    Operation,
    SearchMethod,
    Shutdown,
)


class AdaptiveASHASearch(SearchMethod):
    def __init__(self, config, space, seed=0):
        super().__init__(config, space, seed)
        if config.bracket_rungs:
            rung_counts = list(config.bracket_rungs)
        elif config.mode == "aggressive":
            rung_counts = [config.num_rungs]
        elif config.mode == "conservative":
            rung_counts = list(range(config.num_rungs, 0, -1))
        else:  # standard
            rung_counts = [
                r for r in range(config.num_rungs, config.num_rungs - 3, -1)
                if r >= 1
            ]
        n = len(rung_counts)
        base, rem = divmod(config.max_trials, n)
        trials_per = [base + (1 if i < rem else 0) for i in range(n)]
        conc = max(1, (config.max_concurrent_trials or 16))
        conc_base, conc_rem = divmod(max(conc, n), n)
        conc_per = [conc_base + (1 if i < conc_rem else 0) for i in range(n)]

        self.brackets: List[ASHASearch] = []
        for i, rungs in enumerate(rung_counts):
            if trials_per[i] == 0:
                continue
            self.brackets.append(ASHASearch(
                config, space, seed=seed + i,
                num_rungs=rungs,
                max_trials=trials_per[i],
                max_concurrent=min(conc_per[i], trials_per[i]),
            ))
        self.owner: Dict[int, int] = {}       # rid -> bracket idx
        self._pending: List[int] = []         # FIFO of bracket idx per Create
        self._shut: set = set()

    def _route(self, bracket_idx: int, ops: List[Operation]) -> List[Operation]:
        out: List[Operation] = []
        for op in ops:
            if isinstance(op, Create):
                self._pending.append(bracket_idx)
                out.append(op)
            elif isinstance(op, Shutdown):
                self._shut.add(bracket_idx)
                if len(self._shut) == len(self.brackets):
                    out.append(op)
            else:
                out.append(op)
        return out

    def initial_operations(self) -> List[Operation]:
        ops: List[Operation] = []
        for i, b in enumerate(self.brackets):
            ops.extend(self._route(i, b.initial_operations()))
        return ops

    def on_trial_created(self, request_id: int) -> List[Operation]:
        if not self._pending:
            raise RuntimeError(
                f"trial_created({request_id}) with no pending bracket create"
            )
        i = self._pending.pop(0)
        self.owner[request_id] = i
        return self._route(i, self.brackets[i].on_trial_created(request_id))

    def on_validation_completed(self, request_id, metric, units):
        i = self.owner[request_id]
        return self._route(
            i, self.brackets[i].on_validation_completed(request_id, metric, units)
        )

    def on_trial_closed(self, request_id):
        i = self.owner.get(request_id)
        if i is None:
            return []
        return self._route(i, self.brackets[i].on_trial_closed(request_id))

    def on_trial_exited_early(self, request_id, reason):
        i = self.owner[request_id]
        return self._route(
            i, self.brackets[i].on_trial_exited_early(request_id, reason)
        )

    def progress(self) -> float:
        if not self.brackets:
            return 1.0
        return sum(b.progress() for b in self.brackets) / len(self.brackets)

    def snapshot(self) -> Dict[str, Any]:
        return {
            **super().snapshot(),
            "brackets": [b.snapshot() for b in self.brackets],
            "owner": {str(k): v for k, v in self.owner.items()},
            "pending": self._pending,
            "shut": list(self._shut),
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        super().restore(snap)
        for b, bs in zip(self.brackets, snap["brackets"]):
            b.restore(bs)
        self.owner = {int(k): v for k, v in snap["owner"].items()}
        self._pending = list(snap["pending"])
        self._shut = set(snap["shut"])
