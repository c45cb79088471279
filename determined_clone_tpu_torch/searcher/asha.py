"""ASHA — asynchronous successive halving (reference: master/pkg/searcher/
asha.go:56 promote-based, asha_stopping.go stopping-based); the port's
copy of ``determined_clone_tpu/searcher/asha.py``.

Rung r (r = 0..num_rungs-1) has a cumulative unit target of
``max_units / divisor^(num_rungs-1-r)`` — the bottom rung trains briefly,
the top rung to max_length. Trials that finish rung r pause; whenever a rung
has recorded ``divisor × (promoted_so_far + 1)`` results, its best unpromoted
trial is promoted (ValidateAfter the next rung's target). The stopping
variant (``stop_once``) never pauses: a trial continues unless it is in the
bottom (1 - 1/divisor) of its rung.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from determined_clone_tpu_torch.searcher.base import (
    Close,
    Create,
    Operation,
    SearchMethod,
    Shutdown,
    ValidateAfter,
)


class ASHASearch(SearchMethod):
    def __init__(self, config, space, seed=0, *,
                 max_units: Optional[int] = None,
                 num_rungs: Optional[int] = None,
                 max_trials: Optional[int] = None,
                 max_concurrent: Optional[int] = None):
        super().__init__(config, space, seed)
        if max_units is None:
            if config.max_time is not None:
                max_units = int(config.max_time)
            elif config.max_length is not None:
                max_units = config.max_length.value
            else:
                raise ValueError("asha needs max_time or max_length")
        self.max_units = max_units
        self.divisor = config.divisor
        self.num_rungs = num_rungs if num_rungs is not None else config.num_rungs
        self.max_trials = max_trials if max_trials is not None else config.max_trials
        self.max_concurrent = (
            max_concurrent if max_concurrent is not None
            else min(config.max_concurrent_trials or 16, self.max_trials)
        )
        self.smaller_is_better = config.smaller_is_better
        self.stop_once = config.stop_once

        self.rung_targets = [
            max(1, int(round(self.max_units / self.divisor ** (self.num_rungs - 1 - r))))
            for r in range(self.num_rungs)
        ]
        # dedupe targets that collide after rounding
        for r in range(1, self.num_rungs):
            if self.rung_targets[r] <= self.rung_targets[r - 1]:
                self.rung_targets[r] = self.rung_targets[r - 1] + 1
        self.rung_targets[-1] = max(self.rung_targets[-1], self.max_units)

        # state
        self.created = 0
        self.started = 0  # on_trial_created calls; guards premature shutdown
        self.closed: set = set()
        # per rung: list of [signed_metric, rid] sorted best-first lazily
        self.rungs: List[List[List[float]]] = [[] for _ in range(self.num_rungs)]
        self.promoted: List[set] = [set() for _ in range(self.num_rungs)]
        self.trial_rung: Dict[int, int] = {}
        self.done = False

    # -- helpers ------------------------------------------------------------

    def _sign(self, metric: float) -> float:
        return metric if self.smaller_is_better else -metric

    def _rung_of(self, units: int) -> int:
        for r, t in enumerate(self.rung_targets):
            if units <= t:
                return r
        return self.num_rungs - 1

    def _create_trial(self) -> List[Operation]:
        self.created += 1
        return [Create(-1, self.space.sample(self.rng))]

    def _promotions(self, r: int) -> List[Operation]:
        """Emit promotions a rung is now entitled to (async rule)."""
        if r >= self.num_rungs - 1:
            return []
        ops: List[Operation] = []
        records = sorted(self.rungs[r], key=lambda m: m[0])
        allowed = len(records) // self.divisor
        while len(self.promoted[r]) < allowed:
            candidate = next(
                (rid for metric, rid in records
                 if rid not in self.promoted[r] and rid not in self.closed),
                None,
            )
            if candidate is None:
                break
            self.promoted[r].add(int(candidate))
            self.trial_rung[int(candidate)] = r + 1
            ops.append(ValidateAfter(int(candidate), self.rung_targets[r + 1]))
        return ops

    def _maybe_finish(self) -> List[Operation]:
        """When the budget is spent and nothing can promote, close paused
        trials and shut down."""
        if (self.done or self.created < self.max_trials
                or self.started < self.created):
            return []
        live = set(self.trial_rung) - self.closed
        # a trial is 'active' if it still has an outstanding ValidateAfter:
        # i.e. it was promoted into its current rung but hasn't reported there.
        pending = {
            rid for rid in live
            if not any(rid == int(rec[1]) for rec in self.rungs[self.trial_rung[rid]])
        }
        if pending:
            return []
        # all live trials are paused; no promotions were possible
        ops: List[Operation] = [Close(rid) for rid in sorted(live)]
        self.closed |= live
        ops.append(Shutdown())
        self.done = True
        return ops

    # -- SearchMethod -------------------------------------------------------

    def initial_operations(self) -> List[Operation]:
        ops: List[Operation] = []
        for _ in range(min(self.max_concurrent, self.max_trials)):
            ops.extend(self._create_trial())
        return ops

    def on_trial_created(self, request_id: int) -> List[Operation]:
        self.started += 1
        self.trial_rung[request_id] = 0
        return [ValidateAfter(request_id, self.rung_targets[0])]

    def on_validation_completed(self, request_id: int, metric: float,
                                units: int) -> List[Operation]:
        r = self._rung_of(units)
        self.trial_rung[request_id] = r
        self.rungs[r].append([self._sign(metric), request_id])
        ops: List[Operation] = []

        if r == self.num_rungs - 1:
            # finished the top rung: done
            self.closed.add(request_id)
            ops.append(Close(request_id))
            if self.created < self.max_trials:
                ops.extend(self._create_trial())
        elif self.stop_once:
            # stopping rule: continue iff in the top 1/divisor of this rung
            records = sorted(self.rungs[r], key=lambda m: m[0])
            rank = next(i for i, rec in enumerate(records)
                        if int(rec[1]) == request_id)
            keep = max(1, len(records) // self.divisor)
            if rank < keep:
                self.trial_rung[request_id] = r + 1
                ops.append(ValidateAfter(request_id, self.rung_targets[r + 1]))
            else:
                self.closed.add(request_id)
                ops.append(Close(request_id))
                if self.created < self.max_trials:
                    ops.extend(self._create_trial())
        else:
            # promote-based: this trial pauses; promotions may release it or
            # a better-paused peer. A paused (not promoted) trial frees its
            # slot for a new create.
            promotions = self._promotions(r)
            ops.extend(promotions)
            if (self.created < self.max_trials
                    and not any(isinstance(o, ValidateAfter)
                                and o.request_id == request_id
                                for o in promotions)):
                ops.extend(self._create_trial())

        ops.extend(self._maybe_finish())
        return ops

    def on_trial_exited_early(self, request_id: int, reason: str
                              ) -> List[Operation]:
        self.closed.add(request_id)
        ops: List[Operation] = []
        if self.created < self.max_trials:
            ops.extend(self._create_trial())
        ops.extend(self._maybe_finish())
        return ops

    def progress(self) -> float:
        if self.done:
            return 1.0
        total_units = self.max_trials * self.rung_targets[0]  # lower bound
        spent = sum(
            self.rung_targets[self.trial_rung.get(int(rid), 0)]
            for rung in self.rungs for _, rid in rung
        )
        return min(0.99, spent / max(1, total_units * 2))

    def snapshot(self) -> Dict[str, Any]:
        return {
            **super().snapshot(),
            "created": self.created,
            "started": self.started,
            "closed": list(self.closed),
            "rungs": self.rungs,
            "promoted": [list(p) for p in self.promoted],
            "trial_rung": {str(k): v for k, v in self.trial_rung.items()},
            "done": self.done,
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        super().restore(snap)
        self.created = snap["created"]
        self.started = snap.get("started", snap["created"])
        self.closed = set(snap["closed"])
        self.rungs = snap["rungs"]
        self.promoted = [set(p) for p in snap["promoted"]]
        self.trial_rung = {int(k): v for k, v in snap["trial_rung"].items()}
        self.done = snap["done"]
