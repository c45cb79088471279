"""Custom searcher runners — user-defined SearchMethods driving experiments;
the port's copy of ``determined_clone_tpu/searcher/custom.py``.

≈ the reference's custom-search client (harness/determined/searcher/
_search_runner.py + _remote_search_runner.py over master/pkg/searcher/
custom_search.go:15-23): the user subclasses :class:`SearchMethod`
(searcher/base.py — the same interface the built-in methods implement) and a
runner connects it to an experiment:

- :class:`RemoteSearchRunner` — the method runs in the user's process and
  steers a CLUSTER experiment through the master's custom-search event
  queue (GET /api/v1/experiments/<id>/searcher/events →
  POST .../searcher/operations). ``session`` is any object with
  ``request(method, path, body=None)`` (and ``create_experiment`` for
  :meth:`RemoteSearchRunner.run`); the port has no master client yet.
- :class:`LocalSearchRunner` — the method drives a single-process local
  experiment (experiment/runner.py), no master involved.

Events mirror the C++ CustomSearchCpp record types: initial_operations,
trial_created, validation_completed, trial_exited_early.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Type

from determined_clone_tpu_torch.searcher.base import (
    Close,
    Create,
    Operation,
    Searcher,
    SearchMethod,
    Shutdown,
    ValidateAfter,
)

TERMINAL_STATES = {"COMPLETED", "ERRORED", "CANCELED"}


def ops_to_json(ops: List[Operation]) -> List[Dict[str, Any]]:
    """Serialize engine operations onto the master's wire format."""
    out: List[Dict[str, Any]] = []
    for op in ops:
        if isinstance(op, Create):
            out.append({"type": "create", "request_id": op.request_id,
                        "hparams": op.hparams})
        elif isinstance(op, ValidateAfter):
            out.append({"type": "validate_after", "request_id": op.request_id,
                        "units": op.length})
        elif isinstance(op, Close):
            out.append({"type": "close", "request_id": op.request_id})
        elif isinstance(op, Shutdown):
            out.append({"type": "shutdown", "failure": op.failure,
                        "cancel": op.cancel})
        else:  # pragma: no cover - exhaustive over the Operation union
            raise TypeError(f"unknown operation {op!r}")
    return out


class RemoteSearchRunner:
    """Runs a SearchMethod against a cluster experiment's event queue.

    The runner is resumable: it re-polls from event id 0 on restart and the
    master applies replayed operations idempotently (duplicate creates for
    existing request ids are no-ops; closes of terminal trials likewise).
    With ``trim_events=True`` the runner acknowledges processed events so the
    master drops them — bounding the event log for long searches — at the
    cost of replay-based resume (persist your own method state instead).
    """

    def __init__(self, method: SearchMethod, session: Any, *,
                 poll_interval: float = 0.5,
                 trim_events: bool = False) -> None:
        self.method = method
        self.engine = Searcher(method)
        self.session = session
        self.poll_interval = poll_interval
        self.trim_events = trim_events

    def run(self, config: Dict[str, Any], *,
            context: Optional[List[Dict[str, str]]] = None) -> int:
        """Create the experiment (config must say searcher.name=custom) and
        drive it to a terminal state; returns the experiment id."""
        searcher = config.get("searcher", {})
        if searcher.get("name") != "custom":
            raise ValueError("RemoteSearchRunner requires searcher.name="
                             f"'custom', got {searcher.get('name')!r}")
        exp = self.session.create_experiment(config, context=context)
        self.run_experiment(exp["id"])
        return exp["id"]

    def run_experiment(self, experiment_id: int) -> str:
        """Attach to an existing custom-search experiment; poll events, feed
        the method, post operations; returns the terminal state."""
        last_event = 0
        while True:
            out = self.session.request(
                "GET",
                f"/api/v1/experiments/{experiment_id}/searcher/events"
                f"?since={last_event}")
            state = out.get("state", "")
            events = out.get("events", [])
            ops: List[Operation] = []
            for event in events:
                last_event = max(last_event, int(event["id"]))
                ops.extend(self._dispatch(event))
            if ops or events:
                body: Dict[str, Any] = {"ops": ops_to_json(ops),
                                        "progress": self.method.progress()}
                if self.trim_events:
                    body["ack_through"] = last_event
                self.session.request(
                    "POST",
                    f"/api/v1/experiments/{experiment_id}/searcher/operations",
                    body)
            if state in TERMINAL_STATES:
                return state
            if not events:
                time.sleep(self.poll_interval)

    def _dispatch(self, event: Dict[str, Any]) -> List[Operation]:
        etype = event["type"]
        if etype == "initial_operations":
            return self.engine.initial_operations()
        if etype == "trial_created":
            return self.engine.trial_created(int(event["request_id"]))
        if etype == "validation_completed":
            return self.engine.validation_completed(
                int(event["request_id"]), float(event["metric"]),
                int(event["units"]))
        if etype == "trial_exited_early":
            return self.engine.trial_exited_early(
                int(event["request_id"]), "exited_early")
        if etype == "trial_closed":
            return self.engine.trial_closed(int(event["request_id"]))
        return []  # forward-compat: ignore unknown event types


class LocalSearchRunner:
    """Runs a SearchMethod over the single-process local orchestrator
    (≈ LocalSearchRunner, harness/determined/searcher/_search_runner.py:214)."""

    def __init__(self, method: SearchMethod) -> None:
        self.method = method

    def run(self, config: Any, trial_cls: Type[Any], *,
            storage_path: str, mesh: Optional[Any] = None,
            device: Any = "cuda") -> Any:
        from determined_clone_tpu_torch.experiment.runner import (
            LocalExperimentRunner,
        )

        runner = LocalExperimentRunner(
            config, trial_cls, storage_path=storage_path, mesh=mesh,
            method=self.method, device=device,
        )
        return runner.run()
