"""Python SDK — the `Determined` client object and typed refs; the
port's copy of ``determined_clone_tpu/sdk.py`` over the port's
``api/client.py`` ``MasterSession`` and its storage managers.

≈ the reference's harness/determined/common/experimental
(`determined.py:27` Determined, experiment.py ExperimentReference,
trial.py, checkpoint.py, model.py): a session-holding entry object whose
methods return lightweight refs wrapping the REST API.

    from determined_clone_tpu_torch.sdk import Determined
    d = Determined("127.0.0.1", 8080)
    exp = d.create_experiment(config, model_dir="./model_def")
    exp.wait()
    best = exp.top_checkpoint()
"""
from __future__ import annotations

import base64
import os
import time
from typing import Any, Dict, List, Optional

from determined_clone_tpu_torch.api.client import MasterSession

TERMINAL_STATES = {"COMPLETED", "ERRORED", "CANCELED"}


def read_context_dir(model_dir: str, max_bytes: int = 4 << 20) -> List[Dict[str, str]]:
    """Base64 file list for a model-def directory (≈ read_v1_context,
    harness/determined/common/context.py)."""
    out: List[Dict[str, str]] = []
    total = 0
    for root, dirs, files in os.walk(model_dir):
        dirs[:] = [d for d in dirs if not d.startswith((".", "__pycache__"))]
        for fname in sorted(files):
            if fname.endswith((".pyc", ".pyo")):
                continue
            full = os.path.join(root, fname)
            rel = os.path.relpath(full, model_dir)
            with open(full, "rb") as f:
                raw = f.read()
            total += len(raw)
            if total > max_bytes:
                raise ValueError(
                    f"context directory {model_dir} exceeds {max_bytes} bytes")
            out.append({
                "path": rel.replace(os.sep, "/"),
                "content_b64": base64.b64encode(raw).decode(),
            })
    return out


class TrialRef:
    def __init__(self, session: MasterSession, trial_id: int) -> None:
        self._session = session
        self.id = trial_id

    def describe(self) -> Dict[str, Any]:
        return self._session.get_trial(self.id)

    def kill(self) -> Dict[str, Any]:
        return self._session.kill_trial(self.id)

    def metrics(self, limit: int = 1000) -> List[Dict[str, Any]]:
        return self._session.trial_metrics(self.id, limit)

    def logs(self, limit: int = 1000) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for alloc_id in self._session.trial_log_allocations(self.id):
            out.extend(self._session.task_logs(alloc_id, limit))
        return out

    def checkpoints(self) -> List["CheckpointRef"]:
        exp_id = self.describe()["experiment_id"]
        records = self._session.get(
            f"/api/v1/experiments/{exp_id}/checkpoints")["checkpoints"]
        return [CheckpointRef(self._session, r["uuid"], r)
                for r in records if r["trial_id"] == self.id]


class CheckpointRef:
    def __init__(self, session: MasterSession, uuid: str,
                 record: Optional[Dict[str, Any]] = None) -> None:
        self._session = session
        self.uuid = uuid
        self._record = record

    @property
    def record(self) -> Dict[str, Any]:
        if self._record is None:
            self._record = self._session.get(f"/api/v1/checkpoints/{self.uuid}")
        return self._record

    def download(self, output_dir: str,
                 storage_config: Optional[Dict[str, Any]] = None) -> str:
        """Pull checkpoint files from the storage backend to output_dir.
        storage_config defaults to the owning experiment's config
        (≈ det checkpoint download, cli/checkpoint.py)."""
        from determined_clone_tpu_torch.config.experiment import (
            CheckpointStorageConfig,
        )
        from determined_clone_tpu_torch.storage import build

        if storage_config is None:
            exp_id = self.record["experiment_id"]
            exp = self._session.get_experiment(exp_id)["experiment"]
            storage_config = exp["config"].get("checkpoint_storage")
        if not storage_config:
            raise ValueError("no checkpoint_storage config available")
        manager = build(CheckpointStorageConfig.from_dict(storage_config))
        manager.download(self.uuid, output_dir)
        # digest-verify what arrived against the checkpoint's manifest —
        # a torn download should fail loudly here, not at model load
        from determined_clone_tpu_torch.core._checkpoint import (
            verify_manifest_digests,
        )

        verify_manifest_digests(output_dir, self.uuid, require_all=True)
        return output_dir


class ExperimentRef:
    def __init__(self, session: MasterSession, exp_id: int) -> None:
        self._session = session
        self.id = exp_id

    def describe(self) -> Dict[str, Any]:
        return self._session.get_experiment(self.id)

    @property
    def state(self) -> str:
        return self.describe()["experiment"]["state"]

    def kill(self) -> None:
        self._session.kill_experiment(self.id)

    def pause(self) -> None:
        self._session.pause_experiment(self.id)

    def activate(self) -> None:
        self._session.activate_experiment(self.id)

    def archive(self, archived: bool = True) -> None:
        self._session.archive_experiment(self.id, archive=archived)

    def delete(self) -> None:
        self._session.delete_experiment(self.id)

    def trials(self) -> List[TrialRef]:
        return [TrialRef(self._session, t["id"])
                for t in self.describe()["trials"]]

    def wait(self, timeout: float = 600, interval: float = 1.0) -> str:
        """Block until the experiment reaches a terminal state."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            state = self.state
            if state in TERMINAL_STATES:
                return state
            time.sleep(interval)
        raise TimeoutError(f"experiment {self.id} not done after {timeout}s")

    def checkpoints(self) -> List[CheckpointRef]:
        records = self._session.get(
            f"/api/v1/experiments/{self.id}/checkpoints")["checkpoints"]
        return [CheckpointRef(self._session, r["uuid"], r) for r in records]

    def top_checkpoint(self) -> Optional[CheckpointRef]:
        """Latest checkpoint of the best trial (by searcher metric)."""
        detail = self.describe()
        smaller = detail["experiment"]["config"].get(
            "searcher", {}).get("smaller_is_better", True)
        best = None
        for t in detail["trials"]:
            if not t.get("has_metric"):
                continue
            if best is None or (
                    t["best_metric"] < best["best_metric"] if smaller
                    else t["best_metric"] > best["best_metric"]):
                best = t
        if not best or not best.get("latest_checkpoint"):
            return None
        return CheckpointRef(self._session, best["latest_checkpoint"])


class ModelRef:
    def __init__(self, session: MasterSession, name: str) -> None:
        self._session = session
        self.name = name

    def describe(self) -> Dict[str, Any]:
        return self._session.get_model(self.name)

    def register_version(self, checkpoint_uuid: str, **kwargs: Any
                         ) -> Dict[str, Any]:
        return self._session.register_model_version(
            self.name, checkpoint_uuid, **kwargs)

    def versions(self) -> List[Dict[str, Any]]:
        return self.describe()["versions"]


class Determined:
    """≈ determined.experimental.Determined (determined.py:27)."""

    def __init__(self, master_host: str = "127.0.0.1",
                 master_port: int = 8080) -> None:
        self._session = MasterSession(master_host, master_port)

    @property
    def session(self) -> MasterSession:
        return self._session

    def login(self, username: str, password: str = "") -> Dict[str, Any]:
        return self._session.login(username, password)

    # -- experiments -------------------------------------------------------

    def create_experiment(self, config: Dict[str, Any],
                          model_dir: Optional[str] = None) -> ExperimentRef:
        body: Dict[str, Any] = {"config": config}
        if model_dir:
            body["context"] = read_context_dir(model_dir)
        exp = self._session.post("/api/v1/experiments", body)["experiment"]
        return ExperimentRef(self._session, exp["id"])

    def get_experiment(self, exp_id: int) -> ExperimentRef:
        return ExperimentRef(self._session, exp_id)

    def list_experiments(self) -> List[Dict[str, Any]]:
        return self._session.list_experiments()

    def get_trial(self, trial_id: int) -> TrialRef:
        return TrialRef(self._session, trial_id)

    def get_checkpoint(self, uuid: str) -> CheckpointRef:
        return CheckpointRef(self._session, uuid)

    # -- registry ----------------------------------------------------------

    def create_model(self, name: str, **kwargs: Any) -> ModelRef:
        self._session.create_model(name, **kwargs)
        return ModelRef(self._session, name)

    def get_model(self, name: str) -> ModelRef:
        return ModelRef(self._session, name)

    def list_models(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return self._session.list_models(name)

    # -- workspaces --------------------------------------------------------

    def create_workspace(self, name: str) -> Dict[str, Any]:
        return self._session.create_workspace(name)

    def list_workspaces(self) -> List[Dict[str, Any]]:
        return self._session.list_workspaces()
