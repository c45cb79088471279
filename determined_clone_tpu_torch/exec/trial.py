"""``ClusterInfo`` — the port's copy of the dataclass in
``determined_clone_tpu/exec/trial.py``: what a Core API function
entrypoint ``fn(core_context, cluster_info)`` receives, read from the
``DCT_*`` environment the agent sets (≈ the reference's
``det.get_cluster_info()``, harness/determined/_info.py:23-137).

The rest of that module — the entrypoint resolver, the master rendezvous
and the trial leg it runs — waits for the port's control-plane hooks
(``ROADMAP.md``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional


@dataclasses.dataclass
class ClusterInfo:
    master_host: str
    master_port: int
    allocation_id: str
    trial_id: int
    experiment_id: int
    rank: int
    world_size: int
    slots: int
    n_slices: int
    hparams: Dict[str, Any]
    target_units: int
    latest_checkpoint: Optional[str]
    experiment_config: Dict[str, Any]

    @staticmethod
    def from_env() -> "ClusterInfo":
        def need(name: str) -> str:
            v = os.environ.get(name)
            if v is None:
                raise RuntimeError(f"missing required env var {name}")
            return v

        return ClusterInfo(
            master_host=os.environ.get("DCT_MASTER_HOST", "127.0.0.1"),
            master_port=int(os.environ.get("DCT_MASTER_PORT", "8080")),
            allocation_id=need("DCT_ALLOCATION_ID"),
            trial_id=int(need("DCT_TRIAL_ID")),
            experiment_id=int(os.environ.get("DCT_EXPERIMENT_ID", "0")),
            rank=int(os.environ.get("DCT_RANK", "0")),
            world_size=int(os.environ.get("DCT_WORLD_SIZE", "1")),
            slots=int(os.environ.get("DCT_SLOTS", "1")),
            n_slices=int(os.environ.get("DCT_N_SLICES", "1")),
            hparams=json.loads(os.environ.get("DCT_HPARAMS", "{}")),
            target_units=int(os.environ.get("DCT_TARGET_UNITS", "0")),
            latest_checkpoint=os.environ.get("DCT_LATEST_CHECKPOINT") or None,
            experiment_config=json.loads(
                os.environ.get("DCT_EXPERIMENT_CONFIG", "{}")),
        )
