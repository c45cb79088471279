"""Autotune core: mesh-candidate enumeration + throughput measurement —
the port's copy of ``determined_clone_tpu/autotune/core.py``, which is
framework-free.

Mirrors dsat's structure (profile → generate candidates → measure →
rank): how the cards factor into mesh axes, whether to remat, per-card
batch. Infeasible candidates (out of memory, a shape that does not
split) are pruned like dsat's failed stages instead of failing the run.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence


def _factorizations(n: int, k: int) -> List[List[int]]:
    """All ordered factorizations of n into exactly k positive factors."""
    if k == 1:
        return [[n]]
    out: List[List[int]] = []
    for d in range(1, n + 1):
        if n % d == 0:
            for rest in _factorizations(n // d, k - 1):
                out.append([d] + rest)
    return out


def mesh_candidates(n_devices: int,
                    axes: Sequence[str] = ("dp", "fsdp", "tp"),
                    *, max_candidates: int = 64) -> List[Dict[str, int]]:
    """Enumerate mesh-shape candidates: every way the cards factor across
    the requested axes (axis size 1 = axis unused). Data-parallel-heavy
    shapes first — the usual best starting point."""
    cands = [dict(zip(axes, factors))
             for factors in _factorizations(n_devices, len(axes))]
    cands.sort(key=lambda c: -c.get("dp", 1))
    return cands[:max_candidates]


@dataclasses.dataclass
class AutotuneResult:
    mesh: Dict[str, int]
    remat: bool
    per_device_batch: int
    samples_per_sec: Optional[float]  # None = infeasible (OOM/compile fail)
    error: str = ""

    @property
    def feasible(self) -> bool:
        return self.samples_per_sec is not None


def autotune(
    measure: Callable[[Dict[str, int], bool, int], float],
    n_devices: int,
    *,
    axes: Sequence[str] = ("dp", "fsdp", "tp"),
    remat_options: Sequence[bool] = (True, False),
    batch_options: Sequence[int] = (8,),
    max_trials: int = 16,
    early_stop_after: int = 4,
) -> List[AutotuneResult]:
    """Run the local search loop (≈ dsat random/binary searching DS configs,
    here exhaustive-with-early-stop over mesh shapes).

    ``measure(mesh_axes, remat, per_device_batch) -> samples/sec`` runs a few
    real steps; raise to mark the candidate infeasible. Returns all results,
    best first. Stops early when ``early_stop_after`` successive candidates
    fail to improve on the best (dsat's patience-style pruning).
    """
    results: List[AutotuneResult] = []
    best: Optional[float] = None
    since_best = 0
    combos = itertools.product(
        mesh_candidates(n_devices, axes), remat_options, batch_options)
    for mesh_axes, remat, batch in itertools.islice(combos, max_trials):
        try:
            sps = measure(mesh_axes, remat, batch)
            results.append(AutotuneResult(mesh_axes, remat, batch, float(sps)))
            if best is None or sps > best:
                best = sps
                since_best = 0
            else:
                since_best += 1
        except Exception as exc:  # noqa: BLE001 - infeasible candidate
            results.append(
                AutotuneResult(mesh_axes, remat, batch, None, str(exc)))
            since_best += 1
        if since_best >= early_stop_after:
            break
    results.sort(key=lambda r: (r.samples_per_sec is None,
                                -(r.samples_per_sec or 0.0)))
    return results


def make_autotune_experiment_config(
    base_config: Dict[str, Any],
    n_devices: int,
    *,
    axes: Sequence[str] = ("dp", "fsdp", "tp"),
    remat_options: Sequence[bool] = (True,),
    max_length_batches: int = 20,
    max_candidates: int = 16,
) -> Dict[str, Any]:
    """Cluster mode (≈ dsat's generated search experiment, _run_dsat.py:99):
    a grid experiment whose hparams enumerate mesh candidates; each trial
    measures a few batches and reports samples_per_second; the searcher
    maximizes it. The trial reads ``context.get_hparam("mesh_json")`` to
    build its MeshSpec."""
    import json as _json

    candidates = mesh_candidates(n_devices, axes,
                                 max_candidates=max_candidates)
    cfg = dict(base_config)
    cfg["searcher"] = {
        "name": "grid",
        "metric": "samples_per_second",
        "smaller_is_better": False,
        "max_length": {"batches": max_length_batches},
    }
    hparams = dict(cfg.get("hyperparameters") or {})
    hparams["mesh_json"] = {
        "type": "categorical",
        "vals": [_json.dumps(c) for c in candidates],
    }
    hparams["remat"] = {
        "type": "categorical",
        "vals": [bool(r) for r in remat_options],
    }
    cfg["hyperparameters"] = hparams
    resources = dict(cfg.get("resources") or {})
    resources["slots_per_trial"] = n_devices
    cfg["resources"] = resources
    name = cfg.get("name", "experiment")
    cfg["name"] = f"{name}-autotune"
    return cfg
