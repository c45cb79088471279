"""Versioned experiment-config shims: v0 spellings → current (v1) — the
port's copy of ``determined_clone_tpu/config/shims.py``, with its notes
word for word.

≈ the reference's expconf versioning (schemas/expconf/v0 + legacy shims,
master/pkg/schemas/expconf/legacy.go): old configs keep submitting
unchanged — ``shim()`` rewrites legacy spellings into the current schema
before validation, and records what it changed so the API can surface
deprecation notices. A config opts into a version with ``config_version``
(absent = 0, the permissive legacy format; shimmed configs come out as 1).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Tuple

CURRENT_VERSION = 1

# v0 searcher names that became adaptive_asha (the reference retired
# adaptive/adaptive_simple/sync_halving the same way)
_LEGACY_ADAPTIVE = {"adaptive", "adaptive_simple", "sync_halving"}


def _shim_length(value: Any, notes: List[str], where: str) -> Any:
    # v0 allowed a bare integer meaning batches
    if isinstance(value, int) and not isinstance(value, bool):
        notes.append(f"{where}: bare integer lengths are v0; "
                     f"use {{'batches': {value}}}")
        return {"batches": value}
    return value


def shim(raw: Dict[str, Any]) -> Tuple[Dict[str, Any], List[str]]:
    """Returns (current-version config, deprecation notes). Input is not
    mutated. A config already at CURRENT_VERSION passes through untouched
    (no silent rewriting of modern configs)."""
    version = raw.get("config_version", 0)
    if version >= CURRENT_VERSION:
        return raw, []

    cfg = copy.deepcopy(raw)
    notes: List[str] = []

    searcher = cfg.get("searcher")
    if isinstance(searcher, dict):
        name = searcher.get("name")
        if name in _LEGACY_ADAPTIVE:
            searcher["name"] = "adaptive_asha"
            notes.append(f"searcher.name {name!r} is v0; shimmed to "
                         "'adaptive_asha'")
        if "max_steps" in searcher and "max_length" not in searcher:
            searcher["max_length"] = {"batches": searcher.pop("max_steps")}
            notes.append("searcher.max_steps is v0; shimmed to "
                         "max_length.batches")
        if "max_length" in searcher:
            searcher["max_length"] = _shim_length(
                searcher["max_length"], notes, "searcher.max_length")
        if "smaller_is_better" not in searcher and "metric" in searcher:
            pass  # defaulting, not a shim

    for period in ("min_validation_period", "min_checkpoint_period"):
        if period in cfg:
            cfg[period] = _shim_length(cfg[period], notes, period)

    # v0 `batches_per_step` became scheduling_unit
    if "batches_per_step" in cfg and "scheduling_unit" not in cfg:
        cfg["scheduling_unit"] = cfg.pop("batches_per_step")
        notes.append("batches_per_step is v0; shimmed to scheduling_unit")

    # v0 nested `optimizations` block: horovod-era keys (aggregation_
    # frequency etc.) map onto nothing (XLA owns fusion); keep submissions
    # working by dropping those with a note, while the TPU-native keys
    # (prefetch_depth, steps_per_dispatch) pass through to the v1 block
    if "optimizations" in cfg:
        opt = cfg.pop("optimizations")
        kept = {}
        if isinstance(opt, dict):
            kept = {key: opt[key]
                    for key in ("prefetch_depth", "steps_per_dispatch")
                    if key in opt}
            dropped = sorted(set(opt) - set(kept))
        else:
            dropped = ["<non-mapping optimizations>"]
        if dropped:
            notes.append(f"optimizations keys {dropped} are v0 and have no "
                         "TPU equivalent (XLA owns fusion/aggregation); "
                         "ignored")
        if kept:
            cfg["optimizations"] = kept

    # v0 `telemetry` block became `observability` (matching the subsystem
    # package name); same keys, straight rename
    if "telemetry" in cfg:
        tel = cfg.pop("telemetry")
        if "observability" in cfg:
            raise ValueError(
                "config sets both legacy telemetry and observability "
                "blocks; remove the legacy key")
        cfg["observability"] = tel
        notes.append("top-level telemetry is v0; shimmed to observability")

    # flat `type: cas` form (a bare host_path/container_path instead of a
    # nested inner backend block) is the v0 spelling; rewrite it to the
    # explicit `inner:` form the v1 schema documents
    storage = cfg.get("checkpoint_storage")
    if (isinstance(storage, dict) and storage.get("type") == "cas"
            and "inner" not in storage):
        if storage.get("host_path"):
            storage["inner"] = {
                "type": "shared_fs",
                "host_path": storage.pop("host_path"),
            }
            if storage.get("storage_path"):
                storage["inner"]["storage_path"] = storage.pop(
                    "storage_path")
            notes.append("checkpoint_storage flat cas host_path is v0; "
                         "shimmed to inner shared_fs block")
        elif storage.get("container_path"):
            storage["inner"] = {
                "type": "directory",
                "container_path": storage.pop("container_path"),
            }
            notes.append("checkpoint_storage flat cas container_path is "
                         "v0; shimmed to inner directory block")

    # v0 flat `slots` became resources.slots_per_trial
    if "slots" in cfg:
        slots = cfg.pop("slots")
        resources = cfg.setdefault("resources", {})
        existing = resources.get("slots_per_trial")
        if existing is not None and existing != slots:
            # silently preferring either value would lie to the user about
            # their gang size — make the conflict explicit
            raise ValueError(
                f"config sets both legacy top-level slots ({slots}) and "
                f"resources.slots_per_trial ({existing}); remove the "
                "legacy key")
        resources.setdefault("slots_per_trial", slots)
        notes.append("top-level slots is v0; shimmed to "
                     "resources.slots_per_trial")

    cfg["config_version"] = CURRENT_VERSION
    return cfg, notes
