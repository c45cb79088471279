"""Named fault points + process-global plan activation — the port's copy
of ``determined_clone_tpu/faults/__init__.py``. The training loop fires
``training.pre_step``, ``training.post_step`` and
``training.checkpoint_save``; storage fires ``storage.upload``,
``storage.download`` and ``storage.commit``; checkpoints fire the
``checkpoint.*`` points.

Call sites sprinkle ``faults.point("storage.upload")`` at the places where
real deployments fail; with no plan active that is one global load and a
``None`` check — free. Activating a seeded :class:`FaultPlan` (from a
config ``faults:`` block or the ``DCT_FAULT_PLAN`` env var) turns chosen
points into deterministic failures. See docs/fault_tolerance.md for the
point catalog and the rule schema.

Plans are cached by their defining payload so that re-activation across
training legs (the experiment runner re-enters ``core.init`` after every
restart) keeps hit counters — a ``nth: 1, times: 1`` rule fires once per
*process*, not once per leg, which is what makes "fail the first attempt,
succeed after restart" scenarios expressible.
"""
from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, Iterator, Optional

from determined_clone_tpu_torch.faults.core import (  # noqa: F401  (re-exports)
    ACTIONS,
    FaultInjected,
    FaultPlan,
    FaultRule,
    InjectedConnectionError,
    InjectedIOError,
)

_PLAN: Optional[FaultPlan] = None
# payload-keyed caches: same faults block / env string -> same plan object,
# so rule counters survive repeated activation (see module docstring)
_CONFIG_PLANS: Dict[str, FaultPlan] = {}
_ENV_PLANS: Dict[str, FaultPlan] = {}


def point(name: str) -> None:
    """A named fault point. No-op (one None check) unless a plan is active."""
    plan = _PLAN
    if plan is not None:
        plan.hit(name)


def truncate_bytes(name: str) -> Optional[int]:
    """Bytes to keep if an active truncate rule fires at ``name``.

    Only call sites that can express a torn write (storage per-file copy)
    consult this; ``point()`` ignores truncate rules entirely.
    """
    plan = _PLAN
    if plan is None:
        return None
    return plan.truncate_bytes(name)


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def activate(plan: FaultPlan, registry: Any = None) -> FaultPlan:
    """Make ``plan`` the process-wide active plan."""
    global _PLAN
    if registry is not None:
        plan.registry = registry
    _PLAN = plan
    return plan


def deactivate(plan: Optional[FaultPlan] = None) -> None:
    """Clear the active plan (only if it is ``plan``, when given)."""
    global _PLAN
    if plan is None or _PLAN is plan:
        _PLAN = None


def plan_from_dict(raw: Dict[str, Any]) -> FaultPlan:
    return FaultPlan(list(raw.get("rules") or []), seed=int(raw.get("seed", 0)))


def activate_from_config(block: Dict[str, Any],
                         registry: Any = None) -> FaultPlan:
    """Activate the (cached) plan for a config ``faults:`` block."""
    key = json.dumps(block, sort_keys=True)
    plan = _CONFIG_PLANS.get(key)
    if plan is None:
        plan = _CONFIG_PLANS[key] = plan_from_dict(block)
    return activate(plan, registry)


def install_from_env(env: Optional[Dict[str, str]] = None
                     ) -> Optional[FaultPlan]:
    """Activate a plan from ``DCT_FAULT_PLAN`` (inline JSON, or a file path).

    Idempotent per payload: repeated calls (one per training leg) reuse the
    cached plan, keeping counters. Returns None when the var is unset.
    """
    raw = (env if env is not None else os.environ).get(
        "DCT_FAULT_PLAN", "").strip()
    if not raw:
        return None
    plan = _ENV_PLANS.get(raw)
    if plan is None:
        text = raw
        if not text.startswith("{"):
            with open(text) as f:
                text = f.read()
        plan = _ENV_PLANS[raw] = plan_from_dict(json.loads(text))
    return activate(plan)


@contextlib.contextmanager
def plan_active(raw: Dict[str, Any], registry: Any = None
                ) -> Iterator[FaultPlan]:
    """Test helper: activate a fresh plan for the duration of a block."""
    plan = activate(plan_from_dict(raw), registry)
    try:
        yield plan
    finally:
        deactivate(plan)


def reset() -> None:
    """Deactivate and drop all cached plans (tests only)."""
    global _PLAN
    _PLAN = None
    _CONFIG_PLANS.clear()
    _ENV_PLANS.clear()
