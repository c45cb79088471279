"""Retry with backoff for transient failures — the port's trimmed copy of
``determined_clone_tpu/utils/retry.py`` (what checkpoint storage, serving
admission, the fleet router and the experiment runner's restarts need).

A policy gives exponential backoff with full jitter: the delay before a
retry is drawn uniformly from ``[0, min(max_delay, base * mult**(n-1))]``
(``jitter="none"``: the cap itself), and an optional ``deadline_s``
bounds the whole call. The JAX module's retry counters and its
metrics-registry hook are not ported.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How a named class of operations retries. Frozen: share instances."""

    name: str
    max_attempts: int = 4
    base_delay_s: float = 0.1
    multiplier: float = 2.0
    max_delay_s: float = 5.0
    jitter: str = "full"  # "full" | "none"
    deadline_s: Optional[float] = None
    retryable: Tuple[type, ...] = (ConnectionError, TimeoutError, OSError)

    def backoff(self, failures: int,
                rng: Optional[random.Random] = None) -> float:
        """Delay before the retry that follows the Nth failure (1-based)."""
        cap = min(self.max_delay_s,
                  self.base_delay_s * self.multiplier ** max(failures - 1, 0))
        if self.jitter == "none":
            return cap
        return (rng if rng is not None else random).uniform(0.0, cap)


def retry_call(fn: Callable[..., Any], *args: Any, policy: RetryPolicy,
               **kwargs: Any) -> Any:
    """Call ``fn`` under ``policy``; re-raise the last failure once
    ``policy.max_attempts`` calls have failed or the deadline has passed.
    Only ``policy.retryable`` exceptions are retried."""
    deadline = (time.monotonic() + policy.deadline_s
                if policy.deadline_s is not None else None)
    failures = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except policy.retryable:
            failures += 1
            if failures >= policy.max_attempts:
                raise
            delay = policy.backoff(failures)
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise
                delay = min(delay, remaining)
            time.sleep(delay)


def sleep_backoff(policy: RetryPolicy, failures: int,
                  rng: Optional[random.Random] = None) -> float:
    """Backoff sleep for loops whose retry structure lives elsewhere (the
    experiment runner's restart queue); returns the delay slept."""
    delay = policy.backoff(max(failures, 1), rng)
    time.sleep(delay)
    return delay
