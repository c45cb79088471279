"""Retry with backoff for transient failures — the port's trimmed copy of
``determined_clone_tpu/utils/retry.py`` (what checkpoint storage needs).

A policy gives exponential backoff with full jitter: the delay before a
retry is drawn uniformly from ``[0, min(max_delay, base * mult**(n-1))]``.
The JAX module's deadlines, retry counters and metrics-registry hook
are not needed by storage and wait for the port's telemetry.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable, Tuple


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How a named class of operations retries. Frozen: share instances."""

    name: str
    max_attempts: int = 4
    base_delay_s: float = 0.1
    multiplier: float = 2.0
    max_delay_s: float = 5.0
    retryable: Tuple[type, ...] = (ConnectionError, TimeoutError, OSError)

    def backoff(self, failures: int) -> float:
        """Delay before the retry that follows the Nth failure (1-based)."""
        cap = min(self.max_delay_s,
                  self.base_delay_s * self.multiplier ** max(failures - 1, 0))
        return random.uniform(0.0, cap)


def retry_call(fn: Callable[..., Any], *args: Any, policy: RetryPolicy,
               **kwargs: Any) -> Any:
    """Call ``fn`` under ``policy``; re-raise the last failure once
    ``policy.max_attempts`` calls have failed. Only ``policy.retryable``
    exceptions are retried."""
    failures = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except policy.retryable:
            failures += 1
            if failures >= policy.max_attempts:
                raise
            time.sleep(policy.backoff(failures))
