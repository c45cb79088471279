"""PreemptContext — cooperative preemption; the port's copy of
``determined_clone_tpu/core/_preempt.py``.

Equivalent of the reference's _preempt.py:15-230: a background watcher
long-polls a preemption source; ``should_preempt()`` is chief-coordinated so
the whole gang exits together (PreemptMode semantics). On TPU the stakes are
higher than the reference's chief-only decision: all hosts of a slice must
agree before tearing down the XLA world, so the chief's decision is
broadcast over the control plane — then the trainer saves and exits.
Poll failures are counted on the watcher and, given a metrics registry,
in its ``preempt_poll_failures`` counter.
"""
from __future__ import annotations

import enum
import logging
import os
import threading
import time
from typing import Any, Optional

from determined_clone_tpu_torch.core._distributed import DistributedContext

logger = logging.getLogger(__name__)

# a broken source fails every poll; one warning per window, not per poll
_WARN_INTERVAL_S = 60.0


class PreemptMode(enum.Enum):
    # chief polls; should_preempt() is a collective that broadcasts the
    # chief's answer (the default, and the only safe mode for pjit worlds)
    WORKERS_ASK_CHIEF = "workers_ask_chief"
    # every rank polls independently (for embarrassingly-parallel tasks)
    CHIEF_ONLY = "chief_only"


class PreemptionSource:
    """Where preemption signals come from: master long-poll on-cluster,
    a flag file locally (also how SLURM/SIGTERM forwarding lands)."""

    def poll(self) -> bool:
        raise NotImplementedError


class FilePreemptionSource(PreemptionSource):
    def __init__(self, path: str) -> None:
        self.path = path

    def poll(self) -> bool:
        return os.path.exists(self.path)


class NeverPreempt(PreemptionSource):
    def poll(self) -> bool:
        return False


class _Watcher(threading.Thread):
    def __init__(self, source: PreemptionSource, interval: float,
                 failure_counter: Any = None) -> None:
        super().__init__(daemon=True, name="preemption-watcher")
        self._source = source
        self._interval = interval
        self._flag = threading.Event()
        self._halt = threading.Event()
        self._failure_counter = failure_counter
        self._last_warn = float("-inf")
        self.poll_failures = 0

    def run(self) -> None:
        while not self._halt.is_set():
            try:
                if self._source.poll():
                    self._flag.set()
                    return
            except Exception as e:
                # transient poll failures must not kill training — but a
                # permanently broken source must be visible, so count every
                # failure and warn at most once per window
                self.poll_failures += 1
                if self._failure_counter is not None:
                    self._failure_counter.inc()
                now = time.monotonic()
                if now - self._last_warn >= _WARN_INTERVAL_S:
                    self._last_warn = now
                    logger.warning(
                        "preemption poll failed (%d failures so far): %s",
                        self.poll_failures, e)
            self._halt.wait(self._interval)

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def stop(self) -> None:
        self._halt.set()


class PreemptContext:
    def __init__(self, dist: DistributedContext,
                 source: Optional[PreemptionSource] = None, *,
                 mode: PreemptMode = PreemptMode.WORKERS_ASK_CHIEF,
                 poll_interval: float = 5.0,
                 registry: Any = None) -> None:
        self._dist = dist
        self._mode = mode
        self._source = source or NeverPreempt()
        self._watcher: Optional[_Watcher] = None
        self._interval = poll_interval
        self._signaled = threading.Event()
        self._failure_counter = registry.counter(
            "preempt_poll_failures",
            "preemption source polls that raised") if registry else None

    def start(self) -> "PreemptContext":
        if (self._mode == PreemptMode.WORKERS_ASK_CHIEF
                and self._dist.size > 1):
            # should_preempt() will be a collective; fail here, not after a
            # scheduling unit of training is about to be discarded.
            self._dist._require_transport()
        watch = self._mode == PreemptMode.CHIEF_ONLY or self._dist.is_chief
        if watch and not isinstance(self._source, NeverPreempt):
            self._watcher = _Watcher(self._source, self._interval,
                                     self._failure_counter)
            self._watcher.start()
        return self

    @property
    def poll_failures(self) -> int:
        """Failed source polls since start (0 when no watcher runs)."""
        return self._watcher.poll_failures if self._watcher else 0

    def close(self) -> None:
        if self._watcher:
            self._watcher.stop()

    def signal(self) -> None:
        """In-process preemption signal (SIGTERM handler hooks call this)."""
        self._signaled.set()

    def should_preempt(self) -> bool:
        local = self._signaled.is_set() or (
            self._watcher.preempted if self._watcher else False
        )
        if self._mode == PreemptMode.CHIEF_ONLY or self._dist.size == 1:
            return local
        # collective: chief's answer wins, everyone gets the same bool
        return bool(self._dist.broadcast(local if self._dist.is_chief else None))
