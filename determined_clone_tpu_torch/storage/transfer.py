"""Bounded parallel transfer pool for checkpoint storage I/O — the port's
copy of ``determined_clone_tpu/storage/transfer.py`` (pure Python there
too).

One process-wide pool of named daemon worker threads ("dct-xfer-<n>")
shared by every StorageManager: SharedFS uploads fan per-file copies over
it. Bounding the pool keeps a 1000-file upload from opening 1000
concurrent streams against the backend.

Design notes:

- **Caller participation.** ``run()`` executes tasks from its own batch on
  the calling thread while workers help, so a nested ``run()`` (a worker
  executing a CAS chunk task that itself calls ``SharedFSStorageManager.
  upload``) can never deadlock — worst case the whole batch runs inline on
  the caller.
- **Workers are process-lifetime.** They are daemon threads parked on the
  task queue between batches; tests exempt the "dct-xfer" prefix in the
  conftest thread-leak fixture the same way they would a shared executor.
- **Determinism escape hatch.** ``TransferPool(workers=0)`` (or
  ``DCT_TRANSFER_WORKERS=0``) runs every batch inline and in order, which
  chaos tests use when a fault rule targets the Nth hit of a transfer
  point.

Retries stay the caller's job: storage code wraps each task in its
``RetryPolicy`` (utils/retry.py) before submitting, so the pool itself
never sleeps.
"""
from __future__ import annotations

import collections
import os
import queue
import threading
from typing import Any, Callable, List, Optional

_STOP = object()


class _Batch:
    """One run()'s tasks: a work deque plus a completion latch."""

    def __init__(self, tasks: List[Callable[[], Any]]) -> None:
        self._pending = collections.deque(enumerate(tasks))
        self._lock = threading.Lock()
        self._done = threading.Condition(self._lock)
        self._left = len(tasks)
        self.results: List[Any] = [None] * len(tasks)
        self.error: Optional[BaseException] = None

    def take(self):
        with self._lock:
            return self._pending.popleft() if self._pending else None

    def finish(self, idx: int, result: Any,
               err: Optional[BaseException]) -> None:
        with self._lock:
            self.results[idx] = result
            if err is not None and self.error is None:
                self.error = err
            self._left -= 1
            if self._left == 0:
                self._done.notify_all()

    def run_one(self, item) -> None:
        idx, fn = item
        try:
            self.finish(idx, fn(), None)
        except BaseException as e:  # noqa: BLE001 - re-raised from run()
            self.finish(idx, None, e)

    def wait(self) -> None:
        with self._lock:
            while self._left:
                self._done.wait()


class TransferPool:
    """Bounded pool of named daemon threads executing transfer callables.

    ``run(tasks)`` blocks until every task settled, then raises the first
    error (all tasks still ran — per-file/per-chunk progress is kept even
    when one transfer dies, matching the storage layer's per-file resume
    semantics) or returns the results in task order.
    """

    def __init__(self, workers: int = 4,
                 name_prefix: str = "dct-xfer") -> None:
        if workers < 0:
            raise ValueError(f"workers must be >= 0, got {workers}")
        self.workers = workers
        self._name_prefix = name_prefix
        self._queue: "queue.Queue[Any]" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._closed = False

    def _ensure_workers(self) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError("TransferPool is shut down")
            while len(self._threads) < self.workers:
                t = threading.Thread(
                    target=self._worker, daemon=True,
                    name=f"{self._name_prefix}-{len(self._threads)}")
                t.start()
                self._threads.append(t)

    def _worker(self) -> None:
        while True:
            batch = self._queue.get()
            if batch is _STOP:
                return
            # drain the batch: wake tokens are capped at the pool size, so
            # a worker that stopped after one task would leave the rest of
            # a large batch to the caller, serializing it
            item = batch.take()
            while item is not None:
                batch.run_one(item)
                item = batch.take()

    def run(self, tasks: List[Callable[[], Any]]) -> List[Any]:
        if not tasks:
            return []
        batch = _Batch(tasks)
        if self.workers > 0 and len(tasks) > 1:
            self._ensure_workers()
            # one wake token per worker (capped at batch size); each woken
            # worker drains tasks until the batch deque is empty
            for _ in range(min(len(tasks), self.workers)):
                self._queue.put(batch)
        item = batch.take()
        while item is not None:
            batch.run_one(item)
            item = batch.take()
        batch.wait()
        if batch.error is not None:
            raise batch.error
        return batch.results

    def shutdown(self) -> None:
        """Stop and join the workers. The pool is unusable afterwards."""
        with self._lock:
            self._closed = True
            threads, self._threads = self._threads, []
        for _ in threads:
            self._queue.put(_STOP)
        for t in threads:
            t.join()


_pool: Optional[TransferPool] = None
_pool_lock = threading.Lock()


def _env_workers(default: int = 4) -> int:
    try:
        return int(os.environ.get("DCT_TRANSFER_WORKERS", default))
    except ValueError:
        return default


def get_pool() -> TransferPool:
    """The process-wide shared pool (lazily created; DCT_TRANSFER_WORKERS
    sizes it, 0 = inline/sequential)."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = TransferPool(workers=_env_workers())
        return _pool


def reset_pool() -> None:
    """Shut down and drop the shared pool (tests; re-reads the env)."""
    global _pool
    with _pool_lock:
        pool, _pool = _pool, None
    if pool is not None:
        pool.shutdown()
