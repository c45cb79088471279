"""Iteration-level continuous batching over the paged KV cache — the core
of ``determined_clone_tpu/serving/engine.py``'s ``InferenceEngine``.

Requests enter a bounded thread-safe queue. Every scheduler iteration
first admits queued requests into the running batch (one bucketed
prefill call for the newcomers), then runs ONE decode step for every
active sequence (one bucketed T=1 call), retiring finished sequences
immediately so their pool blocks and batch slots free up for the next
iteration. :meth:`InferenceEngine.run_static` is the run-to-completion
baseline on the same forward and pool.

Backpressure: a full queue raises :class:`ServerOverloaded`; KV-pool
exhaustion defers admission (requests wait in the queue until blocks
free), never evicts mid-decode.

The port runs PyTorch eagerly, so there is no jit cache: every call pads
to the :class:`BucketSpec` ladder all the same, which bounds the shapes
the forward sees. The pools are updated in place by ``forward_paged``
where the JAX engine donates them to its jitted call. This slice takes
the JAX engine's default configuration — prefix cache, chunked prefill
and speculative decoding off — and leaves out those three with the KV
store tiers, the executable cache, telemetry spans, fault points and
hot-swap.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.models import gpt
from determined_clone_tpu_torch.serving.bucketing import BucketSpec, bucket_for
from determined_clone_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    KVCacheConfig,
    init_kv_pools,
)


class ServerOverloaded(RuntimeError):
    """Admission rejected: queue full. Retryable — clients should back
    off and resubmit."""


@dataclasses.dataclass(frozen=True)
class Request:
    """One greedy (argmax) generation request."""
    prompt: Tuple[int, ...]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    request_id: str = ""


@dataclasses.dataclass
class RequestResult:
    request_id: str
    prompt_len: int
    tokens: List[int]
    finish_reason: str          # "length" | "eos"
    queue_wait_s: float
    prefill_s: float            # prefill device time it rode
    decode_s: float             # prefill-done → last token
    total_s: float              # submit → last token


@dataclasses.dataclass
class EngineStats:
    submitted: int
    rejected: int
    completed: int
    tokens_generated: int
    peak_active: int
    queue_depth: int
    free_blocks: int


class _Handle:
    """Future for one in-flight request; settled once."""

    def __init__(self, req: Request) -> None:
        self.req = req
        self._done = threading.Event()
        self._result: Optional[RequestResult] = None
        self._error: Optional[BaseException] = None
        self.submit_t = 0.0
        self.admit_t = 0.0
        self.prefill_s = 0.0
        self.prefill_done_t = 0.0

    def _finish(self, result: RequestResult) -> None:
        self._result = result
        self._done.set()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> RequestResult:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.req.request_id!r} not done in {timeout}s")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


class _Active:
    """Scheduler-private state of one running sequence."""

    __slots__ = ("handle", "blocks", "prompt_len", "out", "last_token")

    def __init__(self, handle: _Handle, blocks: List[int],
                 prompt_len: int) -> None:
        self.handle = handle
        self.blocks = blocks
        self.prompt_len = prompt_len
        self.out: List[int] = []
        self.last_token = -1


class InferenceEngine:
    """Continuous-batching GPT server over a paged KV cache.

    One scheduler thread (named ``serving-engine``) owns all device work;
    request threads only touch the queue and their handle. Use as a
    context manager or call :meth:`close` — the thread must be joined.
    ``params`` must already be on ``device``.
    """

    def __init__(self, params: gpt.Params, model_cfg: gpt.GPTConfig, *,
                 buckets: Optional[BucketSpec] = None,
                 cache: Optional[KVCacheConfig] = None,
                 max_queue_depth: int = 64,
                 device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params are on {table.device}, engine device "
                             f"is {self.device}")
        self.model_cfg = model_cfg
        self.buckets = buckets or BucketSpec.build(
            8, min(128, model_cfg.max_seq_len))
        if self.buckets.max_prefill_len > model_cfg.max_seq_len:
            raise ValueError(
                f"prefill bucket {self.buckets.max_prefill_len} exceeds "
                f"model max_seq_len {model_cfg.max_seq_len}")
        if cache is None:
            block = 16
            cache = KVCacheConfig(
                num_blocks=self.buckets.max_batch
                * max(1, math.ceil(model_cfg.max_seq_len / block)),
                block_size=block)
        self.cache = cache
        self.max_queue_depth = int(max_queue_depth)

        self._params = params
        self._allocator = BlockAllocator(cache)
        self._k_pool, self._v_pool = init_kv_pools(model_cfg, cache,
                                                   self.device)
        # fixed block-table width: every call sees the same W
        self._table_width = max(
            1, math.ceil(model_cfg.max_seq_len / cache.block_size))

        self._cond = threading.Condition()
        self._queue: collections.deque[_Handle] = collections.deque()
        self._active: List[_Active] = []
        self._prefilling: List[_Active] = []
        self._stop = False
        self._busy = False  # scheduler outside its wait with device work
        self._static = False  # run_static owns the pools
        self._fatal: Optional[BaseException] = None
        self._submitted = 0
        self._rejected = 0
        self._completed = 0
        self._total_tokens = 0
        self._peak_active = 0
        self._req_seq = 0
        self._thread = threading.Thread(target=self._run,
                                        name="serving-engine", daemon=True)
        self._thread.start()

    # -- client surface ----------------------------------------------------

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def close(self, timeout: float = 30.0) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout)

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16, *,
               eos_token_id: Optional[int] = None,
               request_id: Optional[str] = None) -> _Handle:
        """Enqueue one request. Raises ValueError for never-servable
        requests and ServerOverloaded when the queue is full."""
        prompt = tuple(int(t) for t in prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if len(prompt) > self.buckets.max_prefill_len:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the largest prefill "
                f"bucket {self.buckets.max_prefill_len}")
        total = len(prompt) + max_new_tokens
        if total > self.model_cfg.max_seq_len:
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds model "
                f"max_seq_len {self.model_cfg.max_seq_len}")
        if self.cache.blocks_needed(total) > self.cache.num_blocks:
            raise ValueError(
                f"{total} positions need {self.cache.blocks_needed(total)} "
                f"KV blocks; the pool has {self.cache.num_blocks}")
        with self._cond:
            if self._fatal is not None:
                raise RuntimeError("serving engine died") from self._fatal
            if self._stop:
                raise RuntimeError("serving engine is closed")
            if len(self._queue) >= self.max_queue_depth:
                self._rejected += 1
                raise ServerOverloaded(
                    f"queue full ({self.max_queue_depth} waiting)")
            self._req_seq += 1
            rid = request_id or f"req-{self._req_seq}"
            handle = _Handle(Request(prompt, int(max_new_tokens),
                                     eos_token_id, rid))
            handle.submit_t = time.monotonic()
            self._queue.append(handle)
            self._submitted += 1
            self._cond.notify_all()
        return handle

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16, *,
                 eos_token_id: Optional[int] = None,
                 timeout: Optional[float] = 120.0) -> RequestResult:
        return self.submit(prompt, max_new_tokens,
                           eos_token_id=eos_token_id).result(timeout)

    def stats(self) -> EngineStats:
        with self._cond:
            return EngineStats(
                submitted=self._submitted,
                rejected=self._rejected,
                completed=self._completed,
                tokens_generated=self._total_tokens,
                peak_active=self._peak_active,
                queue_depth=len(self._queue),
                free_blocks=self._allocator.free_blocks())

    def wait_idle(self, timeout: float = 60.0) -> None:
        """Block until nothing is queued or running and the scheduler's
        in-flight device call has finished."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while (self._queue or self._active or self._prefilling
                   or self._busy):
                if self._fatal is not None:
                    raise RuntimeError(
                        "serving engine died") from self._fatal
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"engine not idle after {timeout}s")
                self._cond.wait(remaining)

    # -- scheduler ---------------------------------------------------------

    def _run(self) -> None:
        try:
            while True:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()
                    while not self._stop and (
                            self._static or (not self._queue
                                             and not self._active
                                             and not self._prefilling)):
                        self._cond.wait()
                    if self._stop:
                        closed = RuntimeError("serving engine closed")
                        for h in self._teardown_locked():
                            h._fail(closed)
                        return
                    self._admit_locked()
                    self._busy = True
                with torch.no_grad():
                    if self._prefilling:
                        self._prefill_step()
                    if self._active:
                        self._decode_step()
        except Exception as exc:  # the scheduler's boundary: fail every waiter
            died = RuntimeError(f"serving engine died: {exc!r}")
            died.__cause__ = exc
            with self._cond:
                self._fatal = exc
                self._busy = False
                handles = self._teardown_locked()
                self._cond.notify_all()
            for h in handles:
                h._fail(died)

    def _teardown_locked(self) -> List[_Handle]:
        """Under ``self._cond``: release every in-flight row's blocks
        exactly once, clear the batch, return the handles to fail."""
        handles = list(self._queue)
        self._queue.clear()
        for a in self._active + self._prefilling:
            self._allocator.release(a.blocks)
            handles.append(a.handle)
        self._active.clear()
        self._prefilling.clear()
        return handles

    def _admit_locked(self) -> None:
        """Move queued requests into the prefilling set while batch slots
        AND pool blocks allow. FIFO: a head-of-line request the pool
        can't fit yet blocks later ones (no starvation by bypass)."""
        now = time.monotonic()
        while self._queue and (len(self._active) + len(self._prefilling)
                               < self.buckets.max_batch):
            head = self._queue[0]
            plen = len(head.req.prompt)
            need = self.cache.blocks_needed(plen + head.req.max_new_tokens)
            if self._allocator.free_blocks() < need:
                break  # deferred until retirements free blocks
            self._queue.popleft()
            head.admit_t = now
            self._prefilling.append(_Active(
                head, self._allocator.allocate_blocks(need), plen))
            self._peak_active = max(
                self._peak_active,
                len(self._active) + len(self._prefilling))

    def _tables_for(self, rows: Sequence[_Active],
                    padded_b: int) -> torch.Tensor:
        tables = np.zeros((padded_b, self._table_width), np.int64)
        for i, a in enumerate(rows):
            tables[i, :len(a.blocks)] = a.blocks
        return self._dev(tables)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _forward(self, tok, pos, msk, last, tables) -> np.ndarray:
        """One bucketed paged call; returns each row's greedy pick."""
        logits, self._k_pool, self._v_pool = gpt.forward_paged(
            self._params, self.model_cfg, self._dev(tok), self._dev(pos),
            self._dev(msk), self._dev(last), self._k_pool, self._v_pool,
            tables)
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def _prefill_batch(self, rows: Sequence[_Active], b: int):
        """Whole prompts padded to ``b`` rows and the length bucket:
        (tokens, positions, mask, index of each row's last token)."""
        t = bucket_for(max(a.prompt_len for a in rows),
                       self.buckets.prefill_len_buckets)
        tok = np.zeros((b, t), np.int64)
        pos = np.zeros((b, t), np.int64)
        msk = np.zeros((b, t), bool)
        last = np.zeros((b,), np.int64)
        for i, a in enumerate(rows):
            n = a.prompt_len
            tok[i, :n] = a.handle.req.prompt
            pos[i, :n] = np.arange(n)
            msk[i, :n] = True
            last[i] = n - 1
        return tok, pos, msk, last

    def _prefill_step(self) -> None:
        """One bucketed prefill call covering every newcomer's prompt;
        each row samples its first token from its last prompt position
        and graduates to the decode set."""
        rows = list(self._prefilling)
        b = bucket_for(len(rows), self.buckets.batch_buckets)
        t0 = time.monotonic()
        first = self._forward(*self._prefill_batch(rows, b),
                              self._tables_for(rows, b))
        dt = time.monotonic() - t0
        graduated: List[_Active] = []
        for i, a in enumerate(rows):
            a.handle.prefill_s += dt
            a.handle.prefill_done_t = t0 + dt
            a.out.append(int(first[i]))
            a.last_token = int(first[i])
            if not self._maybe_finish(a):
                graduated.append(a)
        with self._cond:
            self._prefilling = []
            self._active.extend(graduated)

    def _decode_step(self) -> None:
        """One decode iteration for every active sequence: append each
        row's last sampled token to the pool, sample the next."""
        rows = list(self._active)
        b = bucket_for(len(rows), self.buckets.batch_buckets)
        tok = np.zeros((b, 1), np.int64)
        pos = np.zeros((b, 1), np.int64)
        msk = np.zeros((b, 1), bool)
        for i, a in enumerate(rows):
            tok[i, 0] = a.last_token
            pos[i, 0] = a.prompt_len + len(a.out) - 1
            msk[i, 0] = True
        nxt = self._forward(tok, pos, msk, np.zeros((b,), np.int64),
                            self._tables_for(rows, b))
        survivors: List[_Active] = []
        for i, a in enumerate(rows):
            a.out.append(int(nxt[i]))
            a.last_token = int(nxt[i])
            if not self._maybe_finish(a):
                survivors.append(a)
        with self._cond:
            self._active = survivors

    def _maybe_finish(self, a: _Active) -> bool:
        req = a.handle.req
        if req.eos_token_id is not None and a.last_token == req.eos_token_id:
            reason = "eos"
        elif len(a.out) >= req.max_new_tokens:
            reason = "length"
        else:
            return False
        self._retire(a, reason)
        return True

    def _retire(self, a: _Active, reason: str) -> None:
        now = time.monotonic()
        self._allocator.release(a.blocks)
        h = a.handle
        result = RequestResult(
            request_id=h.req.request_id,
            prompt_len=a.prompt_len,
            tokens=list(a.out),
            finish_reason=reason,
            queue_wait_s=max(0.0, h.admit_t - h.submit_t),
            prefill_s=h.prefill_s,
            decode_s=(now - h.prefill_done_t if h.prefill_done_t else 0.0),
            total_s=now - h.submit_t)
        with self._cond:
            self._completed += 1
            self._total_tokens += len(a.out)
        h._finish(result)

    # -- static (run-to-completion) baseline -------------------------------

    def run_static(self, requests: Sequence[Tuple[Sequence[int], int]]
                   ) -> List[RequestResult]:
        """Serve ``requests`` [(prompt, max_new_tokens), ...] the
        pre-continuous-batching way: FIFO groups of up to ``max_batch``,
        each run to completion (every decode step runs until the LAST
        member of the group finishes) with no one joining a running
        group. Same forward and pool as the continuous path, so a
        comparison isolates the scheduling policy. The engine must be
        idle; this is a benchmarking harness, not a second serving mode.
        """
        with self._cond:
            if self._queue or self._active or self._prefilling:
                raise RuntimeError("run_static requires an idle engine")
            while self._busy and self._fatal is None:
                self._cond.wait()  # the scheduler's last step is finishing
            if self._stop or self._fatal is not None:
                raise RuntimeError("serving engine is not running")
            # hold the scheduler off the pools while the groups run
            self._static = True
        try:
            results: List[RequestResult] = []
            todo = [(tuple(int(t) for t in p), int(mx)) for p, mx in requests]
            t0 = time.monotonic()
            for g in range(0, len(todo), self.buckets.max_batch):
                rows = []
                for j, (prompt, max_new) in enumerate(
                        todo[g:g + self.buckets.max_batch]):
                    h = _Handle(Request(prompt, max_new, None,
                                        f"static-{g + j}"))
                    h.submit_t = t0
                    h.admit_t = time.monotonic()
                    rows.append(_Active(h, self._allocator.allocate(
                        len(prompt) + max_new), len(prompt)))
                try:
                    with torch.no_grad():
                        self._static_group(rows)
                finally:
                    for a in rows:
                        self._allocator.release(a.blocks)
                end = time.monotonic()
                results += [RequestResult(
                    request_id=a.handle.req.request_id,
                    prompt_len=a.prompt_len, tokens=list(a.out),
                    finish_reason="length",
                    queue_wait_s=a.handle.admit_t - a.handle.submit_t,
                    prefill_s=a.handle.prefill_s,
                    decode_s=end - a.handle.prefill_done_t,
                    total_s=end - a.handle.submit_t) for a in rows]
            return results
        finally:
            with self._cond:
                self._static = False
                self._cond.notify_all()

    def _static_group(self, rows: List[_Active]) -> None:
        """Prefill + decode one group run-to-completion: finished rows are
        masked (no pool writes) but keep their batch slot."""
        b = bucket_for(len(rows), self.buckets.batch_buckets)
        tables = self._tables_for(rows, b)
        t0 = time.monotonic()
        first = self._forward(*self._prefill_batch(rows, b), tables)
        done_t = time.monotonic()
        for i, a in enumerate(rows):
            a.handle.prefill_s = done_t - t0
            a.handle.prefill_done_t = done_t
            a.out.append(int(first[i]))
            a.last_token = int(first[i])
        group_max = max(a.handle.req.max_new_tokens for a in rows)
        for _ in range(group_max - 1):
            tok1 = np.zeros((b, 1), np.int64)
            pos1 = np.zeros((b, 1), np.int64)
            msk1 = np.zeros((b, 1), bool)
            for i, a in enumerate(rows):
                tok1[i, 0] = a.last_token
                pos1[i, 0] = a.prompt_len + len(a.out) - 1
                msk1[i, 0] = len(a.out) < a.handle.req.max_new_tokens
            nxt = self._forward(tok1, pos1, msk1, np.zeros((b,), np.int64),
                                tables)
            for i, a in enumerate(rows):
                if len(a.out) < a.handle.req.max_new_tokens:
                    a.out.append(int(nxt[i]))
                    a.last_token = int(nxt[i])
