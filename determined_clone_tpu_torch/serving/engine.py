"""Iteration-level continuous batching over the paged KV cache — the port
of ``determined_clone_tpu/serving/engine.py``'s ``InferenceEngine``.

Requests enter a bounded thread-safe queue. Every scheduler iteration
first admits queued requests into the running batch (one bucketed
prefill call for the newcomers), then runs ONE decode step for every
active sequence (one bucketed T=1 call), retiring finished sequences
immediately so their pool blocks and batch slots free up for the next
iteration. :meth:`InferenceEngine.run_static` is the run-to-completion
baseline on the same programs and pool.

Backpressure: a full queue raises :class:`ServerOverloaded`
(:meth:`InferenceEngine.submit_with_backoff` retries it with jittered
backoff); KV-pool exhaustion defers admission (requests wait in the
queue until blocks free), never evicts mid-decode.

Three speed features ride on the same loop, each optional and each
keeping greedy output equal to plain decode:

- **copy-on-write prefix sharing** (``prefix_cache=True``): admission
  content-hashes the prompt's blocks against the
  :class:`~determined_clone_tpu_torch.serving.kv_cache.PrefixCache` and
  aliases resident blocks through the block table, so prefill skips the
  shared prefix; the one block a new owner could write (the block
  holding the re-scored last prompt token) is forked first.
- **draft-model speculative decoding** (``speculative_k=k`` plus a draft
  GPT): the draft proposes k tokens with T=1 calls, the target scores all
  of them in ONE k+1-token verify call (``forward_paged_logits``), and
  the accepted-prefix rule emits exactly the tokens one-at-a-time greedy
  decode would. Unlike the JAX engine's loop, the draft also writes its
  last proposal's K/V (see :meth:`InferenceEngine._spec_step`).
- **chunked prefill** (``chunk_prefill_len=n``): long prompts prefill n
  tokens per iteration, interleaved with decode steps, so one long prompt
  cannot hold back every running sequence's next token (and prompts
  longer than the largest prefill bucket become servable).

Device programs: every call pads to the :class:`BucketSpec` ladder, so
the engine runs a fixed set of programs — the paged forward of the
target (and of the draft) at each (batch, length) bucket and at T=1, the
verify per batch bucket, the block copy per pool pair — exactly
:meth:`InferenceEngine.program_budget` of them. Each program reads its
integer inputs from one device buffer at a fixed address. Before
:meth:`InferenceEngine.warmup` they run eagerly, as a cold JAX engine
compiles on first use; warmup on the card captures each as a CUDA graph
(one graph memory pool, replayed one at a time), and the scheduler
replays the graphs from then on. The pools are updated in place and
never reassigned, and after warmup the engine owns its parameter
tensors: :meth:`InferenceEngine.hot_swap` copies new weights into them,
so the captured graphs serve the new model.

KV tiers (``kv_store=``, a :class:`~.kv_store.KVBlockStore`, with the
prefix cache): prefix-cache eviction demotes a full block's exact K/V to
the host tier (and on to CAS), and admission promotes tier hits back into
fresh pool blocks before matching, so a restarted or replacement replica
serves a known prefix without prefilling it. A promoted block is written
into the pools in place, on the scheduler's stream, before the next
program call reads it; the pools are never rebound, so the captured
graphs see it. The write is not a program of the ladder.

Not ported (``ROADMAP.md``): the XLA executable-cache hooks
(``exec_dispatchers``, ``exec_cache_summary``), which have no CUDA
counterpart here.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from determined_clone_tpu_torch import faults
from determined_clone_tpu_torch.core._serialization import (
    tree_paths_and_leaves as _leaves,
)
from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.models import gpt
from determined_clone_tpu_torch.serving.bucketing import BucketSpec, bucket_for
from determined_clone_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    KVCacheConfig,
    PrefixCache,
    init_kv_pools,
)
from determined_clone_tpu_torch.serving.kv_store import (
    PrefixInventory,
    params_fingerprint,
    payload_array,
    payload_fits,
    payload_tensor,
)
from determined_clone_tpu_torch.telemetry.metrics import MetricsRegistry
from determined_clone_tpu_torch.utils.retry import RetryPolicy, retry_call


class ServerOverloaded(RuntimeError):
    """Admission rejected: queue full. Retryable — clients should back
    off (see :meth:`InferenceEngine.submit_with_backoff`)."""


class ReplicaFailed(RuntimeError):
    """The engine serving this request died (scheduler crash) or was
    condemned (:meth:`InferenceEngine.fail_inflight`). ``active`` tells
    requests that were running on the dead engine from ones that only
    sat in its queue."""

    def __init__(self, msg: str, *, active: bool = False) -> None:
        super().__init__(msg)
        self.active = active


ADMISSION_RETRY = RetryPolicy(
    name="serving_admission", max_attempts=6, base_delay_s=0.05,
    multiplier=2.0, max_delay_s=2.0, retryable=(ServerOverloaded,))


@dataclasses.dataclass(frozen=True)
class Request:
    """One greedy (argmax) generation request."""
    prompt: Tuple[int, ...]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    request_id: str = ""
    # trace identity minted at the front door; rides every per-request span
    trace_id: Optional[str] = None
    # absolute time.monotonic() deadline: unfinished work is retired as
    # "expired" at the next iteration boundary and its blocks freed
    deadline_t: Optional[float] = None


@dataclasses.dataclass
class RequestResult:
    request_id: str
    prompt_len: int
    tokens: List[int]
    finish_reason: str          # "length" | "eos" | "aborted" | "expired"
    queue_wait_s: float
    prefill_s: float            # total prefill device time it rode
    decode_s: float             # prefill-done → last token
    total_s: float              # submit → last token
    prefix_hit_blocks: int = 0   # prompt blocks aliased from the cache
    prefix_miss_blocks: int = 0  # prompt blocks prefilled from scratch
    spec_proposed: int = 0       # draft tokens offered for this request
    spec_accepted: int = 0       # draft tokens the target agreed with
    trace_id: Optional[str] = None

    @property
    def spec_acceptance(self) -> Optional[float]:
        if self.spec_proposed <= 0:
            return None
        return self.spec_accepted / self.spec_proposed


@dataclasses.dataclass
class EngineStats:
    submitted: int
    rejected: int
    completed: int
    tokens_generated: int
    peak_active: int
    queue_depth: int
    free_blocks: int
    programs_compiled: int
    program_budget: int
    prefix_hit_blocks: int = 0
    prefix_miss_blocks: int = 0
    prefix_cached_entries: int = 0
    spec_tokens_proposed: int = 0
    spec_tokens_accepted: int = 0
    spec_acceptance_rate: Optional[float] = None
    kv_host_hit_blocks: int = 0
    kv_cas_hit_blocks: int = 0
    kv_miss_blocks: int = 0
    kv_promoted_blocks: int = 0
    kv_spilled_blocks: int = 0


class _Handle:
    """Future for one in-flight request. Settlement is first-write-wins:
    once `_finish` or `_fail` lands, later calls are no-ops (a condemned
    engine's waiters are failed at once, while its scheduler thread may
    still tear down later)."""

    def __init__(self, req: Request) -> None:
        self.req = req
        self._done = threading.Event()
        self._lk = threading.Lock()  # leaf: guards the settle race only
        self._result: Optional[RequestResult] = None
        self._error: Optional[BaseException] = None
        self.submit_t = 0.0
        self.admit_t = 0.0
        self.prefill_s = 0.0
        self.prefill_done_t = 0.0
        self.cancelled = False  # set by InferenceEngine.abort

    def _finish(self, result: RequestResult) -> bool:
        with self._lk:
            if self._done.is_set():
                return False
            self._result = result
            self._done.set()
        return True

    def _fail(self, exc: BaseException) -> bool:
        with self._lk:
            if self._done.is_set():
                return False
            self._error = exc
            self._done.set()
        return True

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

    __slots__ = ("handle", "blocks", "prompt_len", "out", "last_token",
                 "prefill_pos", "pending_copy", "hit_blocks", "miss_blocks",
                 "spec_proposed", "spec_accepted")

    def __init__(self, handle: _Handle, blocks: List[int],
                 prompt_len: int) -> None:
        self.handle = handle
        self.blocks = blocks
        self.prompt_len = prompt_len
        self.out: List[int] = []
        self.last_token = -1
        # next un-prefilled prompt position: 0 for a cold prompt, the
        # shared-prefix length after a cache hit, prompt_len once done
        self.prefill_pos = 0
        # (src, dst) fork to run before this row's first device call; the
        # src block keeps a caller reference until then
        self.pending_copy: Optional[Tuple[int, int]] = None
        self.hit_blocks = 0
        self.miss_blocks = 0
        self.spec_proposed = 0
        self.spec_accepted = 0


class _Program:
    """One device program: ``fn`` over fixed-shape int64 inputs that live
    in ONE device buffer at a fixed address, filled from a host staging
    buffer (pinned on the card) before every call. Eager until
    :meth:`capture` records it as a CUDA graph; replayed from then on.
    A call returns ``fn``'s output on the host as numpy (None for none).
    """

    def __init__(self, fn: Callable[..., Optional[torch.Tensor]],
                 shapes: Sequence[Tuple[int, ...]],
                 device: torch.device) -> None:
        n = sum(math.prod(s) for s in shapes)
        on_card = device.type == "cuda"
        self.host = torch.zeros(n, dtype=torch.long, pin_memory=on_card)
        self.dev = (torch.zeros(n, dtype=torch.long, device=device)
                    if on_card else self.host)
        self._host_views: List[np.ndarray] = []
        self._dev_views: List[torch.Tensor] = []
        flat = self.host.numpy()
        off = 0
        for s in shapes:
            k = math.prod(s)
            self._host_views.append(flat[off:off + k].reshape(s))
            self._dev_views.append(self.dev[off:off + k].view(s))
            off += k
        self.fn = fn
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.ready = False  # captured (card) or run by warmup (CPU)
        self.replays = 0
        self.eager_calls = 0

    def __call__(self, *arrays: np.ndarray) -> Optional[np.ndarray]:
        for dst, a in zip(self._host_views, arrays):
            dst[...] = a
        if self.dev is not self.host:
            # blocking: the staging buffer is free again on return
            self.dev.copy_(self.host)
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            out = self.out
        else:
            out = self.fn(*self._dev_views)
            self.eager_calls += 1
        return None if out is None else out.cpu().numpy()

    def capture(self, pool: Any) -> None:
        """Record ``fn`` on the inputs' buffer as a CUDA graph. Raises if
        the capture fails — there is no eager fallback."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            self.out = self.fn(*self._dev_views)
        self.graph = graph
        self.ready = True


class InferenceEngine:
    """Continuous-batching GPT server over a paged KV cache.

    One scheduler thread (named ``serving-engine``) owns all device work;
    request threads only touch the queue and their handle. Use as a
    context manager or call :meth:`close` — the thread must be joined.
    ``params`` (and ``draft_params``) must already be on ``device``.
    ``fwd`` replaces :func:`gpt.forward_paged` (same signature) for the
    target and draft lanes.
    """

    def __init__(self, params: gpt.Params, model_cfg: gpt.GPTConfig, *,
                 buckets: Optional[BucketSpec] = None,
                 cache: Optional[KVCacheConfig] = None,
                 max_queue_depth: int = 64,
                 telemetry: Any = None,
                 fwd: Optional[Callable[..., Any]] = None,
                 iteration_floor_s: float = 0.0,
                 prefix_cache: bool = False,
                 chunk_prefill_len: int = 0,
                 speculative_k: int = 0,
                 draft_params: Optional[gpt.Params] = None,
                 draft_cfg: Optional[gpt.GPTConfig] = None,
                 kv_store: Any = None,
                 fault_scope: str = "",
                 device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        self._check_device(params, "params")
        self.model_cfg = model_cfg
        # chaos targeting: with a scope the scheduler also hits
        # "engine.step.<scope>" / "engine.admit.<request_id>"
        self._fault_scope = str(fault_scope)
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
        self._pending_params: Optional[gpt.Params] = None
        self._allocator = BlockAllocator(cache)
        # never reassigned: captured graphs hold their addresses
        self._k_pool, self._v_pool = init_kv_pools(model_cfg, cache,
                                                   self.device)
        # fixed block-table width: every call sees the same W
        self._table_width = max(
            1, math.ceil(model_cfg.max_seq_len / cache.block_size))
        self._fwd = fwd if fwd is not None else gpt.forward_paged

        self.chunk_prefill_len = int(chunk_prefill_len)
        if self.chunk_prefill_len:
            self.buckets.validate_chunk_len(self.chunk_prefill_len)
        self._spec_k = int(speculative_k)
        if self._spec_k < 0:
            raise ValueError(
                f"speculative_k must be >= 0, got {speculative_k}")
        if self._spec_k:
            if draft_params is None or draft_cfg is None:
                raise ValueError(
                    "speculative_k > 0 needs draft_params and draft_cfg")
            if draft_cfg.vocab_size != model_cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target vocab "
                    f"{model_cfg.vocab_size} (the tokenizer is shared)")
            self._check_device(draft_params, "draft_params")
            self._draft_params = draft_params
            self.draft_cfg = draft_cfg
            # the draft's pools share block ids (and hence block tables
            # and the allocator) with the target's, so prefix sharing and
            # the fork cover the draft KV with no extra bookkeeping
            self._dk_pool, self._dv_pool = init_kv_pools(draft_cfg, cache,
                                                         self.device)
        else:
            self._draft_params = None
            self.draft_cfg = None
        # -- KV memory hierarchy (serving/kv_store.py): eviction demotes
        # blocks into the store, admission promotes tier hits back into
        # pool blocks before prefilling only the uncovered tail
        if kv_store is not None and not prefix_cache:
            raise ValueError("kv_store requires prefix_cache=True — the "
                             "tier is keyed by the prefix cache's chain "
                             "hashes")
        self._kv_store = kv_store
        self._prefix = (PrefixCache(
            cache, self._allocator,
            spill=self._spill_block if kv_store is not None else None)
            if prefix_cache else None)
        # tier-key scope: cached K/V is a function of the params, so a
        # weight change switches fingerprints
        self._params_fp = (params_fingerprint(params)
                           if kv_store is not None else "")
        # promotion writes queued at admission; each dst block carries an
        # extra allocator reference until its write lands in _do_writes
        self._pending_writes: List[Tuple[int, Dict[str, Any]]] = []
        self._programs: Dict[Tuple[Any, ...], _Program] = {}
        # set by warmup: from then on the engine owns its parameter
        # tensors (the captured graphs read them) and hot_swap copies new
        # weights into them
        self._owns_params = False

        # simulated device-step floor: pad every iteration that did device
        # work up to this many seconds (0.0, the default, is a no-op)
        self.iteration_floor_s = float(iteration_floor_s)

        registry = getattr(telemetry, "registry", telemetry)
        self.registry: MetricsRegistry = (
            registry if isinstance(registry, MetricsRegistry)
            else MetricsRegistry())
        tracer = getattr(telemetry, "tracer", None)
        self._span = (tracer.span if tracer is not None
                      else lambda name, **kw: contextlib.nullcontext())
        # per-request events: None when telemetry is off, so the disabled
        # path pays one `is not None` per step and nothing per request
        self._tracer = (tracer if tracer is not None
                        and getattr(tracer, "enabled", False) else None)
        m = self.registry
        self._h_queue_wait = m.histogram(
            "serving_queue_wait_seconds", "submit → admitted into the batch")
        self._h_prefill = m.histogram(
            "serving_prefill_seconds", "one bucketed prefill call")
        self._h_decode = m.histogram(
            "serving_decode_step_seconds", "one bucketed decode step")
        self._h_total = m.histogram(
            "serving_request_total_seconds", "submit → last token")
        self._c_admitted = m.counter(
            "serving_requests_admitted_total", "requests accepted into queue")
        self._c_rejected = m.counter(
            "serving_requests_rejected_total",
            "admission rejections (queue full → ServerOverloaded)")
        self._c_completed = m.counter(
            "serving_requests_completed_total", "requests fully generated")
        self._c_tokens = m.counter(
            "serving_tokens_generated_total", "decoded tokens (all requests)")
        self._g_active = m.gauge(
            "serving_active_sequences", "sequences in the running batch")
        self._g_queue = m.gauge(
            "serving_queue_depth", "requests waiting for admission")
        self._g_free_blocks = m.gauge(
            "serving_free_kv_blocks", "unallocated KV pool blocks")
        self._g_free_blocks.set(self._allocator.free_blocks())
        self._c_prefix_hit = m.counter(
            "prefix_cache_hit_blocks_total",
            "prompt blocks aliased from the prefix cache (prefill skipped)")
        self._c_prefix_miss = m.counter(
            "prefix_cache_miss_blocks_total",
            "prompt blocks prefilled from scratch")
        self._c_spec_proposed = m.counter(
            "serving_spec_tokens_proposed_total",
            "draft tokens offered to the verify step")
        self._c_spec_accepted = m.counter(
            "serving_spec_tokens_accepted_total",
            "draft tokens the target model agreed with")
        self._g_spec_rate = m.gauge(
            "spec_acceptance_rate",
            "cumulative accepted/proposed draft-token ratio")
        self._h_spec_accept = m.histogram(
            "serving_spec_request_acceptance_rate",
            "per-request draft acceptance rate at retirement")
        self._c_expired = m.counter(
            "serving_requests_expired_total",
            "requests retired at their deadline (blocks freed, not decoded)")
        self._c_kv_host_hit = m.counter(
            "kv_tier_host_hit_blocks_total",
            "prompt blocks promoted from the host KV tier")
        self._c_kv_cas_hit = m.counter(
            "kv_tier_cas_hit_blocks_total",
            "prompt blocks promoted from the CAS KV tier")
        self._c_kv_miss = m.counter(
            "kv_tier_miss_blocks_total",
            "prompt blocks absent from every KV tier (prefilled fresh)")
        self._c_kv_promoted = m.counter(
            "kv_tier_promoted_blocks_total",
            "host→pool promotion writes landed (re-prefill avoided)")
        self._c_kv_spilled = m.counter(
            "kv_tier_spilled_blocks_total",
            "pool blocks demoted into the host tier instead of dropped")

        self._cond = threading.Condition()
        self._queue: collections.deque[_Handle] = collections.deque()
        self._active: List[_Active] = []
        self._prefilling: List[_Active] = []
        self._stop = False
        self._warming = False
        self._static = False  # run_static owns the pools
        self._busy = False  # scheduler outside its wait with device work
        self._fatal: Optional[BaseException] = None
        # set by fail_inflight: the scheduler raises it at the next
        # iteration boundary, so the crash teardown — the only place that
        # may release a possibly-mid-step row's blocks — runs exactly
        # once, on the owning thread
        self._condemned: Optional[BaseException] = None
        # heartbeat, stamped every pass: a wedged scheduler reads as a
        # stale beat with pending work
        self._beat_t = time.monotonic()
        self._submitted = 0
        self._completed = 0
        self._total_tokens = 0
        self._peak_active = 0
        self._req_seq = 0
        self._thread = threading.Thread(target=self._run,
                                        name="serving-engine", daemon=True)
        self._thread.start()

    def _check_device(self, params: gpt.Params, what: str) -> None:
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"{what} are on {table.device}, engine device "
                             f"is {self.device}")

    @classmethod
    def from_serving_config(cls, params: gpt.Params,
                            model_cfg: gpt.GPTConfig, scfg: Any, *,
                            telemetry: Any = None, fwd: Any = None,
                            iteration_floor_s: float = 0.0,
                            draft_params: Optional[gpt.Params] = None,
                            device: DeviceLike = "cuda"
                            ) -> "InferenceEngine":
        """Build an engine from a ``ServingConfig`` (the ``serving:``
        block of an experiment YAML). With the ``speculative:`` block
        enabled the draft GPT shares the vocabulary and max_seq_len with
        the target; its weights come from ``draft_params`` or, absent
        one, a random init from a generator seeded 0 — correct but slow,
        since the accept rule never trusts the draft."""
        dev = resolve_device(device)
        buckets = BucketSpec.build(
            scfg.max_batch, min(scfg.max_prefill_len, model_cfg.max_seq_len))
        blocks = scfg.kv_blocks or scfg.max_batch * max(
            1, math.ceil(model_cfg.max_seq_len / scfg.kv_block_size))
        spec = getattr(scfg, "speculative", None)
        spec_k = 0
        draft_cfg = None
        if spec is not None and spec.enabled:
            spec_k = spec.k
            draft_cfg = dataclasses.replace(
                model_cfg, n_layers=spec.draft_layers,
                d_model=spec.draft_d_model, n_heads=spec.draft_n_heads,
                d_ff=spec.draft_d_ff, remat=False)
            if draft_params is None:
                gen = torch.Generator(device=dev).manual_seed(0)
                draft_params = gpt.init(gen, draft_cfg, device=dev)
        return cls(params, model_cfg, buckets=buckets,
                   cache=KVCacheConfig(num_blocks=blocks,
                                       block_size=scfg.kv_block_size),
                   max_queue_depth=scfg.max_queue_depth,
                   telemetry=telemetry, fwd=fwd,
                   iteration_floor_s=iteration_floor_s,
                   prefix_cache=getattr(scfg, "prefix_cache", False),
                   chunk_prefill_len=getattr(scfg, "chunk_prefill_len", 0),
                   speculative_k=spec_k, draft_params=draft_params,
                   draft_cfg=draft_cfg, device=dev)

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

    @staticmethod
    def _req_args(req: Request, **extra: Any) -> Dict[str, Any]:
        """Span args identifying one request (per-request tracing)."""
        args: Dict[str, Any] = {"request_id": req.request_id, **extra}
        if req.trace_id:
            args["trace_id"] = req.trace_id
        return args

    def attach_tracer(self, tracer: Any) -> None:
        """Late-bind (or detach, with None) the per-request event tracer;
        an attribute swap, safe while the scheduler runs."""
        self._tracer = (tracer if tracer is not None
                        and getattr(tracer, "enabled", False) else None)

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16, *,
               eos_token_id: Optional[int] = None,
               request_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               deadline_t: Optional[float] = None) -> _Handle:
        """Enqueue one request. Raises ValueError for never-servable
        requests and ServerOverloaded when the queue is full.
        ``deadline_t`` is an absolute ``time.monotonic()`` deadline:
        work still unfinished then is retired as "expired" at the next
        iteration boundary and its KV blocks freed."""
        prompt = tuple(int(t) for t in prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if not self.chunk_prefill_len \
                and len(prompt) > self.buckets.max_prefill_len:
            # chunked prefill lifts this limit: any prompt that fits the
            # model context is served chunk_prefill_len tokens at a time
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
                # never admitted: no strike against the request
                raise ReplicaFailed("serving engine died",
                                    active=False) from self._fatal
            if self._stop:
                raise RuntimeError("serving engine is closed")
            if len(self._queue) >= self.max_queue_depth:
                self._c_rejected.inc()
                raise ServerOverloaded(
                    f"queue full ({self.max_queue_depth} waiting)")
            self._req_seq += 1
            rid = request_id or f"req-{self._req_seq}"
            handle = _Handle(Request(prompt, int(max_new_tokens),
                                     eos_token_id, rid, trace_id,
                                     deadline_t))
            handle.submit_t = time.monotonic()
            if not self._busy:
                # first work after an idle stretch: restart the liveness
                # clock so a parked scheduler gets a fresh window
                self._beat_t = handle.submit_t
            self._queue.append(handle)
            self._submitted += 1
            self._c_admitted.inc()
            self._g_queue.set(len(self._queue))
            self._cond.notify_all()
        return handle

    def submit_with_backoff(self, prompt: Sequence[int],
                            max_new_tokens: int = 16, *,
                            eos_token_id: Optional[int] = None,
                            request_id: Optional[str] = None,
                            trace_id: Optional[str] = None,
                            policy: RetryPolicy = ADMISSION_RETRY) -> _Handle:
        """submit() under a retry policy: full-jitter exponential backoff
        on ServerOverloaded, re-raised on exhaustion."""
        return retry_call(self.submit, prompt, max_new_tokens,
                          eos_token_id=eos_token_id, request_id=request_id,
                          trace_id=trace_id, policy=policy)

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16, *,
                 eos_token_id: Optional[int] = None,
                 timeout: Optional[float] = 120.0) -> RequestResult:
        return self.submit(prompt, max_new_tokens,
                           eos_token_id=eos_token_id).result(timeout)

    def abort(self, handle: _Handle) -> bool:
        """Cancel one in-flight request. The scheduler retires it at the
        next iteration boundary, releasing its blocks as a natural finish
        would; the handle resolves with the tokens so far and
        ``finish_reason == "aborted"``. False if it already finished."""
        with self._cond:
            if handle.done():
                return False
            handle.cancelled = True
            self._cond.notify_all()
        return True

    # -- model hot-swap ----------------------------------------------------

    def hot_swap(self, params: gpt.Params) -> None:
        """Queue a new parameter tree; the scheduler installs it at the
        next iteration boundary (never mid-step). After warmup the
        captured graphs read the engine's own parameter tensors, so the
        new weights are copied into them and must have their shapes."""
        self._check_device(params, "params")
        if self._owns_params:
            mine = _leaves(self._params)
            new = _leaves(params)
            if [(p, t.shape, t.dtype) for p, t in mine] != \
                    [(p, t.shape, t.dtype) for p, t in new]:
                raise ValueError("hot_swap after warmup needs the captured "
                                 "parameters' tree, shapes and dtypes")
        with self._cond:
            self._pending_params = params
            self._cond.notify_all()

    def _install_params(self, params: gpt.Params) -> None:
        if self._owns_params:
            with torch.no_grad():
                for (_, dst), (_, src) in zip(_leaves(self._params),
                                              _leaves(params)):
                    dst.copy_(src)
        else:
            self._params = params

    def hot_load(self, storage: Any, storage_id: str, *,
                 ckpt_subdir: str = "") -> float:
        """Hot-load a checkpoint from a StorageManager and swap it in.
        Returns the load wall-time in seconds."""
        from determined_clone_tpu_torch.core._serialization import load_pytree

        t0 = time.monotonic()
        with self._span("serving_hot_load", storage_id=storage_id):
            with storage.restore_path(storage_id) as d:
                src = os.path.join(d, ckpt_subdir) if ckpt_subdir else d
                new_params = load_pytree(src, like=self._params)
        self.hot_swap(new_params)
        dt = time.monotonic() - t0
        self.registry.histogram(
            "serving_hot_load_seconds",
            "checkpoint fetch + deserialize + swap").observe(dt)
        return dt

    # -- device programs -----------------------------------------------------

    def _lane(self, lane: str):
        if lane == "target":
            return self._params, self.model_cfg, self._k_pool, self._v_pool
        return (self._draft_params, self.draft_cfg, self._dk_pool,
                self._dv_pool)

    def _make_program(self, key: Tuple[Any, ...]) -> _Program:
        kind = key[0]
        W = self._table_width
        if kind == "fwd":
            _, lane, b, t = key

            def fwd_fn(tok, pos, msk, last, tables):
                params, cfg, kp, vp = self._lane(lane)
                logits, _, _ = self._fwd(params, cfg, tok, pos, msk != 0,
                                         last, kp, vp, tables)
                return torch.argmax(logits, dim=-1)
            return _Program(fwd_fn, [(b, t)] * 3 + [(b,), (b, W)],
                            self.device)
        if kind == "verify":
            b, t = key[1], self._spec_k + 1

            def verify_fn(tok, pos, msk, tables):
                logits, _, _ = gpt.forward_paged_logits(
                    self._params, self.model_cfg, tok, pos, msk != 0,
                    self._k_pool, self._v_pool, tables)
                return torch.argmax(logits, dim=-1)
            return _Program(verify_fn, [(b, t)] * 3 + [(b, W)], self.device)
        lane = key[1]

        def copy_fn(src_dst):
            # the fork: one block, all layers, both pools, in place
            _, _, kp, vp = self._lane(lane)
            for pool in (kp, vp):
                pool.index_copy_(1, src_dst[1:], pool.index_select(
                    1, src_dst[:1]))
            return None
        return _Program(copy_fn, [(2,)], self.device)

    def _call(self, key: Tuple[Any, ...], *arrays: np.ndarray
              ) -> Optional[np.ndarray]:
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self._make_program(key)
        return prog(*arrays)

    def _ladder(self) -> List[Tuple[Any, ...]]:
        """Every program key the engine can call: program_budget many."""
        lanes = ["target"] + (["draft"] if self._spec_k else [])
        keys: List[Tuple[Any, ...]] = []
        for b in self.buckets.batch_buckets:
            for lane in lanes:
                for t in (*self.buckets.prefill_len_buckets, 1):
                    keys.append(("fwd", lane, b, t))
            if self._spec_k:
                keys.append(("verify", b))
        if self._prefix is not None:
            keys += [("copy", lane) for lane in lanes]
        return keys

    def warmup(self) -> int:
        """Ready the whole program ladder before taking traffic: every
        (batch, prefill-length) and T=1 program of the target and, with
        speculation, of the draft; the k+1 verify per batch bucket; the
        block copy per pool pair. Each runs once on fully masked inputs
        (nothing reaches the pools: masked K/V go to the scratch block,
        and the copy program copies block 0 onto itself). On the card
        each is then captured as a CUDA graph, all in one graph memory
        pool, after the engine takes its own copy of the parameters
        (so :meth:`hot_swap` can write new weights into the captured
        tensors without touching the caller's). A capture that fails
        raises. Requires an idle engine; the scheduler is parked for the
        duration. Returns :meth:`programs_compiled`, which now equals
        :meth:`program_budget`. The CPU takes its copy of the parameters
        too, so hot-swap behaves the same on both devices."""
        with self._cond:
            self._await_idle_locked("warmup")
            self._warming = True
        t0 = time.monotonic()
        try:
            with self._span("serving_warmup"), torch.no_grad():
                progs = []
                for key in self._ladder():
                    prog = self._programs.get(key)
                    if prog is None:
                        prog = self._programs[key] = self._make_program(key)
                    progs.append(prog)
                    if prog.graph is None:
                        prog(*(np.zeros(v.shape, np.int64)
                               for v in prog._host_views))
                self._own_params()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                    pool = torch.cuda.graph_pool_handle()
                    for prog in progs:
                        if prog.graph is None:
                            prog.capture(pool)
                    torch.cuda.synchronize(self.device)
                else:
                    for prog in progs:
                        prog.ready = True
        finally:
            with self._cond:
                self._warming = False
                self._cond.notify_all()
        self.registry.histogram(
            "serving_warmup_seconds",
            "whole program ladder readied (graphs captured) at startup"
        ).observe(time.monotonic() - t0)
        return self.programs_compiled()

    def _own_params(self) -> None:
        """Clone the parameter trees once, before the first capture."""
        if self._owns_params:
            return

        def clone(tree):
            return ({k: clone(v) for k, v in tree.items()}
                    if isinstance(tree, dict) else tree.clone())
        self._params = clone(self._params)
        if self._spec_k:
            self._draft_params = clone(self._draft_params)
        self._owns_params = True

    def program_calls(self) -> Dict[str, int]:
        """Calls of the engine's programs so far: graph replays and eager
        runs (warmup's own runs included)."""
        return {"replays": sum(p.replays for p in self._programs.values()),
                "eager": sum(p.eager_calls
                             for p in self._programs.values())}

    def _await_idle_locked(self, what: str) -> None:
        """Under ``self._cond``: refuse if traffic is queued or running,
        and wait out the scheduler's in-flight device call."""
        if self._stop:
            raise RuntimeError("serving engine is closed")
        if self._fatal is not None:
            raise RuntimeError("serving engine died") from self._fatal
        if self._queue or self._active or self._prefilling:
            raise RuntimeError(f"{what} requires an idle engine")
        while self._busy and not self._stop and self._fatal is None:
            self._cond.wait()
        if self._stop:
            raise RuntimeError("serving engine is closed")
        if self._fatal is not None:
            raise RuntimeError("serving engine died") from self._fatal
        if self._queue or self._active or self._prefilling:
            raise RuntimeError(f"{what} requires an idle engine")

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
                if self._stop:
                    raise RuntimeError("serving engine is closed")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"engine not idle after {timeout}s "
                        f"(queue={len(self._queue)} "
                        f"active={len(self._active)} "
                        f"prefilling={len(self._prefilling)})")
                self._cond.wait(remaining)

    # -- health --------------------------------------------------------------

    def liveness(self) -> Dict[str, Any]:
        """Snapshot for a liveness probe: ``pending and beat_age_s >
        deadline`` means the scheduler has had work that long without
        completing a pass; a stale beat while idle is a parked thread."""
        now = time.monotonic()
        with self._cond:
            return {
                "thread_alive": self._thread.is_alive(),
                "fatal": self._fatal,
                "condemned": self._condemned is not None,
                "warming": self._warming,
                "pending": bool(self._queue or self._active
                                or self._prefilling or self._busy),
                "beat_age_s": now - self._beat_t,
            }

    def fail_inflight(self, reason: str) -> int:
        """Condemn this engine: fail every queued and running request with
        :class:`ReplicaFailed` at once, and mark the scheduler to tear
        itself down at its next wakeup (it releases the blocks, exactly
        once, on its own thread). Returns the requests newly failed."""
        condemned = ReplicaFailed(f"replica condemned: {reason}",
                                  active=True)
        with self._cond:
            if self._fatal is None:
                self._fatal = condemned
            if self._condemned is None:
                self._condemned = condemned
            queued = list(self._queue)
            self._queue.clear()
            self._g_queue.set(0)
            inflight = [a.handle
                        for a in self._active + self._prefilling]
            self._cond.notify_all()
        n = 0
        orphaned = ReplicaFailed(f"replica condemned: {reason}",
                                 active=False)
        for h in queued:
            n += 1 if h._fail(orphaned) else 0
        for h in inflight:
            n += 1 if h._fail(condemned) else 0
        return n

    def kv_outstanding(self) -> int:
        """KV blocks currently owned (active sequences + prefix-cache
        retains). Zero on an idle engine with no prefix cache."""
        return self._allocator.outstanding()

    def assert_kv_balanced(self, expected_outstanding: int = 0) -> None:
        """Raise AssertionError unless exactly ``expected_outstanding``
        blocks are held."""
        self._allocator.assert_balanced(expected_outstanding)

    def flush_prefix_cache(self) -> int:
        """Drop every prefix-cache entry (an idle engine's, between
        bursts); returns entries dropped."""
        if self._prefix is None:
            return 0
        with self._cond:
            self._await_idle_locked("flush_prefix_cache")
            n = self._prefix.flush()
            self._g_free_blocks.set(self._allocator.free_blocks())
        return n

    # -- introspection -------------------------------------------------------

    def programs_compiled(self) -> int:
        """Programs readied ahead of traffic: CUDA graphs captured on the
        card, programs run by warmup on the CPU."""
        return sum(p.ready for p in self._programs.values())

    def program_budget(self) -> int:
        """:meth:`programs_compiled` after warmup, for the feature set
        this engine was built with."""
        return self.buckets.extended_budget(
            speculative=self._spec_k > 0,
            prefix_cache=self._prefix is not None)

    def stats(self) -> EngineStats:
        with self._cond:
            proposed = int(self._c_spec_proposed.value)
            accepted = int(self._c_spec_accepted.value)
            return EngineStats(
                submitted=self._submitted,
                rejected=int(self._c_rejected.value),
                completed=self._completed,
                tokens_generated=self._total_tokens,
                peak_active=self._peak_active,
                queue_depth=len(self._queue),
                free_blocks=self._allocator.free_blocks(),
                programs_compiled=self.programs_compiled(),
                program_budget=self.program_budget(),
                prefix_hit_blocks=int(self._c_prefix_hit.value),
                prefix_miss_blocks=int(self._c_prefix_miss.value),
                prefix_cached_entries=(len(self._prefix)
                                       if self._prefix is not None else 0),
                spec_tokens_proposed=proposed,
                spec_tokens_accepted=accepted,
                spec_acceptance_rate=(accepted / proposed
                                      if proposed else None),
                kv_host_hit_blocks=int(self._c_kv_host_hit.value),
                kv_cas_hit_blocks=int(self._c_kv_cas_hit.value),
                kv_miss_blocks=int(self._c_kv_miss.value),
                kv_promoted_blocks=int(self._c_kv_promoted.value),
                kv_spilled_blocks=int(self._c_kv_spilled.value))

    # -- scheduler -----------------------------------------------------------

    def _run(self) -> None:
        try:
            while True:
                with self._cond:
                    self._busy = False
                    self._beat_t = time.monotonic()
                    self._cond.notify_all()  # wakes warmup's idle wait
                    while (not self._stop and self._condemned is None
                           and (self._warming or self._static
                                or (not self._queue and not self._active
                                    and not self._prefilling
                                    and self._pending_params is None))):
                        self._cond.wait()
                    if self._stop:
                        closed = RuntimeError("serving engine closed")
                        for h, _was_active in self._teardown_locked():
                            h._fail(closed)
                        return
                    if self._condemned is not None:
                        raise self._condemned
                    if self._pending_params is not None:
                        self._install_params(self._pending_params)
                        self._pending_params = None
                        # cached KV is a function of the params
                        if self._prefix is not None:
                            self._prefix.flush()
                            self._g_free_blocks.set(
                                self._allocator.free_blocks())
                        if self._kv_store is not None:
                            # new weights, new tier scope: old-params
                            # blocks stay fetchable under the old
                            # fingerprint (a rollback warms), never here
                            self._params_fp = params_fingerprint(
                                self._params)
                    admitted = self._admit_locked()
                    self._busy = True
                # fault points fire outside the condition (a delay rule
                # must wedge only this scheduler), and only with a plan
                if faults.active_plan() is not None:
                    for rid in admitted:
                        faults.point("engine.admit")
                        faults.point("engine.admit." + rid)
                    if self._pending_writes:
                        faults.point("kv_store.promote")
                    faults.point("engine.step")
                    if self._fault_scope:
                        faults.point("engine.step." + self._fault_scope)
                iter_t0 = time.monotonic()
                with torch.no_grad():
                    worked = self._reap_expired()
                    if self._pending_writes:
                        self._do_writes()
                        worked = True
                    if self._prefilling:
                        self._prefill_step()
                        worked = True
                    if self._active:
                        if self._spec_k:
                            self._spec_step()
                        else:
                            self._decode_step()
                        worked = True
                self._beat_t = time.monotonic()
                if worked and self.iteration_floor_s > 0.0:
                    pad = self.iteration_floor_s \
                        - (time.monotonic() - iter_t0)
                    if pad > 0.0:
                        time.sleep(pad)
        except BaseException as exc:  # noqa: BLE001 — fail every waiter
            queued = ReplicaFailed(f"serving engine died: {exc!r}",
                                   active=False)
            queued.__cause__ = exc
            running = ReplicaFailed(f"serving engine died: {exc!r}",
                                    active=True)
            running.__cause__ = exc
            with self._cond:
                if self._fatal is None:
                    self._fatal = exc
                self._busy = False
                handles = self._teardown_locked()
                self._cond.notify_all()
            for h, was_active in handles:
                h._fail(running if was_active else queued)

    def _teardown_locked(self) -> List[Tuple[_Handle, bool]]:
        """Under ``self._cond``, on the scheduler thread: release every
        in-flight row's blocks (pending fork sources included) and the
        prefix cache's retains exactly once, clear the batch, and return
        ``(handle, was_active)`` pairs to fail."""
        pairs = [(h, False) for h in self._queue]
        self._queue.clear()
        for block, _payload in self._pending_writes:
            self._allocator.release([block])
        self._pending_writes.clear()
        for a in self._active + self._prefilling:
            if a.pending_copy is not None:
                self._allocator.release([a.pending_copy[0]])
                a.pending_copy = None
            self._allocator.release(a.blocks)
            pairs.append((a.handle, True))
        self._active.clear()
        self._prefilling.clear()
        if self._prefix is not None:
            self._prefix.flush()
        self._g_active.set(0)
        self._g_queue.set(0)
        self._g_free_blocks.set(self._allocator.free_blocks())
        return pairs

    def _admit_locked(self) -> List[str]:
        """Move queued requests into the prefilling set while slots AND
        pool blocks allow. FIFO — a head-of-line request the pool can't
        fit yet blocks later ones. With the prefix cache on, each
        admission first aliases the longest resident prefix (retaining
        those blocks) and allocates fresh blocks for the rest; under pool
        pressure LRU entries are evicted before admission defers. Returns
        the admitted request ids."""
        now = time.monotonic()
        admitted: List[str] = []
        while self._queue and (len(self._active) + len(self._prefilling)
                               < self.buckets.max_batch):
            head = self._queue[0]
            if head.cancelled or (head.req.deadline_t is not None
                                  and now >= head.req.deadline_t):
                expired = not head.cancelled
                if expired:
                    self._c_expired.inc()
                self._queue.popleft()
                head._finish(RequestResult(
                    request_id=head.req.request_id,
                    prompt_len=len(head.req.prompt), tokens=[],
                    finish_reason="expired" if expired else "aborted",
                    queue_wait_s=0.0, prefill_s=0.0, decode_s=0.0,
                    total_s=now - head.submit_t,
                    trace_id=head.req.trace_id))
                continue
            plen = len(head.req.prompt)
            need_total = self.cache.blocks_needed(
                plen + head.req.max_new_tokens)
            shared: List[int] = []
            fork_src: Optional[int] = None
            skip = kept = 0
            need = need_total
            if self._prefix is not None:
                if self._kv_store is not None:
                    # warm the prefix cache from the lower tiers first,
                    # so the match below aliases promoted blocks exactly
                    # like always-resident ones
                    self._promote_locked(head.req.prompt)
                match = self._prefix.match(head.req.prompt)
                # always leave >= 1 prompt token to process: the last
                # prompt token is re-scored to give the first sampled
                # token, and its K/V rewrite is what the fork isolates
                skip = min(match.shared_len, plen - 1)
                shared = match.blocks
                if skip < match.shared_len:
                    # fully-shared prompt: the final shared block holds
                    # position plen-1 and WILL be written — fork it
                    fork_src = shared.pop()
                kept = len(shared)
                need = need_total - kept
            if self._allocator.free_blocks() < need:
                if self._prefix is not None:
                    self._prefix.evict(need)
                if self._allocator.free_blocks() < need:
                    # defer admission; hand back the match references
                    if shared:
                        self._allocator.release(shared)
                    if fork_src is not None:
                        self._allocator.release([fork_src])
                    break
            self._queue.popleft()
            head.admit_t = now
            if self._tracer is not None:
                self._h_queue_wait.observe(now - head.submit_t,
                                           exemplar=head.req.request_id)
                self._tracer.instant(
                    "request_admitted", **self._req_args(
                        head.req,
                        queue_wait_s=round(now - head.submit_t, 6),
                        prompt_len=plen))
            else:
                self._h_queue_wait.observe(now - head.submit_t)
            fresh = self._allocator.allocate_blocks(need)
            a = _Active(head, shared + fresh, plen)
            a.prefill_pos = skip
            if fork_src is not None:
                # fresh[0] backs the forked block's position range
                a.pending_copy = (fork_src, fresh[0])
            a.hit_blocks = kept + (1 if fork_src is not None else 0)
            a.miss_blocks = self.cache.blocks_needed(plen) - a.hit_blocks
            self._c_prefix_hit.inc(a.hit_blocks)
            self._c_prefix_miss.inc(a.miss_blocks)
            self._prefilling.append(a)
            admitted.append(head.req.request_id)
            self._peak_active = max(
                self._peak_active,
                len(self._active) + len(self._prefilling))
            self._g_active.set(len(self._active) + len(self._prefilling))
        self._g_queue.set(len(self._queue))
        self._g_free_blocks.set(self._allocator.free_blocks())
        return admitted

    # -- KV memory hierarchy (serving/kv_store.py) -------------------------

    def _payload_ok(self, payload: Dict[str, Any]) -> bool:
        """A tier payload is adoptable iff every array fits its pool's
        slot unchanged (:func:`payload_fits`: shape, dtype and host
        representation; a config change or a foreign entry is a plain
        miss, never a bad write) and it covers the draft pools when
        speculation is on."""
        want = [("k", self._k_pool), ("v", self._v_pool)]
        if self._spec_k:
            want += [("dk", self._dk_pool), ("dv", self._dv_pool)]
        if not isinstance(payload, dict):
            return False
        return all(payload_fits(payload.get(name), pool)
                   for name, pool in want)

    def _promote_locked(self, prompt: Tuple[int, ...]) -> None:
        """Under ``self._cond``: warm the prefix cache from the host/CAS
        tiers before matching one prompt. Walks the prompt's full blocks
        in chain order; for each key not already resident, fetches the
        exact payload, allocates a pool block, indexes it (the cache
        adopts the allocator reference) and queues the host→pool write,
        which lands in :meth:`_do_writes` before any admitted row's
        first forward. The first miss ends the walk: a later hit would
        alias a block whose predecessors are absent."""
        bs = self.cache.block_size
        prev = b""
        for i in range(len(prompt) // bs):
            key = PrefixCache._chain(prev, prompt[i * bs:(i + 1) * bs])
            prev = key
            if self._prefix.has_key(key):
                continue
            key_hex = key.hex()
            from_host = self._kv_store.contains(self._params_fp, key_hex)
            payload = self._kv_store.get(self._params_fp, key_hex)
            if payload is None or not self._payload_ok(payload):
                self._c_kv_miss.inc()
                break
            if self._allocator.free_blocks() < 1:
                self._prefix.evict(1)
                if self._allocator.free_blocks() < 1:
                    break
            block = self._allocator.allocate_blocks(1)[0]
            self._prefix.adopt(key, block, i)
            # extra reference pins the dst until the write lands
            self._allocator.retain([block])
            self._pending_writes.append((block, payload))
            (self._c_kv_host_hit if from_host
             else self._c_kv_cas_hit).inc()

    def _do_writes(self) -> None:
        """Land queued promotion writes before any prefill or decode
        touches the pools: each payload is copied into its block of every
        layer in place (the pools are never rebound — the captured graphs
        hold their addresses), on this thread's stream, so the next
        program call reads it. Drops each dst block's pinning reference
        once its write is queued."""
        writes, self._pending_writes = self._pending_writes, []
        for block, payload in writes:
            names = [("k", self._k_pool), ("v", self._v_pool)]
            if self._spec_k:
                names += [("dk", self._dk_pool), ("dv", self._dv_pool)]
            for name, pool in names:
                pool[:, block].copy_(payload_tensor(payload[name]))
            self._allocator.release([block])
            self._c_kv_promoted.inc()

    def _spill_block(self, key: bytes, block: int, depth: int) -> bool:
        """PrefixCache demotion hook: copy one full block's exact K/V to
        the host tier. Runs on the scheduler thread (or under an idle
        engine's lock) while the cache still holds the block's reference,
        so the pool contents are intact; the device-to-host copy waits
        for the stream's queued work. Never raises — a failed spill just
        means the block is gone, as before the tier existed."""
        try:
            payload = {"k": payload_array(self._k_pool[:, block]),
                       "v": payload_array(self._v_pool[:, block])}
            if self._spec_k:
                payload["dk"] = payload_array(self._dk_pool[:, block])
                payload["dv"] = payload_array(self._dv_pool[:, block])
            self._kv_store.put(self._params_fp, key.hex(), payload)
        except Exception:  # noqa: BLE001 — demotion is best-effort
            return False
        self._c_kv_spilled.inc()
        return True

    def flush_kv_to_tier(self) -> int:
        """Demote every full-block prefix-cache entry into the host/CAS
        tiers, so a teardown (rollout, replace, stop) keeps the fleet's
        warm state. Requires an idle engine (a dead or wedged one raises,
        and the fleet degrades to a cold teardown). Entries stay
        resident; the tier holds copies. Returns blocks spilled."""
        if self._prefix is None or self._kv_store is None:
            return 0
        n = 0
        with self._cond:
            self._await_idle_locked("flush_kv_to_tier")
            for key, block, depth in self._prefix.entries():
                if self._spill_block(key, block, depth):
                    n += 1
        return n

    def prefix_inventory(self) -> Optional[Dict[str, Any]]:
        """Router-facing digest of the chain keys this replica can serve
        cheaply: resident prefix-cache entries (roots first — a missed
        root zeroes coverage) followed by this fingerprint's host-tier
        keys. None when the prefix cache is off."""
        if self._prefix is None:
            return None
        # the scheduler thread may be registering entries concurrently
        # (dict iteration can raise mid-insert): retry, then serve an
        # empty digest — the inventory is a routing hint only
        for _ in range(3):
            try:
                resident = sorted(self._prefix.entries(),
                                  key=lambda e: e[2])
                break
            except RuntimeError:
                continue
        else:
            resident = []
        keys = [k.hex() for k, _block, _depth in resident]
        if self._kv_store is not None:
            seen = set(keys)
            keys += [k for k in self._kv_store.keys(self._params_fp)
                     if k not in seen]
        return PrefixInventory.build(keys).to_dict()

    def _reap_expired(self) -> bool:
        """Retire cancelled and deadline-expired rows at the iteration
        boundary, releasing their blocks (and a pending fork source's
        extra reference) as a natural finish would."""
        now = time.monotonic()
        doomed: List[Tuple[_Active, str]] = []
        for a in self._active + self._prefilling:
            if a.handle.cancelled:
                doomed.append((a, "aborted"))
            elif (a.handle.req.deadline_t is not None
                  and now >= a.handle.req.deadline_t):
                self._c_expired.inc()
                doomed.append((a, "expired"))
        if not doomed:
            return False
        dead = {id(a) for a, _r in doomed}
        for a, reason in doomed:
            if a.pending_copy is not None:
                self._allocator.release([a.pending_copy[0]])
                a.pending_copy = None
            self._retire(a, reason)
        with self._cond:
            self._active = [a for a in self._active if id(a) not in dead]
            self._prefilling = [a for a in self._prefilling
                                if id(a) not in dead]
            self._g_active.set(len(self._active) + len(self._prefilling))
            self._g_free_blocks.set(self._allocator.free_blocks())
        return True

    def _do_copies(self, rows: Sequence[_Active]) -> None:
        """Run pending forks before the rows' first device call, then drop
        the extra reference that kept each source alive."""
        for a in rows:
            if a.pending_copy is None:
                continue
            src, dst = a.pending_copy
            idx = np.array([src, dst], np.int64)
            self._call(("copy", "target"), idx)
            if self._spec_k:
                self._call(("copy", "draft"), idx)
            self._allocator.release([src])
            a.pending_copy = None
            if self._tracer is not None:
                self._tracer.instant(
                    "request_cow_fork", **self._req_args(
                        a.handle.req, src_block=src, dst_block=dst))

    def _tables_for(self, rows: Sequence[_Active],
                    padded_b: int) -> np.ndarray:
        tables = np.zeros((padded_b, self._table_width), np.int64)
        for i, a in enumerate(rows):
            tables[i, :len(a.blocks)] = a.blocks
        return tables

    def _prefill_step(self) -> None:
        """One bucketed prefill call covering every prefilling row's next
        slice of prompt: the whole remaining prompt, or at most
        ``chunk_prefill_len`` positions with chunking. Rows whose slice
        reaches the end of the prompt sample their first token and
        graduate to the decode set; prefix-cache rows start at
        ``prefill_pos > 0`` and completed prompts are registered."""
        rows = list(self._prefilling)
        self._do_copies(rows)
        cnt = []
        for a in rows:
            remaining = a.prompt_len - a.prefill_pos
            if self.chunk_prefill_len:
                remaining = min(remaining, self.chunk_prefill_len)
            cnt.append(remaining)
        b = bucket_for(len(rows), self.buckets.batch_buckets)
        t = bucket_for(max(cnt), self.buckets.prefill_len_buckets)
        tok = np.zeros((b, t), np.int64)
        pos = np.zeros((b, t), np.int64)
        msk = np.zeros((b, t), np.int64)
        last = np.zeros((b,), np.int64)
        for i, a in enumerate(rows):
            lo, n = a.prefill_pos, cnt[i]
            tok[i, :n] = a.handle.req.prompt[lo:lo + n]
            pos[i, :n] = np.arange(lo, lo + n)
            msk[i, :n] = 1
            last[i] = n - 1
        tables = self._tables_for(rows, b)
        t0 = time.monotonic()
        pt0 = time.perf_counter() if self._tracer is not None else 0.0
        with self._span("serving_prefill", batch=b, length=t):
            first = self._call(("fwd", "target", b, t), tok, pos, msk, last,
                               tables)
            if self._spec_k:
                # mirror the slice into the draft pools so the proposal
                # loop sees the same context the target does
                self._call(("fwd", "draft", b, t), tok, pos, msk, last,
                           tables)
        dt = time.monotonic() - t0
        self._h_prefill.observe(dt)
        if self._tracer is not None:
            for i, a in enumerate(rows):
                self._tracer.record_span(
                    "request_prefill_chunk", pt0, dt, **self._req_args(
                        a.handle.req, pos=a.prefill_pos, tokens=cnt[i]))
        done_t = time.monotonic()
        still_prefilling: List[_Active] = []
        graduated: List[_Active] = []
        for i, a in enumerate(rows):
            a.handle.prefill_s += dt
            a.prefill_pos += cnt[i]
            if a.prefill_pos < a.prompt_len:
                still_prefilling.append(a)
                continue
            a.handle.prefill_done_t = done_t
            if self._prefix is not None:
                self._prefix.register(
                    a.handle.req.prompt,
                    a.blocks[:self.cache.blocks_needed(a.prompt_len)])
            a.out.append(int(first[i]))
            a.last_token = int(first[i])
            if not self._maybe_finish(a):
                graduated.append(a)
        with self._cond:
            self._prefilling = still_prefilling
            self._active.extend(graduated)
            self._g_active.set(len(self._active) + len(self._prefilling))
            self._g_free_blocks.set(self._allocator.free_blocks())

    def _decode_step(self) -> None:
        """One decode iteration for every active sequence: append each
        row's last sampled token to the pool, sample the next."""
        rows = list(self._active)
        b = bucket_for(len(rows), self.buckets.batch_buckets)
        tok = np.zeros((b, 1), np.int64)
        pos = np.zeros((b, 1), np.int64)
        msk = np.zeros((b, 1), np.int64)
        for i, a in enumerate(rows):
            tok[i, 0] = a.last_token
            pos[i, 0] = a.prompt_len + len(a.out) - 1
            msk[i, 0] = 1
        t0 = time.monotonic()
        with self._span("serving_decode_step", batch=b, rows=len(rows)):
            nxt = self._call(("fwd", "target", b, 1), tok, pos, msk,
                             np.zeros((b,), np.int64),
                             self._tables_for(rows, b))
        self._h_decode.observe(time.monotonic() - t0)
        survivors: List[_Active] = []
        for i, a in enumerate(rows):
            a.out.append(int(nxt[i]))
            a.last_token = int(nxt[i])
            if not self._maybe_finish(a):
                survivors.append(a)
        with self._cond:
            self._active = survivors
            self._g_active.set(len(self._active) + len(self._prefilling))
            self._g_free_blocks.set(self._allocator.free_blocks())

    def _spec_step(self) -> None:
        """One speculative iteration for every active sequence: the draft
        proposes k tokens with k T=1 calls, the target scores [last
        committed token, draft_1..draft_k] in ONE k+1-token verify call,
        and each row emits the target's own greedy picks up to and
        including the first disagreement (plus the bonus token on full
        agreement) — 1..k+1 tokens, equal to one-at-a-time decode for ANY
        draft.

        The k proposal calls write the K/V of the last committed token
        and of proposals 1..k-1; one more T=1 draft call writes proposal
        k's. Without it (the JAX engine's loop) a fully accepted round
        leaves the next round's draft attending to a stale slot at that
        position; with it the identity testbed accepts exactly 1.0.

        Per-row ``allow`` masks draft and verify slots past the row's
        remaining ``max_new_tokens``, so speculation never writes K/V
        beyond the row's blocks (masked slots go to the scratch block).
        Rejected drafts leave stale entries past the accepted frontier,
        at positions the row still owns: attention masks every slot past
        a query's own position, and the next iteration's scatter
        overwrites them before any query can see them. The program
        buffers change nothing here: each call writes exactly the slots
        its inputs name.
        """
        rows = list(self._active)
        k = self._spec_k
        b = bucket_for(len(rows), self.buckets.batch_buckets)
        tables = self._tables_for(rows, b)
        n0 = np.array([a.prompt_len + len(a.out) for a in rows])
        allow = np.array([min(k + 1,
                              a.handle.req.max_new_tokens - len(a.out))
                          for a in rows])
        t0 = time.monotonic()
        pt0 = time.perf_counter() if self._tracer is not None else 0.0
        with self._span("serving_spec_step", batch=b, rows=len(rows), k=k):
            drafts = np.zeros((len(rows), k), np.int64)
            cur = np.array([a.last_token for a in rows])
            zero_last = np.zeros((b,), np.int64)
            for j in range(k + 1):
                tok = np.zeros((b, 1), np.int64)
                pos = np.zeros((b, 1), np.int64)
                msk = np.zeros((b, 1), np.int64)
                tok[:len(rows), 0] = cur
                pos[:len(rows), 0] = n0 - 1 + j
                msk[:len(rows), 0] = j < allow
                cur = self._call(("fwd", "draft", b, 1), tok, pos, msk,
                                 zero_last, tables)[:len(rows)]
                if j < k:
                    drafts[:, j] = cur
            tok = np.zeros((b, k + 1), np.int64)
            pos = np.zeros((b, k + 1), np.int64)
            msk = np.zeros((b, k + 1), np.int64)
            for i, a in enumerate(rows):
                tok[i, 0] = a.last_token
                tok[i, 1:] = drafts[i]
                pos[i] = np.arange(n0[i] - 1, n0[i] + k)
                msk[i] = np.arange(k + 1) < allow[i]
            target = self._call(("verify", b), tok, pos, msk, tables)
        step_dt = time.monotonic() - t0
        self._h_decode.observe(step_dt)
        survivors: List[_Active] = []
        step_proposed = step_accepted = 0
        for i, a in enumerate(rows):
            # accept while the draft echoes the target's own greedy pick;
            # target[i, j] is trustworthy for j < allow[i] because all of
            # its conditioning tokens are committed-or-accepted by then
            emitted = [int(target[i, 0])]
            j = 0
            while (j < allow[i] - 1 and j < k
                   and int(drafts[i, j]) == int(target[i, j])):
                j += 1
                emitted.append(int(target[i, j]))
            usable = int(min(k, allow[i] - 1))
            a.spec_proposed += usable
            a.spec_accepted += len(emitted) - 1
            step_proposed += usable
            step_accepted += len(emitted) - 1
            if self._tracer is not None:
                self._tracer.record_span(
                    "request_spec_round", pt0, step_dt, **self._req_args(
                        a.handle.req, proposed=usable,
                        accepted=len(emitted) - 1, emitted=len(emitted)))
            for tk in emitted:
                a.out.append(tk)
                a.last_token = tk
                if (a.handle.req.eos_token_id is not None
                        and tk == a.handle.req.eos_token_id):
                    break
            if not self._maybe_finish(a):
                survivors.append(a)
        self._c_spec_proposed.inc(step_proposed)
        self._c_spec_accepted.inc(step_accepted)
        proposed = self._c_spec_proposed.value
        if proposed:
            self._g_spec_rate.set(self._c_spec_accepted.value / proposed)
        with self._cond:
            self._active = survivors
            self._g_active.set(len(self._active) + len(self._prefilling))
            self._g_free_blocks.set(self._allocator.free_blocks())

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
            total_s=now - h.submit_t,
            prefix_hit_blocks=a.hit_blocks,
            prefix_miss_blocks=a.miss_blocks,
            spec_proposed=a.spec_proposed,
            spec_accepted=a.spec_accepted,
            trace_id=h.req.trace_id)
        if self._tracer is not None:
            self._h_total.observe(result.total_s,
                                  exemplar=h.req.request_id)
            self._tracer.instant(
                "request_retired", **self._req_args(
                    h.req, finish_reason=reason, tokens=len(a.out),
                    total_s=round(result.total_s, 6),
                    queue_wait_s=round(result.queue_wait_s, 6),
                    prefix_hit_blocks=a.hit_blocks,
                    spec_proposed=a.spec_proposed,
                    spec_accepted=a.spec_accepted))
        else:
            self._h_total.observe(result.total_s)
        self._c_completed.inc()
        self._c_tokens.inc(len(a.out))
        if a.spec_proposed:
            self._h_spec_accept.observe(a.spec_accepted / a.spec_proposed)
        with self._cond:
            self._completed += 1
            self._total_tokens += len(a.out)
        h._finish(result)

    # -- static (run-to-completion) baseline ---------------------------------

    def run_static(self, requests: Sequence[Tuple[Sequence[int], int]], *,
                   arrivals: Optional[Sequence[float]] = None,
                   timeout: Optional[float] = 300.0
                   ) -> List[RequestResult]:
        """Serve ``requests`` [(prompt, max_new_tokens), ...] the
        pre-continuous-batching way: FIFO groups of up to ``max_batch``,
        each run to completion (every decode step runs until the LAST
        member of the group finishes), and no one joins a running group.
        Same programs and pool as the continuous path, so a comparison
        isolates the scheduling policy. ``arrivals`` (seconds from call
        start, ascending) simulates offered load. The engine must be
        idle; the scheduler is held off the pools for the duration."""
        with self._cond:
            self._await_idle_locked("run_static")
            self._static = True
        try:
            return self._run_static(requests, arrivals, timeout)
        finally:
            with self._cond:
                self._static = False
                self._cond.notify_all()

    def _run_static(self, requests, arrivals, timeout
                    ) -> List[RequestResult]:
        arrivals = list(arrivals) if arrivals is not None \
            else [0.0] * len(requests)
        if len(arrivals) != len(requests):
            raise ValueError("arrivals must match requests")
        pending = sorted(
            ((arr, i, tuple(int(t) for t in p), int(mx))
             for i, ((p, mx), arr) in enumerate(zip(requests, arrivals))),
            key=lambda x: (x[0], x[1]))
        results: List[Optional[RequestResult]] = [None] * len(requests)
        t0 = time.monotonic()
        while pending:
            now = time.monotonic() - t0
            if pending[0][0] > now:
                time.sleep(min(pending[0][0] - now, 0.05))
                continue
            group = []
            while (pending and len(group) < self.buckets.max_batch
                   and pending[0][0] <= now):
                group.append(pending.pop(0))
            rows = []
            try:
                for arr, i, prompt, max_new in group:
                    h = _Handle(Request(prompt, max_new, None,
                                        f"static-{i}"))
                    h.submit_t = t0 + arr
                    h.admit_t = time.monotonic()
                    rows.append(_Active(h, self._allocator.allocate(
                        len(prompt) + max_new), len(prompt)))
                with torch.no_grad():
                    self._static_group(rows)
            finally:
                for a in rows:
                    self._allocator.release(a.blocks)
            end = time.monotonic()
            for (arr, i, _, _), a in zip(group, rows):
                results[i] = RequestResult(
                    request_id=f"static-{i}", prompt_len=a.prompt_len,
                    tokens=list(a.out), finish_reason="length",
                    queue_wait_s=a.handle.admit_t - a.handle.submit_t,
                    prefill_s=a.handle.prefill_s,
                    decode_s=end - a.handle.prefill_done_t,
                    total_s=end - a.handle.submit_t)
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError("run_static exceeded its timeout")
        return [r for r in results if r is not None]

    def _static_group(self, rows: List[_Active]) -> None:
        """Prefill + decode one group run-to-completion: every step runs
        at the full group batch until the slowest member finishes;
        finished rows are masked (no pool writes) but keep their slot.
        Chunked prefill applies here too (same programs), so a chunked
        workload replays — the whole prompt still lands before any
        decode."""
        b = bucket_for(len(rows), self.buckets.batch_buckets)
        chunk = self.chunk_prefill_len or self.buckets.prefill_len_buckets[-1]
        tables = self._tables_for(rows, b)
        t0 = time.monotonic()
        offs = [0] * len(rows)
        first = np.zeros((b,), np.int64)
        while True:
            cnts = [min(chunk, a.prompt_len - offs[i])
                    for i, a in enumerate(rows)]
            t = bucket_for(max(cnts), self.buckets.prefill_len_buckets)
            tok = np.zeros((b, t), np.int64)
            pos = np.zeros((b, t), np.int64)
            msk = np.zeros((b, t), np.int64)
            last = np.zeros((b,), np.int64)
            for i, a in enumerate(rows):
                n = cnts[i]
                if n > 0:
                    tok[i, :n] = a.handle.req.prompt[offs[i]:offs[i] + n]
                    pos[i, :n] = np.arange(offs[i], offs[i] + n)
                    msk[i, :n] = 1
                    last[i] = n - 1
            picks = self._call(("fwd", "target", b, t), tok, pos, msk, last,
                               tables)
            for i, a in enumerate(rows):
                offs[i] += cnts[i]
                if cnts[i] > 0 and offs[i] >= a.prompt_len:
                    first[i] = picks[i]
            if all(offs[i] >= a.prompt_len for i, a in enumerate(rows)):
                break
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
            msk1 = np.zeros((b, 1), np.int64)
            for i, a in enumerate(rows):
                tok1[i, 0] = a.last_token
                pos1[i, 0] = a.prompt_len + len(a.out) - 1
                msk1[i, 0] = len(a.out) < a.handle.req.max_new_tokens
            nxt = self._call(("fwd", "target", b, 1), tok1, pos1, msk1,
                             np.zeros((b,), np.int64), tables)
            for i, a in enumerate(rows):
                if len(a.out) < a.handle.req.max_new_tokens:
                    a.out.append(int(nxt[i]))
                    a.last_token = int(nxt[i])
