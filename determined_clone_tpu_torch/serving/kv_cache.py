"""Paged KV cache — the port of ``determined_clone_tpu/serving/kv_cache.py``.

A preallocated block pool plus per-sequence block tables (vLLM's
PagedAttention memory model): the pools are ``[L, num_blocks, block_size,
H, hd]`` tensors in the compute dtype, sized at startup and never
reallocated, and each admitted sequence owns the block ids covering
``ceil((prompt_len + max_new_tokens) / block_size)`` positions. The
:class:`BlockAllocator` is host-side bookkeeping (refcounts over a free
list), a copy of the JAX package's.

Each layer of a pool is followed in memory by one hidden scratch block
(:func:`init_kv_pools`): the paged forward sends the K/V of masked
tokens there, so its scatter has a fixed shape (the JAX scatter drops
them with ``mode="drop"``; a data-dependent selection of the unmasked
rows would sync the host and could not be captured in a CUDA graph).
The scratch is outside the ``[L, N, bs, H, hd]`` view that the engine
and the tests see, and nothing ever reads it.

Prefix sharing rides on the refcounts: the :class:`PrefixCache`
content-hashes the prompt's blocks and lets a new sequence alias
already-resident block ids through its block table, so a shared system
prompt is stored once and its prefill skipped. A shared block is
immutable; the engine copy-on-write forks the one block a new owner
would ever write. With the KV tiers (serving/kv_store.py), eviction
demotes full blocks through the ``spill`` hook, and blocks promoted
from a tier are indexed with :meth:`PrefixCache.adopt`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from determined_clone_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_blocks: int
    block_size: int

    def __post_init__(self) -> None:
        if self.num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {self.num_blocks}")
        if self.block_size < 1 or self.block_size & (self.block_size - 1):
            raise ValueError(
                f"block_size must be a power of two, got {self.block_size}")

    def blocks_needed(self, total_len: int) -> int:
        return max(1, math.ceil(total_len / self.block_size))


def init_kv_pools(cfg: Any, cache: KVCacheConfig,
                  device: DeviceLike = "cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero K/V pools [L, N, block, H, hd] in the model's compute dtype.

    Zeros (not garbage) so never-written slots contribute exactly
    0-probability * 0-value under the attention mask. Each pool is a
    view of a ``[L, N + 1, block, H, hd]`` allocation: block ``N`` of
    every layer is the paged forward's scratch for masked tokens.
    """
    dev = resolve_device(device)
    shape = (cfg.n_layers, cache.num_blocks + 1, cache.block_size,
             cfg.n_heads, cfg.head_dim)
    return tuple(torch.zeros(shape, dtype=cfg.compute_dtype,
                             device=dev)[:, :cache.num_blocks]
                 for _ in range(2))


class BlockAllocator:
    """Thread-safe per-block refcounts over the pool's block ids.

    The scheduler thread allocates at admission and frees at retirement;
    request threads only read :meth:`free_blocks`, hence the lock. A block
    is free iff its refcount is zero; :meth:`allocate` hands blocks out at
    refcount 1, :meth:`retain` adds owners, and :meth:`release` returns a
    block to the free list when its last owner lets go.
    """

    def __init__(self, cache: KVCacheConfig) -> None:
        self._cache = cache
        self._lock = threading.Lock()
        self._free: List[int] = list(range(cache.num_blocks - 1, -1, -1))
        self._ref: List[int] = [0] * cache.num_blocks

    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref[block]

    def allocate(self, total_len: int) -> List[int]:
        """Reserve blocks covering ``total_len`` positions; raises
        MemoryError when the pool can't."""
        return self.allocate_blocks(self._cache.blocks_needed(total_len))

    def allocate_blocks(self, need: int) -> List[int]:
        with self._lock:
            if need > len(self._free):
                raise MemoryError(
                    f"KV pool exhausted: need {need} blocks, "
                    f"{len(self._free)}/{self._cache.num_blocks} free")
            got = [self._free.pop() for _ in range(need)]
            for b in got:
                self._ref[b] = 1
        return got

    def retain(self, blocks: Sequence[int]) -> None:
        """Add one owner to each block; only live blocks can be shared."""
        with self._lock:
            for b in blocks:
                if not 0 <= b < self._cache.num_blocks or self._ref[b] < 1:
                    raise ValueError(f"retain of free/bogus block {b}")
                self._ref[b] += 1

    def release(self, blocks: Sequence[int]) -> None:
        with self._lock:
            for b in blocks:
                if not 0 <= b < self._cache.num_blocks or self._ref[b] < 1:
                    raise ValueError(f"double/bogus free of block {b}")
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    self._free.append(b)

    def outstanding(self) -> int:
        """Blocks currently owned by someone (refcount > 0)."""
        with self._lock:
            return self._cache.num_blocks - len(self._free)

    def assert_balanced(self, expected_outstanding: int = 0) -> None:
        """Audit hook: every block not on the free list must be accounted
        for by ``expected_outstanding`` live owners' worth of blocks —
        with no active sequence and no prefix cache, anything else is a
        leak."""
        with self._lock:
            held = self._cache.num_blocks - len(self._free)
            if held != expected_outstanding:
                owners = [i for i, r in enumerate(self._ref) if r > 0]
                raise AssertionError(
                    f"KV block balance: {held} blocks outstanding, "
                    f"expected {expected_outstanding} "
                    f"(held block ids: {owners[:16]}"
                    f"{'...' if len(owners) > 16 else ''})")


@dataclasses.dataclass
class PrefixMatch:
    """What :meth:`PrefixCache.match` found for one prompt.

    ``blocks`` are resident block ids covering prompt positions
    ``[0, shared_len)`` in order, already retained on behalf of the
    caller (who must release them, or hand them to a sequence that
    will). ``shared_len`` counts whole shared positions; it is a
    multiple of the block size except when the final entry was an exact
    partial-tail hit, in which case ``shared_len == len(prompt)``.
    """
    blocks: List[int]
    shared_len: int


class PrefixCache:
    """Content-addressed index of resident prompt blocks.

    Keys are chained hashes — ``h_i = sha256(h_{i-1} || tokens of block
    i)`` with ``h_{-1}`` empty — so a key identifies both a block's
    tokens and its absolute position, which is what lets a block table
    alias it verbatim. Full prompt blocks are keyed by their chain hash;
    the prompt's partial tail block is keyed by the chain hash of the
    full prefix plus ``#tail`` and the exact tail tokens, so only a
    byte-identical prompt can alias it.

    The cache holds one allocator reference per indexed block; sequences
    sharing a block add their own. Eviction (LRU, deepest-first so a
    chain never strands unreachable descendants) merely drops the
    cache's reference — blocks stay alive until their last sequence
    retires.

    The optional ``spill`` callback turns eviction into demotion: it is
    called with ``(key, block, depth)`` for every evicted full-block
    entry while the cache still holds its reference (so the block's
    contents are intact), letting the engine copy the exact K/V into the
    host/CAS tiers. Tail-keyed entries never spill — they are private to
    one exact prompt. The callback must not raise.

    Single-writer: all mutation happens on the engine's scheduler
    thread.
    """

    def __init__(self, cache: KVCacheConfig,
                 allocator: BlockAllocator, *,
                 spill: Optional[Callable[[bytes, int, int], Any]] = None
                 ) -> None:
        self._cfg = cache
        self._alloc = allocator
        self._spill = spill
        # key -> (block id, depth, last-used tick, tail?); depth = block
        # index within the prompt, used to evict leaves before parents
        self._entries: Dict[bytes, Tuple[int, int, int, bool]] = {}
        self._tick = 0

    @staticmethod
    def _chain(prev: bytes, tokens: Sequence[int]) -> bytes:
        h = hashlib.sha256(prev)
        h.update(b"|" + ",".join(str(int(t)) for t in tokens).encode())
        return h.digest()

    @staticmethod
    def _tail_key(prev: bytes, tokens: Sequence[int]) -> bytes:
        return PrefixCache._chain(prev + b"#tail", tokens)

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, prompt: Sequence[int]) -> PrefixMatch:
        """Longest resident prefix of ``prompt``, caller-retained."""
        bs = self._cfg.block_size
        blocks: List[int] = []
        shared = 0
        prev = b""
        self._tick += 1
        n_full = len(prompt) // bs
        for i in range(n_full):
            key = self._chain(prev, prompt[i * bs:(i + 1) * bs])
            ent = self._entries.get(key)
            if ent is None:
                break
            self._entries[key] = (ent[0], ent[1], self._tick, ent[3])
            blocks.append(ent[0])
            shared += bs
            prev = key
        else:
            tail = prompt[n_full * bs:]
            if tail:
                key = self._tail_key(prev, tail)
                ent = self._entries.get(key)
                if ent is not None:
                    self._entries[key] = (ent[0], ent[1], self._tick, ent[3])
                    blocks.append(ent[0])
                    shared += len(tail)
        if blocks:
            self._alloc.retain(blocks)
        return PrefixMatch(blocks, shared)

    def register(self, prompt: Sequence[int], blocks: Sequence[int]) -> None:
        """Index a just-prefilled prompt's blocks (one id per prompt
        block, in order). Already-indexed keys are left alone — first
        writer wins, and colliding later sequences hold private copies."""
        bs = self._cfg.block_size
        self._tick += 1
        prev = b""
        n_full = len(prompt) // bs
        for i in range(n_full):
            key = self._chain(prev, prompt[i * bs:(i + 1) * bs])
            if key not in self._entries:
                self._alloc.retain([blocks[i]])
                self._entries[key] = (blocks[i], i, self._tick, False)
            prev = key
        tail = prompt[n_full * bs:]
        if tail:
            key = self._tail_key(prev, tail)
            if key not in self._entries:
                self._alloc.retain([blocks[n_full]])
                self._entries[key] = (blocks[n_full], n_full, self._tick,
                                      True)

    def has_key(self, key: bytes) -> bool:
        return key in self._entries

    def adopt(self, key: bytes, block: int, depth: int) -> None:
        """Index a block promoted from a lower tier. The cache takes over
        the caller's allocator reference — the caller allocated the
        block (refcount 1) and must not release it. Only full blocks are
        promoted, so adopted entries are never tail-keyed."""
        if key in self._entries:
            raise ValueError("adopt of an already-indexed prefix key")
        self._tick += 1
        self._entries[key] = (block, depth, self._tick, False)

    def entries(self) -> List[Tuple[bytes, int, int]]:
        """``(key, block, depth)`` of every full-block entry, for the
        engine's flush-to-tier path and the prefix-inventory digest.
        Tail-keyed entries are omitted: they never spill or advertise."""
        return [(k, e[0], e[1]) for k, e in self._entries.items()
                if not e[3]]

    def evict(self, want_free: int) -> int:
        """Drop LRU entries until the allocator has ``want_free`` free
        blocks or the cache is empty. Oldest tick first, deepest block
        first on ties, so a chain's leaves go before its root. Full-block
        entries are offered to ``spill`` before their reference is
        released. Returns entries dropped."""
        dropped = 0
        while self._entries and self._alloc.free_blocks() < want_free:
            key = min(self._entries,
                      key=lambda k: (self._entries[k][2],
                                     -self._entries[k][1]))
            block, depth, _, tail = self._entries.pop(key)
            if self._spill is not None and not tail:
                self._spill(key, block, depth)
            self._alloc.release([block])
            dropped += 1
        return dropped

    def flush(self) -> int:
        """Drop everything — cached KV is a function of the params, so
        hot-swap invalidates the whole index. No spill: a deliberate
        flush-to-tier goes through the engine's ``flush_kv_to_tier()``,
        which snapshots :meth:`entries` first."""
        n = len(self._entries)
        for block, _, _, _ in self._entries.values():
            self._alloc.release([block])
        self._entries.clear()
        return n
