"""Paged KV cache — the port of ``determined_clone_tpu/serving/kv_cache.py``.

A preallocated block pool plus per-sequence block tables (vLLM's
PagedAttention memory model): the pools are ``[L, num_blocks, block_size,
H, hd]`` tensors in the compute dtype, sized at startup and never
reallocated, and each admitted sequence owns the block ids covering
``ceil((prompt_len + max_new_tokens) / block_size)`` positions. The
:class:`BlockAllocator` is host-side bookkeeping (refcounts over a free
list), a copy of the JAX package's. Prefix sharing (``PrefixCache``)
comes with a later slice.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, List, Sequence, Tuple

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
    0-probability * 0-value under the attention mask.
    """
    dev = resolve_device(device)
    shape = (cfg.n_layers, cache.num_blocks, cache.block_size,
             cfg.n_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
            torch.zeros(shape, dtype=cfg.compute_dtype, device=dev))


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
