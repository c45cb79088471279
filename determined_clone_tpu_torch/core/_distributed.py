"""DistributedContext — the port's single-rank copy of
``determined_clone_tpu/core/_distributed.py`` (``single()``).

The collectives of the Core API exchange small Python objects (storage
ids, shard manifests, preemption decisions); with one rank, the
preemption broadcast is the identity. Multi-rank groups, their
transports and collectives come with the parallelism slice.
"""
from __future__ import annotations

from typing import Any


class DistributedError(RuntimeError):
    pass


class DistributedContext:
    def __init__(self, *, rank: int = 0, size: int = 1) -> None:
        if size != 1 or rank != 0:
            raise DistributedError(
                f"rank {rank} of {size}: the port has one rank until the "
                f"parallelism slice (ROADMAP.md, Queue 1: parallelism)")
        self.rank = rank
        self.size = size

    @staticmethod
    def single() -> "DistributedContext":
        return DistributedContext(rank=0, size=1)

    @property
    def is_chief(self) -> bool:
        return self.rank == 0

    def broadcast(self, obj: Any) -> Any:
        return obj

    def close(self) -> None:
        pass
