"""Powers-of-two padding buckets — the port's own copy of
``determined_clone_tpu/serving/bucketing.py``.

The engine pads its dynamic dimensions (batch rows, prompt length) up to
a bucket from a small fixed ladder, so the paged forward only ever sees
``program_budget`` distinct shapes — the budget the JAX engine's jit
cache is held to, and the set of CUDA graphs the port's engine captures
at warmup (:meth:`BucketSpec.extended_budget` adds the draft model's
ladder, the speculative verify and the block copies).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


def pow2_buckets(lo: int, hi: int) -> Tuple[int, ...]:
    """Ascending powers of two covering [lo, hi]: first bucket >= lo,
    last bucket >= hi. pow2_buckets(1, 8) -> (1, 2, 4, 8);
    pow2_buckets(4, 100) -> (4, 8, 16, 32, 64, 128)."""
    if lo < 1 or hi < lo:
        raise ValueError(f"need 1 <= lo <= hi, got lo={lo} hi={hi}")
    buckets = []
    b = 1
    while b < lo:
        b *= 2
    while True:
        buckets.append(b)
        if b >= hi:
            return tuple(buckets)
        b *= 2


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n. Raises when n overflows the ladder — the
    caller (admission control) must reject before reaching here."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """The fixed shape ladder one engine instance serves.

    batch_buckets:       padded batch sizes, ascending pow2.
    prefill_len_buckets: padded prompt lengths, ascending pow2.
    Decode always runs at T=1, so its only dynamic dim is the batch.
    """
    batch_buckets: Tuple[int, ...]
    prefill_len_buckets: Tuple[int, ...]

    def __post_init__(self) -> None:
        for name, ladder in (("batch_buckets", self.batch_buckets),
                             ("prefill_len_buckets", self.prefill_len_buckets)):
            if not ladder:
                raise ValueError(f"{name} must be non-empty")
            if list(ladder) != sorted(set(ladder)):
                raise ValueError(f"{name} must be strictly ascending: {ladder}")
            for b in ladder:
                if b & (b - 1):
                    raise ValueError(f"{name} entries must be powers of two "
                                     f"(got {b})")

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    @property
    def max_prefill_len(self) -> int:
        return self.prefill_len_buckets[-1]

    @property
    def program_budget(self) -> int:
        """Number of distinct forward shapes: every (batch, prefill-length)
        pair plus a T=1 decode shape per batch bucket."""
        return (len(self.batch_buckets) * len(self.prefill_len_buckets)
                + len(self.batch_buckets))

    def validate_chunk_len(self, chunk_len: int) -> int:
        """Chunked prefill reuses the prefill ladder: a chunk call pads
        to ``chunk_len`` exactly, so requiring the chunk length to BE a
        ladder entry means chunking adds no program."""
        if chunk_len not in self.prefill_len_buckets:
            raise ValueError(
                f"chunk_prefill_len {chunk_len} must be one of the "
                f"prefill buckets {self.prefill_len_buckets} so chunked "
                f"prefill stays inside the program budget")
        return chunk_len

    def extended_budget(self, *, speculative: bool = False,
                        prefix_cache: bool = False,
                        kv_store: bool = False) -> int:
        """Programs across ALL the engine's device entry points (the
        number warmup captures):

        - base ladder (target prefill x batch + T=1 decode x batch);
        - speculative: the draft model runs the same ladder (its prefill
          mirrors every target prefill shape, its k-token proposal loop
          is T=1 decode), plus one k+1-token verify per batch bucket on
          the target;
        - prefix sharing: one copy-on-write block copy per pool pair
          (target, and draft when speculative);
        - KV tier: one block write per pool pair (counted for the JAX
          package's ladder; the port's engine writes a promoted block
          eagerly, in place, outside its ladder, and does not count it).
        """
        budget = self.program_budget
        if speculative:
            budget += self.program_budget + len(self.batch_buckets)
        if prefix_cache:
            budget += 2 if speculative else 1
        if kv_store:
            budget += 2 if speculative else 1
        return budget

    @staticmethod
    def build(max_batch: int, max_prefill_len: int, *,
              min_batch: int = 1, min_prefill_len: int = 8) -> "BucketSpec":
        return BucketSpec(
            batch_buckets=pow2_buckets(min_batch, max_batch),
            prefill_len_buckets=pow2_buckets(min(min_prefill_len,
                                                 max_prefill_len),
                                             max_prefill_len))
