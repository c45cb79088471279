"""Online serving: paged KV cache and the continuous-batching engine."""
from determined_clone_tpu_torch.serving.bucketing import (
    BucketSpec,
    bucket_for,
    pow2_buckets,
)
from determined_clone_tpu_torch.serving.engine import (
    EngineStats,
    InferenceEngine,
    Request,
    RequestResult,
    ServerOverloaded,
)
from determined_clone_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    KVCacheConfig,
    init_kv_pools,
)

__all__ = [
    "BlockAllocator", "BucketSpec", "EngineStats", "InferenceEngine",
    "KVCacheConfig", "Request", "RequestResult", "ServerOverloaded",
    "bucket_for", "init_kv_pools", "pow2_buckets",
]
