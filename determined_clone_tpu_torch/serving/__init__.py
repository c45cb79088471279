"""Online serving: paged KV cache with prefix sharing, the
continuous-batching engine (chunked prefill, speculative decoding, CUDA
graphs after warmup) and its HTTP server."""
from determined_clone_tpu_torch.serving.bucketing import (
    BucketSpec,
    bucket_for,
    pow2_buckets,
)
from determined_clone_tpu_torch.serving.engine import (
    ADMISSION_RETRY,
    EngineStats,
    InferenceEngine,
    ReplicaFailed,
    Request,
    RequestResult,
    ServerOverloaded,
)
from determined_clone_tpu_torch.serving.kv_cache import (
    BlockAllocator,
    KVCacheConfig,
    PrefixCache,
    PrefixMatch,
    init_kv_pools,
)

__all__ = [
    "ADMISSION_RETRY", "BlockAllocator", "BucketSpec", "EngineStats",
    "InferenceEngine", "KVCacheConfig", "PrefixCache", "PrefixMatch",
    "ReplicaFailed", "Request", "RequestResult", "ServerOverloaded",
    "bucket_for", "init_kv_pools", "pow2_buckets",
]
