"""Online serving: paged KV cache with prefix sharing, the
continuous-batching engine (chunked prefill, speculative decoding, CUDA
graphs after warmup), the KV tiers below the prefix cache (host, CAS),
and the fleet: replicas behind the prefix-affinity router with drain,
blue-green rollout, supervision, autoscaling and chaos scenarios, the
HTTP front doors, and the master link (replicas as the master's serving
gang allocations)."""
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
from determined_clone_tpu_torch.serving.kv_store import (
    KVBlockStore,
    PrefixInventory,
    params_fingerprint,
    prompt_chain_keys,
)
from determined_clone_tpu_torch.serving.router import (
    ROUTER_RETRY,
    LeastLoadedRouter,
    NoHealthyReplica,
    RoutablePort,
)
from determined_clone_tpu_torch.serving.fleet import (
    FleetStats,
    MasterLink,
    PoisonPillRequest,
    Replica,
    RequestLedger,
    RolloutReport,
    ServingFleet,
)
from determined_clone_tpu_torch.serving.supervisor import FleetSupervisor
from determined_clone_tpu_torch.serving.autoscale import (
    AutoscalePolicy,
    Autoscaler,
    AutoscaleSignals,
    TimeSeriesSignals,
)

__all__ = [
    "ADMISSION_RETRY", "AutoscalePolicy", "AutoscaleSignals", "Autoscaler",
    "BlockAllocator", "BucketSpec", "EngineStats", "FleetStats",
    "FleetSupervisor", "InferenceEngine", "KVBlockStore", "KVCacheConfig",
    "LeastLoadedRouter", "MasterLink", "NoHealthyReplica",
    "PoisonPillRequest",
    "PrefixCache", "PrefixInventory", "PrefixMatch", "ROUTER_RETRY",
    "Replica", "ReplicaFailed", "Request", "RequestLedger", "RequestResult",
    "RolloutReport", "RoutablePort", "ServerOverloaded", "ServingFleet",
    "TimeSeriesSignals",
    "bucket_for", "init_kv_pools", "params_fingerprint", "pow2_buckets",
    "prompt_chain_keys",
]
