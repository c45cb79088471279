"""The port's serving slice on the CPU: its own copies of the bucket
ladder and the block allocator against the JAX package's, and the
continuous-batching engine's greedy tokens against a greedy loop over
the JAX package's uncached ``gpt.apply`` on the same (converted) weights,
in fp32 — where the two frameworks differ only in summation order, far
below the logit gaps of these prompts.

Every engine runs as a context manager, so no ``serving-engine`` thread
outlives its test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_clone_tpu.models import gpt as jgpt
from determined_clone_tpu.serving import bucketing as jbucket
from determined_clone_tpu.serving import kv_cache as jkv
from determined_clone_tpu_torch import convert
from determined_clone_tpu_torch.models import gpt as tgpt
from determined_clone_tpu_torch.serving import (
    BlockAllocator,
    BucketSpec,
    InferenceEngine,
    KVCacheConfig,
    ServerOverloaded,
    bucket_for,
    init_kv_pools,
    pow2_buckets,
)

torch.set_num_threads(1)
if torch.get_num_interop_threads() != 1:
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:  # already fixed once inter-op work has run here
        pass

TINY = dict(vocab_size=256, n_layers=2, d_model=64, n_heads=4, d_ff=128,
            max_seq_len=48, remat=False, attention_impl="mha")
JCFG = jgpt.GPTConfig(**TINY, compute_dtype=jnp.float32)
TCFG = tgpt.GPTConfig(**TINY, compute_dtype=torch.float32)
BUCKETS = BucketSpec.build(4, 16)
CACHE = KVCacheConfig(num_blocks=16, block_size=8)
PROMPTS = [[5, 17, 3, 88, 41], [9] * 11, [1, 2, 3]]
NEW = 6


@pytest.fixture(scope="module")
def jax_params():
    return jax.jit(jgpt.init, static_argnums=1)(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def params(jax_params):
    return convert.params_from_numpy(jax.device_get(jax_params), "cpu")


@pytest.fixture(scope="module")
def expected(jax_params):
    """Greedy decode through the JAX uncached forward: every step re-runs
    the whole context. Rows are right-padded to one length so a single
    compiled program serves every step (causal attention keeps the
    padding out of each row's last real position)."""
    fwd = jax.jit(jgpt.apply, static_argnums=1)
    seqs = [list(p) for p in PROMPTS]
    width = max(len(p) for p in PROMPTS) + NEW
    for _ in range(NEW):
        tok = np.zeros((len(seqs), width), np.int32)
        for i, s in enumerate(seqs):
            tok[i, :len(s)] = s
        logits = np.asarray(fwd(jax_params, JCFG, jnp.asarray(tok)))
        for i, s in enumerate(seqs):
            s.append(int(logits[i, len(s) - 1].argmax()))
    return [s[len(p):] for s, p in zip(seqs, PROMPTS)]


def _engine(params, **kw):
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("cache", CACHE)
    return InferenceEngine(params, TCFG, device="cpu", **kw)


# -- own copies of the JAX package's pure-Python parts ------------------------

@pytest.mark.parametrize("lo,hi", [(1, 1), (1, 8), (4, 100), (3, 3), (8, 9)])
def test_pow2_buckets_match_jax(lo, hi):
    assert pow2_buckets(lo, hi) == jbucket.pow2_buckets(lo, hi)
    ladder = pow2_buckets(lo, hi)
    for n in range(1, ladder[-1] + 1):
        assert bucket_for(n, ladder) == jbucket.bucket_for(n, ladder)
    with pytest.raises(ValueError):
        bucket_for(ladder[-1] + 1, ladder)


def test_bucket_spec_matches_jax():
    for args in [(4, 16), (8, 128), (1, 4), (8, 256)]:
        mine, ref = BucketSpec.build(*args), jbucket.BucketSpec.build(*args)
        assert mine.batch_buckets == ref.batch_buckets
        assert mine.prefill_len_buckets == ref.prefill_len_buckets
        assert mine.program_budget == ref.program_budget
    for bad in [dict(batch_buckets=(3,), prefill_len_buckets=(8,)),
                dict(batch_buckets=(4, 2), prefill_len_buckets=(8,)),
                dict(batch_buckets=(), prefill_len_buckets=(8,))]:
        with pytest.raises(ValueError):
            BucketSpec(**bad)


def test_block_allocator_matches_jax():
    mine = BlockAllocator(KVCacheConfig(num_blocks=6, block_size=8))
    ref = jkv.BlockAllocator(jkv.KVCacheConfig(num_blocks=6, block_size=8))
    a, ra = mine.allocate(17), ref.allocate(17)
    assert a == ra and mine.free_blocks() == ref.free_blocks() == 3
    mine.retain(a[:1]), ref.retain(ra[:1])
    mine.release(a), ref.release(ra)
    assert mine.refcount(a[0]) == ref.refcount(ra[0]) == 1
    assert mine.allocate(8) == ref.allocate(8)
    with pytest.raises(MemoryError):
        mine.allocate(48)
    with pytest.raises(ValueError):
        mine.release([a[1]])  # double free
    with pytest.raises(ValueError):
        mine.release([99])    # bogus id
    with pytest.raises(ValueError):
        KVCacheConfig(num_blocks=4, block_size=6)


def test_kv_pools_layout_matches_jax():
    cache = KVCacheConfig(num_blocks=5, block_size=4)
    k, v = init_kv_pools(TCFG, cache, "cpu")
    jk, _ = jkv.init_kv_pools(JCFG, jkv.KVCacheConfig(5, 4))
    assert k.shape == v.shape == jk.shape and k.dtype == torch.float32
    assert not k.any() and not v.any()
    ref = jkv.KVCacheConfig(5, 4)
    for n in range(0, 14):
        assert cache.blocks_needed(n) == ref.blocks_needed(n)


# -- the engine ---------------------------------------------------------------

def test_engine_tokens_equal_jax_greedy(params, expected):
    with _engine(params) as eng:
        handles = [eng.submit(p, NEW, request_id=str(i))
                   for i, p in enumerate(PROMPTS)]
        results = [h.result(timeout=60) for h in handles]
        eng.wait_idle()
        stats = eng.stats()
    for i, r in enumerate(results):
        assert r.tokens == expected[i], f"request {i} diverged"
        assert r.finish_reason == "length"
        assert r.prompt_len == len(PROMPTS[i])
    assert stats.completed == 3 and stats.tokens_generated == 3 * NEW
    assert stats.free_blocks == CACHE.num_blocks  # everything released


def test_run_static_matches_continuous(params, expected):
    with _engine(params) as eng:
        results = eng.run_static([(p, NEW) for p in PROMPTS])
        after = eng.generate(PROMPTS[0], NEW)  # the scheduler still serves
        free = eng.stats().free_blocks
    assert [r.tokens for r in results] == expected
    assert after.tokens == expected[0]
    assert free == CACHE.num_blocks


def test_eos_stops_and_releases(params, expected):
    eos = expected[1][2]
    with _engine(params) as eng:
        r = eng.generate(PROMPTS[1], NEW, eos_token_id=eos)
        eng.wait_idle()
        free = eng.stats().free_blocks
    stop = expected[1].index(eos) + 1
    assert r.finish_reason == "eos" and r.tokens == expected[1][:stop]
    assert free == CACHE.num_blocks


def test_deferred_admission_when_pool_is_short(params, expected):
    """A pool that fits one request at a time: the others wait in the
    queue (FIFO), are admitted as blocks come back, and decode the same
    tokens."""
    tight = KVCacheConfig(num_blocks=3, block_size=8)  # 17 positions max
    with _engine(params, cache=tight) as eng:
        handles = [eng.submit(p, NEW) for p in PROMPTS]
        results = [h.result(timeout=60) for h in handles]
        eng.wait_idle()
        stats = eng.stats()
    assert [r.tokens for r in results] == expected
    assert stats.peak_active == 1 and stats.free_blocks == 3


def test_overload_and_never_servable(params):
    with _engine(params, max_queue_depth=0) as eng:
        with pytest.raises(ServerOverloaded):
            eng.submit([1, 2, 3], 4)
        assert eng.stats().rejected == 1
    with _engine(params, cache=KVCacheConfig(num_blocks=2,
                                             block_size=8)) as eng:
        for prompt, new in [([], 4),                  # empty prompt
                            ([1] * 4, 0),             # nothing to generate
                            ([1] * 17, 2),            # > largest bucket
                            ([1] * 16, 40),           # > max_seq_len
                            ([1] * 10, 10)]:          # > the whole pool
            with pytest.raises(ValueError):
                eng.submit(prompt, new)


def test_engine_needs_cuda_unless_cpu_is_asked(monkeypatch, params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(params, TCFG, buckets=BUCKETS, cache=CACHE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_pools(TCFG, CACHE)
