"""The port's serving slice on the CPU: its own copies of the bucket
ladder, the block allocator, the prefix cache and the ``serving:``
config against the JAX package's; ``forward_paged_logits`` and the
identity-layer helpers against the JAX functions; and the
continuous-batching engine's greedy tokens against a greedy loop over
the JAX package's uncached ``gpt.apply`` on the same (converted) weights,
in fp32 — where the two frameworks differ only in summation order, far
below the logit gaps of these prompts.

Every engine runs as a context manager, so no ``serving-engine`` thread
outlives its test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_clone_tpu.config import experiment as jexp
from determined_clone_tpu.models import gpt as jgpt
from determined_clone_tpu.serving import bucketing as jbucket
from determined_clone_tpu.serving import kv_cache as jkv
from determined_clone_tpu_torch import convert
from determined_clone_tpu_torch.config import experiment as texp
from determined_clone_tpu_torch.models import gpt as tgpt
from determined_clone_tpu_torch.serving import (
    BlockAllocator,
    BucketSpec,
    InferenceEngine,
    KVCacheConfig,
    PrefixCache,
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


def test_engine_warmup_readies_the_ladder_on_the_cpu(params, expected):
    """On the CPU warmup runs every program of the ladder once (nothing
    reaches the pools) and counts them; traffic afterwards adds none."""
    with _engine(params) as eng:
        assert eng.programs_compiled() == 0
        assert eng.warmup() == eng.program_budget() == BUCKETS.program_budget
        assert eng.generate(PROMPTS[0], NEW).tokens == expected[0]
        assert eng.programs_compiled() == BUCKETS.program_budget
        calls = eng.program_calls()
    assert calls["replays"] == 0 and calls["eager"] == \
        BUCKETS.program_budget + NEW


# -- the bucket ladder's speed-feature budget ---------------------------------

@pytest.mark.parametrize("args", [(4, 16), (8, 128), (1, 8), (2, 64)])
def test_chunk_len_and_extended_budget_match_jax(args):
    mine, ref = BucketSpec.build(*args), jbucket.BucketSpec.build(*args)
    for n in (1, 5, 8, 16, 32, 100, 128, 256):
        if n in ref.prefill_len_buckets:
            assert mine.validate_chunk_len(n) == ref.validate_chunk_len(n)
        else:
            with pytest.raises(ValueError):
                ref.validate_chunk_len(n)
            with pytest.raises(ValueError):
                mine.validate_chunk_len(n)
    for spec in (False, True):
        for prefix in (False, True):
            for tier in (False, True):
                kw = dict(speculative=spec, prefix_cache=prefix,
                          kv_store=tier)
                assert mine.extended_budget(**kw) == \
                    ref.extended_budget(**kw)


# -- allocator refcounts and the prefix cache, scripted on both ---------------

def test_allocator_and_prefix_cache_script_matches_jax():
    """The same script of allocate, retain, release, match, register,
    evict and flush on both packages: the same block ids, refcounts,
    matches and entry counts at every step."""
    cfg = dict(num_blocks=10, block_size=4)
    ta = BlockAllocator(KVCacheConfig(**cfg))
    ja = jkv.BlockAllocator(jkv.KVCacheConfig(**cfg))
    tc = PrefixCache(KVCacheConfig(**cfg), ta)
    jc = jkv.PrefixCache(jkv.KVCacheConfig(**cfg), ja)

    def same():
        assert ta.free_blocks() == ja.free_blocks()
        assert ta.outstanding() == ja.outstanding()
        assert [ta.refcount(b) for b in range(10)] == \
            [ja.refcount(b) for b in range(10)]
        assert len(tc) == len(jc)

    p1 = list(range(1, 11))                  # 2 full blocks + 2-token tail
    p2 = p1[:8] + [70, 71, 72]               # shares two full blocks
    b1, jb1 = ta.allocate(len(p1) + 3), ja.allocate(len(p1) + 3)
    assert b1 == jb1
    tc.register(p1, b1), jc.register(p1, jb1)
    same()
    for prompt in (p1, p2, p1[:8], [5] + p1[1:], p1[:3]):
        tm, jm = tc.match(prompt), jc.match(prompt)
        assert (tm.blocks, tm.shared_len) == (jm.blocks, jm.shared_len)
        same()
        ta.release(tm.blocks), ja.release(jm.blocks)
    b2, jb2 = ta.allocate(len(p2)), ja.allocate(len(p2))
    assert b2 == jb2
    tc.register(p2, b2), jc.register(p2, jb2)   # first writer wins
    ta.retain(b2[:1]), ja.retain(jb2[:1])
    same()
    ta.release(b1), ja.release(jb1)
    ta.release(b2), ja.release(jb2)
    same()
    assert tc.evict(8) == jc.evict(8)            # LRU, deepest first
    same()
    assert tc.evict(10) == jc.evict(10)
    same()
    ta.release(b2[:1]), ja.release(jb2[:1])
    ta.assert_balanced(0), ja.assert_balanced(0)
    with pytest.raises(AssertionError):
        ta.assert_balanced(1)
    b3 = ta.allocate(8)
    tc.register(p1[:8], b3)
    ta.release(b3)
    assert tc.flush() == 2 and ta.outstanding() == 0
    assert PrefixCache._chain(b"", p1[:4]) == jkv.PrefixCache._chain(
        b"", p1[:4])
    assert PrefixCache._tail_key(b"x", [1, 2]) == \
        jkv.PrefixCache._tail_key(b"x", [1, 2])


# -- the serving: config block ------------------------------------------------

SERVING_GOOD = [
    {},
    {"max_batch": 4, "max_prefill_len": 64, "kv_block_size": 8,
     "kv_blocks": 100, "max_queue_depth": 3, "default_max_new_tokens": 9,
     "host": "0.0.0.0", "port": 9000},
    {"prefix_cache": True, "chunk_prefill_len": 16,
     "speculative": {"enabled": True, "k": 3, "draft_layers": 2,
                     "draft_d_model": 64, "draft_n_heads": 2,
                     "draft_d_ff": 256}},
    {"max_prefill_len": 4, "chunk_prefill_len": 4},
]
SERVING_BAD = [
    [], {"max_batch": 3}, {"max_prefill_len": 0}, {"kv_block_size": 12},
    {"kv_blocks": -1}, {"max_queue_depth": 0},
    {"default_max_new_tokens": 0}, {"port": 0}, {"port": 70000},
    {"chunk_prefill_len": -8}, {"chunk_prefill_len": 5},
    {"chunk_prefill_len": 256}, {"chunk_prefill_len": 4},
    {"speculative": []}, {"speculative": {"k": 0}},
    {"speculative": {"k": 17}}, {"speculative": {"draft_layers": 0}},
    {"speculative": {"draft_d_model": 10, "draft_n_heads": 4}},
]


@pytest.mark.parametrize("raw", SERVING_GOOD)
def test_serving_config_parses_as_jax(raw):
    mine = texp.ServingConfig.from_dict(raw)
    ref = jexp.ServingConfig.from_dict(raw)
    assert mine.to_dict() == ref.to_dict()
    assert dataclasses.asdict(texp.SpeculativeConfig.from_dict(
        raw.get("speculative", {}))) == dataclasses.asdict(
        jexp.SpeculativeConfig.from_dict(raw.get("speculative", {})))
    exp = texp.ExperimentConfig.from_dict({"serving": raw} if raw else {})
    assert (exp.serving.to_dict() if raw else exp.serving) == \
        (mine.to_dict() if raw else None)


@pytest.mark.parametrize("raw", SERVING_BAD)
def test_serving_config_refuses_as_jax(raw):
    with pytest.raises(jexp.ConfigError) as ref:
        jexp.ServingConfig.from_dict(raw)
    with pytest.raises(texp.ConfigError) as mine:
        texp.ServingConfig.from_dict(raw)
    assert str(mine.value) == str(ref.value)


def test_experiment_config_refuses_unknown_serving_keys():
    for raw, where in [({"max_batc": 4}, "serving.max_batc"),
                       ({"speculative": {"draught": 1}},
                        "serving.speculative.draught")]:
        with pytest.raises(texp.ConfigError, match=f"{where}: unknown"):
            texp.ExperimentConfig.from_dict({"serving": raw})


# -- the verify forward and the identity-layer testbed ------------------------

def _paged_inputs(rng, B, T, lens, start):
    tok = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    msk = np.zeros((B, T), bool)
    for i, n in enumerate(lens):
        tok[i, :n] = rng.integers(0, TINY["vocab_size"], n)
        pos[i, :n] = np.arange(start[i], start[i] + n)
        msk[i, :n] = True
    return tok, pos, msk


def test_forward_paged_logits_matches_jax(jax_params, params):
    """A prefill, then a k+1 = 4 token verify whose last rows run past
    the block table (masked): logits at every position within 1e-5
    relative of the JAX function's, and both pools the same."""
    cache = dict(num_blocks=12, block_size=8)
    jk, jv = jkv.init_kv_pools(JCFG, jkv.KVCacheConfig(**cache))
    tk, tv = init_kv_pools(TCFG, KVCacheConfig(**cache), "cpu")
    tables = np.array([[3, 7, 0, 0, 0, 0], [5, 1, 9, 2, 4, 6],
                       [0, 0, 0, 0, 0, 0]], np.int32)
    rng = np.random.default_rng(3)
    jfwd = jax.jit(jgpt.forward_paged_logits, static_argnums=1)
    for T, lens, start in [(16, [11, 16], [0, 0]), (4, [4, 3], [11, 45])]:
        tok, pos, msk = _paged_inputs(rng, 3, T, lens, start)
        if T == 4:
            pos[1, 3] = 48          # masked, one past the table's reach
        jl, jk, jv = jfwd(jax_params, JCFG,
                          *(jnp.asarray(a) for a in (tok, pos, msk)),
                          jk, jv, jnp.asarray(tables))
        tl, tk2, tv2 = tgpt.forward_paged_logits(
            params, TCFG, *(torch.from_numpy(a) for a in (tok, pos, msk)),
            tk, tv, torch.from_numpy(tables))
        assert tk2 is tk and tv2 is tv and tl.shape == (3, T, 256)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)


def test_paged_forward_needs_pools_with_scratch(params):
    """Masked tokens' K/V go to the scratch block behind each layer; a
    plain pool has none and is refused before anything is written (its
    last-but-one layer's "scratch" would be the next layer's block 0)."""
    plain = torch.zeros((2, 4, 8, 4, 16))
    plain_v = plain.clone()
    args = (torch.zeros((1, 2), dtype=torch.long),) * 2 + (
        torch.tensor([[True, False]]),)
    with pytest.raises(ValueError, match="init_kv_pools"):
        tgpt.forward_paged_logits(params, TCFG, *args, plain, plain_v,
                                  torch.zeros((1, 6), dtype=torch.long))
    assert not plain.any() and not plain_v.any()
    # a slice of init_kv_pools' pools that drops layers keeps the layout
    k, v = init_kv_pools(TCFG, KVCacheConfig(num_blocks=4, block_size=8),
                         "cpu")
    with pytest.raises(ValueError, match="init_kv_pools"):
        tgpt.forward_paged_logits(params, TCFG, *args,
                                  k.contiguous(), v.contiguous(),
                                  torch.zeros((1, 6), dtype=torch.long))


def test_identity_extension_and_prefix_slice_are_exact(jax_params, params):
    """Identity layers leave the logits equal bit for bit (and the
    extended tree equals the JAX helper's); slicing them off gives the
    original leaves back."""
    jext, jcfg = jgpt.extend_with_identity_layers(jax_params, JCFG, 2)
    text, tcfg = tgpt.extend_with_identity_layers(params, TCFG, 2)
    assert tcfg.n_layers == jcfg.n_layers == 4
    for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(jext),
            jax.tree_util.tree_leaves(text)):
        assert np.array_equal(np.asarray(a), b.numpy()), path
    x = torch.tensor([PROMPTS[1]])
    assert torch.equal(tgpt.apply(text, tcfg, x), tgpt.apply(params, TCFG, x))
    sliced, scfg = tgpt.slice_prefix_layers(text, tcfg, 2)
    assert scfg.n_layers == 2
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(sliced), jax.tree_util.tree_leaves(params)))
    assert tgpt.extend_with_identity_layers(params, TCFG, 0)[1] is TCFG
    for bad in (0, 5):
        with pytest.raises(ValueError):
            tgpt.slice_prefix_layers(text, tcfg, bad)
