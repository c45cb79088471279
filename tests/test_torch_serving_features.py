"""The port's serving features on the CPU, against the JAX package's
engine on the same weights (JAX ``init`` converted leaf for leaf) and
the same scripted requests: copy-on-write prefix sharing, chunked
prefill, speculative decoding with a disagreeing and with an identity
draft, all of them together, warmup's program count, and the request
lifecycle (abort, deadline, hot-swap, hot-load, condemnation).

Tolerance: tokens and counters are compared exactly. Compute is fp32,
where the two frameworks differ only in summation order (~1e-6 of the
logits), far below the logit gaps of these prompts. The JAX engine's
own tests pin it to its uncached greedy loop; the port's engine is
also held to the port's uncached greedy loop here.

Requests whose prefix-cache counters are compared run one after
another (``generate``), so both engines see the same admission order.
Every engine runs as a context manager, so no ``serving-engine`` thread
outlives its test.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from determined_clone_tpu.core._serialization import save_pytree
from determined_clone_tpu.models import gpt as jgpt
from determined_clone_tpu.serving import bucketing as jbucket
from determined_clone_tpu.serving import engine as jengine
from determined_clone_tpu.serving import kv_cache as jkv
from determined_clone_tpu_torch import convert, faults
from determined_clone_tpu_torch.models import gpt as tgpt
from determined_clone_tpu_torch.serving import (
    BucketSpec,
    InferenceEngine,
    KVCacheConfig,
    ReplicaFailed,
)
from determined_clone_tpu_torch.storage import SharedFSStorageManager

torch.set_num_threads(1)
if torch.get_num_interop_threads() != 1:
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:  # already fixed once inter-op work has run here
        pass

JCFG = dataclasses.replace(jgpt.GPTConfig.tiny(), compute_dtype=jnp.float32,
                           attention_impl="mha")
TCFG = dataclasses.replace(tgpt.GPTConfig.tiny(), compute_dtype=torch.float32,
                           attention_impl="mha")
LADDER = (4, 16)           # batch buckets (1, 2, 4), prefill (8, 16)
POOL = dict(num_blocks=40, block_size=8)
PROMPTS = [[5, 17, 3, 88, 41], [9] * 11, [1, 2, 3]]
LONG = [(7 * i) % 250 + 1 for i in range(37)]   # > the largest bucket


def _init(seed, cfg=JCFG):
    """JAX ``init`` scaled by 10: a freshly initialised tiny GPT's greedy
    decode only repeats the last prompt token, which would leave every
    model agreeing with every other."""
    jp = jax.jit(jgpt.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)
    jp = jax.tree_util.tree_map(lambda x: x * 10.0, jp)
    return jp, convert.params_from_numpy(jax.device_get(jp), "cpu")


@pytest.fixture(scope="module")
def models():
    """(jax, port) params of the target and of a disagreeing draft with
    the target's architecture and other weights."""
    return {"target": _init(0), "draft": _init(7)}


def jax_engine(jparams, cfg=JCFG, **kw):
    return jengine.InferenceEngine(
        jparams, cfg, buckets=jbucket.BucketSpec.build(*LADDER),
        cache=jkv.KVCacheConfig(**POOL), **kw)


def port_engine(tparams, cfg=TCFG, **kw):
    return InferenceEngine(tparams, cfg, buckets=BucketSpec.build(*LADDER),
                           cache=KVCacheConfig(**POOL), device="cpu", **kw)


def port_greedy(params, prompt, n, cfg=TCFG):
    """The port's uncached greedy loop."""
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = tgpt.apply(params, cfg, torch.tensor([toks]))
            toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


def summary(results):
    return [(r.tokens, r.finish_reason, r.prefix_hit_blocks,
             r.prefix_miss_blocks, r.spec_proposed, r.spec_accepted)
            for r in results]


def stat_counts(stats):
    return (stats.prefix_hit_blocks, stats.prefix_miss_blocks,
            stats.prefix_cached_entries, stats.spec_tokens_proposed,
            stats.spec_tokens_accepted, stats.free_blocks)


def run_sequential(eng, reqs):
    out = [eng.generate(p, n, timeout=120.0) for p, n in reqs]
    eng.wait_idle()
    return out, eng.stats()


def run_burst(eng, reqs):
    handles = [eng.submit(p, n, request_id=str(i))
               for i, (p, n) in enumerate(reqs)]
    out = [h.result(timeout=120.0) for h in handles]
    eng.wait_idle()
    return out, eng.stats()


# -- prefix sharing -----------------------------------------------------------

def test_prefix_cache_matches_jax(models):
    """Cold, exact repeat (full block + tail hit: the partial last block
    is forked), a prompt sharing only the full block, and a prompt of
    exactly the cached full block (forked, as it holds the re-scored
    last token): the same tokens, per-request hit/miss counts
    and cache entries as the JAX engine; the blocks left held are the
    cache's, and a flush returns them."""
    jp, tp = models["target"]
    base = list(range(1, 12))           # 1 full block + 3-token tail
    fork = base[:8] + [61, 62, 63]      # shares the full block only
    reqs = [(base, 8), (base, 8), (fork, 8), (base[:8], 6), (base[:8], 6)]
    with jax_engine(jp, prefix_cache=True) as je:
        jres, jstats = run_sequential(je, reqs)
    with port_engine(tp, prefix_cache=True) as te:
        tres, tstats = run_sequential(te, reqs)
        te.assert_kv_balanced(tstats.prefix_cached_entries)
        assert te.kv_outstanding() == tstats.prefix_cached_entries > 0
        assert te.flush_prefix_cache() == tstats.prefix_cached_entries
        te.assert_kv_balanced(0)
        dump = te.registry.dump()
    assert summary(tres) == summary(jres)
    assert stat_counts(tstats) == stat_counts(jstats)
    assert [r.prefix_hit_blocks for r in tres] == [0, 2, 1, 1, 1]
    assert tres[0].tokens == port_greedy(tp, base, 8)
    assert tres[2].tokens == port_greedy(tp, fork, 8)
    assert f"prefix_cache_hit_blocks_total {tstats.prefix_hit_blocks}" \
        in dump


# -- chunked prefill ----------------------------------------------------------

def test_chunked_prefill_matches_jax_and_replays_static(models):
    """A prompt longer than the largest bucket is refused without
    chunking and served chunk by chunk with it, beside short requests;
    tokens equal the JAX engine's, and run_static replays the workload
    with the same tokens."""
    jp, tp = models["target"]
    reqs = [(LONG, 6), (PROMPTS[0], 6), (PROMPTS[2], 6)]
    with port_engine(tp) as te:
        with pytest.raises(ValueError, match="exceeds the largest"):
            te.submit(LONG, 4)
    with pytest.raises(ValueError):
        port_engine(tp, chunk_prefill_len=5)    # not a bucket size
    with jax_engine(jp, chunk_prefill_len=8) as je:
        jres, _ = run_burst(je, reqs)
    with port_engine(tp, chunk_prefill_len=8) as te:
        tres, tstats = run_burst(te, reqs)
        static = te.run_static(reqs, timeout=120.0)
        te.assert_kv_balanced(0)
    assert summary(tres) == summary(jres)
    assert [r.tokens for r in static] == [r.tokens for r in tres]
    assert tres[0].tokens == port_greedy(tp, LONG, 6)
    assert tstats.free_blocks == POOL["num_blocks"]


# -- speculative decoding -----------------------------------------------------

def test_speculative_disagreeing_draft_matches_jax(models):
    """A draft with other weights disagrees almost everywhere: the tokens
    are still plain greedy decode's, and the proposed and accepted
    counts per request equal the JAX engine's."""
    (jp, tp), (jd, td) = models["target"], models["draft"]
    reqs = [(p, 8) for p in PROMPTS] + [(PROMPTS[1], 3)]
    with jax_engine(jp, speculative_k=3, draft_params=jd,
                    draft_cfg=JCFG) as je:
        jres, jstats = run_burst(je, reqs)
    with port_engine(tp, speculative_k=3, draft_params=td,
                     draft_cfg=TCFG) as te:
        tres, tstats = run_burst(te, reqs)
    assert summary(tres) == summary(jres)
    assert stat_counts(tstats) == stat_counts(jstats)
    assert tstats.spec_tokens_proposed > 0
    for (p, n), r in zip(reqs, tres):
        assert r.tokens == port_greedy(tp, p, n)
        assert 0 <= r.spec_accepted <= r.spec_proposed


def test_speculative_identity_draft_accepts_everything(models):
    """Target = the model extended by identity layers, draft = the
    model itself: every proposal verifies (acceptance exactly 1.0), and
    the tokens are the model's greedy ones — as in the JAX engine."""
    jp, tp = models["target"]
    jext, jext_cfg = jgpt.extend_with_identity_layers(jp, JCFG, 2)
    text, text_cfg = tgpt.extend_with_identity_layers(tp, TCFG, 2)
    reqs = [(PROMPTS[0], 9), (PROMPTS[1], 7)]
    with jax_engine(jext, jext_cfg, speculative_k=3, draft_params=jp,
                    draft_cfg=JCFG) as je:
        jres, _ = run_burst(je, reqs)
    with port_engine(text, text_cfg, speculative_k=3, draft_params=tp,
                     draft_cfg=TCFG) as te:
        tres, tstats = run_burst(te, reqs)
    assert summary(tres) == summary(jres)
    assert tstats.spec_acceptance_rate == 1.0
    for (p, n), r in zip(reqs, tres):
        assert r.spec_acceptance == 1.0
        assert r.tokens == port_greedy(tp, p, n)


def test_draft_loop_with_and_without_the_last_proposal_write(models):
    """The JAX engine's draft never writes its k-th proposal's K/V, so
    after a fully accepted round its draft attends to a stale slot and
    even the identity testbed's proposals are rejected now and then. The
    port's draft writes it: on the identity testbed it accepts every
    proposal, and the tokens are the JAX engine's (greedy decode's)."""
    jp, tp = models["target"]
    jext, jext_cfg = jgpt.extend_with_identity_layers(jp, JCFG, 1)
    text, text_cfg = tgpt.extend_with_identity_layers(tp, TCFG, 1)
    reqs = [(LONG[:12], 20), (PROMPTS[0], 17), (PROMPTS[2], 23)]
    with jax_engine(jext, jext_cfg, speculative_k=2, draft_params=jp,
                    draft_cfg=JCFG) as je:
        jres, jstats = run_burst(je, reqs)
    with port_engine(text, text_cfg, speculative_k=2, draft_params=tp,
                     draft_cfg=TCFG) as te:
        tres, tstats = run_burst(te, reqs)
    # the stale slot costs the JAX loop acceptances (0.4 here)
    assert jstats.spec_tokens_proposed > 0
    assert jstats.spec_acceptance_rate < 1.0
    assert tstats.spec_acceptance_rate == 1.0
    assert all(r.spec_acceptance == 1.0 for r in tres)
    assert [r.tokens for r in tres] == [r.tokens for r in jres] == [
        port_greedy(tp, p, n) for p, n in reqs]
    assert tstats.free_blocks == POOL["num_blocks"]


# -- all together -------------------------------------------------------------

def test_all_features_warmup_budget_and_parity(models):
    """Prefix sharing, chunked prefill and speculation at once: warmup
    readies exactly program_budget programs (the JAX engine's budget for
    the same ladder), traffic adds none, and tokens and counters equal
    the JAX engine's."""
    (jp, tp), (jd, td) = models["target"], models["draft"]
    kw = dict(prefix_cache=True, chunk_prefill_len=8, speculative_k=3)
    reqs = [(LONG, 8), (LONG, 8), (PROMPTS[1], 5), (PROMPTS[1], 5),
            (LONG[:16] + [3, 4], 6)]
    with jax_engine(jp, draft_params=jd, draft_cfg=JCFG, **kw) as je:
        jres, jstats = run_sequential(je, reqs)
        jbudget = je.program_budget()
    with port_engine(tp, draft_params=td, draft_cfg=TCFG, **kw) as te:
        budget = te.program_budget()
        assert te.programs_compiled() == 0
        assert te.warmup() == budget
        tres, tstats = run_sequential(te, reqs)
        assert te.programs_compiled() == budget
        te.assert_kv_balanced(tstats.prefix_cached_entries)
    assert budget == jbudget == BucketSpec.build(*LADDER).extended_budget(
        speculative=True, prefix_cache=True)
    assert summary(tres) == summary(jres)
    assert stat_counts(tstats) == stat_counts(jstats)
    assert tstats.prefix_hit_blocks > 0 and tstats.spec_tokens_proposed > 0


# -- lifecycle ----------------------------------------------------------------

def test_abort_and_deadline_release_every_block(models):
    """An abort mid-decode resolves "aborted" with the tokens so far; a
    deadline already past expires at admission; one that passes
    mid-decode expires then. Every block comes back each time."""
    (_, tp), (_, td) = models["target"], models["draft"]
    with port_engine(tp, prefix_cache=True, speculative_k=3,
                     draft_params=td, draft_cfg=TCFG,
                     iteration_floor_s=0.02) as te:
        te.generate(PROMPTS[1], 4)          # seed the prefix cache
        held = te.stats().prefix_cached_entries
        h = te.submit(PROMPTS[1], 60)
        while not te.stats().peak_active or not te.liveness()["pending"]:
            time.sleep(0.01)
        time.sleep(0.1)                     # let a few iterations run
        assert te.abort(h)
        r = h.result(timeout=60.0)
        assert r.finish_reason == "aborted" and len(r.tokens) < 60
        assert not te.abort(h)              # already finished
        te.wait_idle()
        te.assert_kv_balanced(held)

        r = te.submit(PROMPTS[0], 4,
                      deadline_t=time.monotonic() - 1.0).result(60.0)
        assert (r.finish_reason, r.tokens) == ("expired", [])
        r = te.submit(PROMPTS[2], 60,
                      deadline_t=time.monotonic() + 0.15).result(60.0)
        assert r.finish_reason == "expired" and len(r.tokens) < 60
        te.wait_idle()
        te.assert_kv_balanced(te.stats().prefix_cached_entries)
        dump = te.registry.dump()
    assert "serving_requests_expired_total 2" in dump


def test_hot_swap_and_hot_load_serve_the_new_weights(models, tmp_path):
    """hot_swap before and after warmup serves the new params' tokens
    (after warmup by copying into the engine's own tensors: the caller's
    stay as they were), flushing the prefix cache; hot_load reads a
    checkpoint written by the JAX package's save_pytree."""
    (_, tp), (jd, td) = models["target"], models["draft"]
    caller_leaf = tp["blocks"]["mlp_up"]["kernel"].clone()
    want_a = port_greedy(tp, PROMPTS[0], 6)
    want_b = port_greedy(td, PROMPTS[0], 6)
    assert want_a != want_b
    save_pytree(str(tmp_path / "ck-b"), jax.device_get(jd))
    store = SharedFSStorageManager(str(tmp_path))
    with port_engine(tp, prefix_cache=True) as te:
        assert te.generate(PROMPTS[0], 6).tokens == want_a
        te.hot_swap(td)
        assert te.generate(PROMPTS[0], 6).tokens == want_b
        te.hot_swap(tp)
        te.warmup()
        assert te.generate(PROMPTS[0], 6).tokens == want_a
        assert te.hot_load(store, "ck-b") >= 0.0
        assert te.generate(PROMPTS[0], 6).tokens == want_b
        assert te.stats().prefix_cached_entries == 1  # flushed on swap
        with pytest.raises(ValueError):
            te.hot_swap(tgpt.extend_with_identity_layers(tp, TCFG, 1)[0])
    assert torch.equal(tp["blocks"]["mlp_up"]["kernel"], caller_leaf)


def test_fail_inflight_raises_replica_failed(models):
    """Condemnation fails running and queued handles with ReplicaFailed
    at once (running ones active); the scheduler then tears down,
    releasing every block, and later submits are refused the same way.
    The fault points engine.step and engine.step.<scope> fire."""
    _, tp = models["target"]
    with port_engine(tp, max_queue_depth=8, iteration_floor_s=0.05,
                     fault_scope="r0") as te:
        live = te.liveness()
        assert live["thread_alive"] and not live["pending"]
        assert live["beat_age_s"] < 60
        running = te.submit(PROMPTS[0], 60)
        while not te.stats().peak_active:
            time.sleep(0.01)
        queued = [te.submit(p, 60) for p in PROMPTS * 2]
        assert te.fail_inflight("test") >= 1
        with pytest.raises(ReplicaFailed) as e:
            running.result(timeout=30)
        assert e.value.active
        for h in queued:
            with pytest.raises(ReplicaFailed):
                h.result(timeout=30)
        deadline = time.monotonic() + 30
        while te.liveness()["thread_alive"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not te.liveness()["thread_alive"]
        te.assert_kv_balanced(0)
        with pytest.raises(ReplicaFailed):
            te.submit(PROMPTS[0], 2)

    rule = {"rules": [{"point": "engine.step.r1", "action": "error",
                       "nth": 2}]}
    with faults.plan_active(rule):
        with port_engine(tp, fault_scope="r1") as te:
            h = te.submit(PROMPTS[0], 20)
            with pytest.raises(ReplicaFailed):
                h.result(timeout=30)
            assert te.liveness()["fatal"] is not None
            te.assert_kv_balanced(0)
