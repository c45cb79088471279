"""The port's MoE (``ops/moe.py``) and the MoE GPT against the JAX
package, on the CPU, with the same weights (JAX ``init``, converted leaf
for leaf).

Tolerances: fp32 compute within 1e-5 (outputs, aux losses, and each
gradient leaf relative to its largest element: summation order only);
the dropped choices are equal as sets. The index form is held against
the one-hot einsum form (``moe_ffn_dense``) at 1e-5 in fp32 and within
0.05 in bf16 (the tolerance of the bf16 kernel and forward checks of
``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_clone_tpu.models import gpt as jgpt
from determined_clone_tpu.ops import moe as jmoe
from determined_clone_tpu.serving import bucketing as jbucket
from determined_clone_tpu.serving import engine as jengine
from determined_clone_tpu.serving import kv_cache as jkv
from determined_clone_tpu.telemetry import flops as jflops
from determined_clone_tpu_torch import convert
from determined_clone_tpu_torch.models import gpt as tgpt
from determined_clone_tpu_torch.ops import moe as tmoe
from determined_clone_tpu_torch.serving import (
    BucketSpec,
    InferenceEngine,
    KVCacheConfig,
)
from determined_clone_tpu_torch.telemetry import flops as tflops

torch.set_num_threads(1)

CASES = [(1, 1.25), (2, 1.25), (1, 0.5), (2, 0.5)]
CASE_IDS = ["k1_cf1.25", "k2_cf1.25", "k1_cf0.5_drops", "k2_cf0.5_drops"]
E, D, F = 4, 16, 32


def _params(seed=0):
    p = jmoe.moe_init(jax.random.PRNGKey(seed), E, D, F)
    return p, convert.params_from_numpy(jax.device_get(p), "cpu")


def _x(B=2, T=24, seed=1):
    return np.random.RandomState(seed).randn(B, T, D).astype(np.float32)


def _rel_close(t, j, rel=1e-5):
    scale = max(float(np.abs(j).max()), 1e-12)
    np.testing.assert_allclose(t, j, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("k,cf", CASES, ids=CASE_IDS)
def test_moe_ffn_matches_jax(k, cf):
    """Outputs, the aux loss, the dropped choices, and the gradients of
    ``sum(y * w) + aux`` with respect to x and every parameter."""
    jp, tp = _params()
    x = _x()
    w = np.random.RandomState(2).randn(*x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, x, k=k, capacity_factor=cf,
                              compute_dtype=jnp.float32)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    leaves = [t.requires_grad_() for t in
              jax.tree.leaves(tp, is_leaf=lambda n: isinstance(n, torch.Tensor))]
    stats = {}
    ty, taux = tmoe.moe_ffn(tp, tx, k=k, capacity_factor=cf,
                            compute_dtype=torch.float32, stats=stats)
    grads = torch.autograd.grad((ty * torch.from_numpy(w)).sum() + taux,
                                [tx] + leaves)
    _rel_close(ty.detach().numpy(), np.asarray(jy))
    assert abs(taux.item() - float(jaux)) <= 1e-5 * abs(float(jaux))
    _rel_close(grads[0].numpy(), np.asarray(jgx))
    for g, j in zip(grads[1:], jax.tree.leaves(jg)):
        _rel_close(g.numpy(), np.asarray(j))
    # the JAX dispatch tensor's kept choices are the port's
    N = x.shape[0] * x.shape[1]
    C = jmoe.expert_capacity(N, E, cf)
    assert stats["capacity"] == C
    dense = {}
    tmoe.moe_ffn_dense(tp, torch.from_numpy(x), k=k, capacity_factor=cf,
                       compute_dtype=torch.float32, stats=dense)
    assert torch.equal(stats["keep"], dense["keep"])
    if cf < 1:
        assert not bool(stats["keep"].all())  # the case really drops


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.05)])
@pytest.mark.parametrize("k,cf", CASES, ids=CASE_IDS)
def test_index_form_matches_the_einsum_form(k, cf, dtype, tol):
    _, tp = _params(3)
    x = torch.from_numpy(_x(B=3, T=40, seed=4))
    dt = getattr(torch, dtype)
    si, sd = {}, {}
    yi, ai = tmoe.moe_ffn(tp, x, k=k, capacity_factor=cf, compute_dtype=dt,
                          stats=si)
    yd, ad = tmoe.moe_ffn_dense(tp, x, k=k, capacity_factor=cf,
                                compute_dtype=dt, stats=sd)
    assert torch.equal(si["keep"], sd["keep"])
    assert float((yi.float() - yd.float()).abs().max()) <= tol
    assert abs(float(ai) - float(ad)) <= 1e-6


def test_route_breaks_ties_as_lax_top_k():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.3, 0.2, 0.2], [0.0, 0.5, 0.5, 0.0]],
                     np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = tmoe.route(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n,e,cf", [(8192, 8, 1.25), (48, 4, 0.5),
                                    (3, 8, 1.0), (1, 4, 2.0)])
def test_expert_capacity_matches_jax(n, e, cf):
    assert tmoe.expert_capacity(n, e, cf) == jmoe.expert_capacity(n, e, cf)


# -- the MoE GPT ---------------------------------------------------------------

MOE_GPT = dict(vocab_size=256, n_layers=2, d_model=64, n_heads=4, d_ff=128,
               max_seq_len=128, attention_impl="mha", moe_experts=4,
               moe_capacity_factor=0.5)


@pytest.fixture(scope="module")
def moe_models():
    jcfg = jgpt.GPTConfig(**MOE_GPT, remat=False, compute_dtype=jnp.float32)
    jp = jax.jit(jgpt.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    # scaled so greedy decoding depends on the context (see
    # tests/test_torch_serving_features.py)
    jp = jax.tree.map(lambda a: a * 10.0, jp)
    return jp, convert.params_from_numpy(jax.device_get(jp), "cpu")


@pytest.mark.parametrize("remat", [False, True])
def test_moe_gpt_loss_and_grads_match_jax(remat):
    """``loss_fn`` with the aux term, and every gradient leaf, from
    ``init``'s weights."""
    jcfg = jgpt.GPTConfig(**MOE_GPT, remat=remat, compute_dtype=jnp.float32)
    jp = jax.jit(jgpt.init, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu")
    tcfg = tgpt.GPTConfig(**MOE_GPT, remat=remat,
                          compute_dtype=torch.float32)
    batch = np.random.default_rng(0).integers(0, 256, (4, 33))
    jl, jg = jax.value_and_grad(
        lambda p: jgpt.loss_fn(p, jcfg, batch[:, :-1], batch[:, 1:]))(jp)
    leaves = convert.params_from_numpy(jax.device_get(jp), "cpu")
    flat = [t.requires_grad_() for t in jax.tree.leaves(
        leaves, is_leaf=lambda n: isinstance(n, torch.Tensor))]
    tb = torch.from_numpy(batch)
    tl = tgpt.loss_fn(leaves, tcfg, tb[:, :-1], tb[:, 1:])
    grads = torch.autograd.grad(tl, flat)
    assert abs(tl.item() / float(jl) - 1) <= 1e-5
    for g, j in zip(grads, jax.tree.leaves(jg)):
        _rel_close(g.numpy(), np.asarray(j))
    # the aux term is in the loss: the same loss without it is lower
    plain = tgpt.loss_fn(tp, dataclasses.replace(tcfg, moe_aux_weight=0.0),
                         tb[:, :-1], tb[:, 1:])
    assert float(plain) < float(tl)


def test_moe_gpt_forward_paged_matches_jax(moe_models):
    """A bucket-padded prefill (the capacity counts the padding rows, as
    JAX's does) and one decode step: logits and pools agree."""
    jp, tp = moe_models
    jcfg = jgpt.GPTConfig(**MOE_GPT, remat=False, compute_dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**MOE_GPT, remat=False,
                          compute_dtype=torch.float32)
    from determined_clone_tpu_torch.serving import kv_cache as tkv
    cache = dict(num_blocks=12, block_size=8)
    jk, jv = jkv.init_kv_pools(jcfg, jkv.KVCacheConfig(**cache))
    tk, tv = tkv.init_kv_pools(tcfg, tkv.KVCacheConfig(**cache), "cpu")
    tables = np.array([[3, 7, 0, 0], [5, 1, 9, 0], [0, 0, 0, 0]], np.int32)
    B, T = 3, 16
    tok = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    msk = np.zeros((B, T), bool)
    last = np.zeros((B,), np.int32)
    rng = np.random.default_rng(2)
    for i, n in enumerate([11, 16]):
        tok[i, :n] = rng.integers(0, 256, n)
        pos[i, :n] = np.arange(n)
        msk[i, :n] = True
        last[i] = n - 1
    jfwd = jax.jit(jgpt.forward_paged, static_argnums=1)
    for step in range(2):
        jl, jk, jv = jfwd(jp, jcfg, *(jnp.asarray(a) for a in
                                      (tok, pos, msk, last)),
                          jk, jv, jnp.asarray(tables))
        with torch.no_grad():
            tl, _, _ = tgpt.forward_paged(tp, tcfg, *(
                torch.from_numpy(a) for a in (tok, pos, msk, last)),
                tk, tv, torch.from_numpy(tables))
        _rel_close(tl.numpy(), np.asarray(jl))
        _rel_close(tk.numpy(), np.asarray(jk))
        nxt = tl.argmax(-1).numpy().astype(np.int32)
        pos = np.array([[11], [16], [0]], np.int32) + step
        tok, msk = nxt[:, None], np.array([[True], [True], [False]])
        last = np.zeros((B,), np.int32)


def test_moe_engine_tokens_match_jax(moe_models):
    """Greedy tokens of the continuous-batching engine, requests one at a
    time and in a burst, equal the JAX engine's."""
    jp, tp = moe_models
    jcfg = jgpt.GPTConfig(**MOE_GPT, remat=False, compute_dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**MOE_GPT, remat=False,
                          compute_dtype=torch.float32)
    prompts = [([5, 17, 3, 88, 41], 6), ([9] * 11, 6), ([1, 2, 3], 6)]
    kw = dict(cache=dict(num_blocks=40, block_size=8), ladder=(4, 16))
    with jengine.InferenceEngine(
            jp, jcfg, buckets=jbucket.BucketSpec.build(*kw["ladder"]),
            cache=jkv.KVCacheConfig(**kw["cache"])) as je:
        jone = [je.generate(p, n, timeout=120.0).tokens for p, n in prompts]
        jburst = [h.result(timeout=120.0).tokens for h in
                  [je.submit(p, n) for p, n in prompts]]
    with InferenceEngine(tp, tcfg, buckets=BucketSpec.build(*kw["ladder"]),
                         cache=KVCacheConfig(**kw["cache"]),
                         device="cpu") as te:
        tone = [te.generate(p, n, timeout=120.0).tokens for p, n in prompts]
        tburst = [h.result(timeout=120.0).tokens for h in
                  [te.submit(p, n) for p, n in prompts]]
        te.wait_idle()
        te.assert_kv_balanced(0)
    assert tone == jone and tburst == jburst
    assert len({tuple(t) for t in tone}) == len(prompts)


def test_identity_extension_refuses_moe_in_both(moe_models):
    jp, tp = moe_models
    for mod, p in ((jgpt, jp), (tgpt, tp)):
        with pytest.raises(ValueError, match="dense blocks only"):
            mod.extend_with_identity_layers(p, mod.GPTConfig(**MOE_GPT), 2)


def test_moe_flops_match_jax_and_count_the_index_form():
    cfg = tgpt.GPTConfig(moe_experts=8)
    jcfg = jgpt.GPTConfig(moe_experts=8)
    assert (tflops.gpt_train_step_flops(cfg, 8, 1024).total
            == jflops.gpt_train_step_flops(jcfg, 8, 1024).total)
    for kw in ({}, {"capacity_factor": 0.5}):
        assert (tflops.moe_layer_flops(8192, 768, 3072, 8, **kw)
                == jflops.moe_layer_flops(8192, 768, 3072, 8, **kw))
    idx = tflops.moe_layer_flops(8192, 768, 3072, 8, dispatch="index")
    C = 1280
    assert idx["capacity"] == C
    assert idx["total"] == 2.0 * 8192 * 768 * 8 + 2 * 2.0 * 8 * C * 768 * 3072
    with pytest.raises(ValueError):
        tflops.moe_layer_flops(8, 4, 4, 2, dispatch="dense")
