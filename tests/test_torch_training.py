"""The port's GPT training held against the JAX package's on the CPU: the
same weights (JAX ``init``, converted leaf for leaf) and the same numpy
tokens through ``loss_fn`` and its gradients, one optimizer step, loss
curves and a resumed Adam state. The JAX flash attention runs its Pallas
kernel in interpret mode, as the JAX package's own tests run it here.

Tolerances, with fp32 compute: the loss within 1e-5 and each gradient
leaf within 1e-5 of its largest element (the frameworks sum in other
orders; measured ~1e-6 and ~7e-7). With bf16 compute: the loss within
1e-3 and each gradient leaf within 5e-2 of its largest element (bf16
activations through two blocks and back, rounded at different places by
the two frameworks: a few bf16 ulps, measured up to 2.3e-2).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from determined_clone_tpu.models import gpt as jgpt
from determined_clone_tpu.telemetry import flops as jflops
from determined_clone_tpu.training import metrics as jmetrics
from determined_clone_tpu.training import train_step as jts
from determined_clone_tpu_torch import convert
from determined_clone_tpu_torch.models import gpt as tgpt
from determined_clone_tpu_torch.ops import flash_attention as fa
from determined_clone_tpu_torch.ops import layers as tlayers
from determined_clone_tpu_torch.telemetry import flops as tflops
from determined_clone_tpu_torch.training import optim
from determined_clone_tpu_torch.training import train_step as tts
from determined_clone_tpu_torch.training.metrics import (
    MetricAccumulator,
    mean_over_batches,
)

torch.set_num_threads(1)
if torch.get_num_interop_threads() != 1:
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:  # already fixed once inter-op work has run here
        pass

TINY = dict(vocab_size=256, n_layers=2, d_model=64, n_heads=4, d_ff=128,
            max_seq_len=128, remat=False, attention_block_size=16)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-3, 5e-2)}


def _cfgs(dtype="float32", **kw):
    jd, td = DTYPES[dtype][:2]
    return (jgpt.GPTConfig(**TINY, compute_dtype=jd, **kw),
            tgpt.GPTConfig(**TINY, compute_dtype=td, **kw))


@pytest.fixture(scope="module")
def jax_params():
    return jax.jit(jgpt.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                jgpt.GPTConfig(**TINY))


def _port(jax_params):
    """A fresh port copy of the JAX weights (a train state takes its
    params over and updates them in place)."""
    return convert.params_from_numpy(jax.device_get(jax_params), "cpu")


def _batch(T=32, B=2, seed=0):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"],
                                                (B, T + 1))


def _grads(params, cfg, batch, **kw):
    leaves = optim.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    b = torch.from_numpy(batch)
    loss = tgpt.loss_fn(params, cfg, b[:, :-1], b[:, 1:], **kw)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _assert_grads_close(jgrads, tgrads, rel):
    for j, t in zip(jax.tree.leaves(jgrads), tgrads):
        j = np.asarray(j, np.float32)
        scale = max(float(np.abs(j).max()), 1e-12)
        np.testing.assert_allclose(t.float().numpy(), j, rtol=0,
                                   atol=rel * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl,T", [("mha", 32), ("blockwise", 32),
                                    ("flash", 32), ("flash", 37)])
def test_loss_and_grads_match_jax(jax_params, impl, T, dtype):
    """T=37 pads to the flash block on both sides (the plain version on
    the CPU keeps the JAX block contract)."""
    jcfg, tcfg = _cfgs(dtype, attention_impl=impl)
    _, _, loss_tol, grad_rel = DTYPES[dtype]
    batch = _batch(T)
    jb = jnp.asarray(batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jgpt.loss_fn(p, jcfg, b[:, :-1], b[:, 1:])))(
            jax_params, jb)
    tloss, tgrads = _grads(_port(jax_params), tcfg, batch)
    assert abs(float(jloss) - float(tloss)) <= loss_tol
    _assert_grads_close(jgrads, tgrads, grad_rel)


def test_masked_loss_matches_jax(jax_params):
    jcfg, tcfg = _cfgs()
    batch = _batch()
    mask = np.random.default_rng(1).random((2, 32)) < 0.7
    jloss = jgpt.loss_fn(jax_params, jcfg, jnp.asarray(batch[:, :-1]),
                         jnp.asarray(batch[:, 1:]), jnp.asarray(mask))
    b = torch.from_numpy(batch)
    tloss = tgpt.loss_fn(_port(jax_params), tcfg, b[:, :-1], b[:, 1:],
                         torch.from_numpy(mask))
    assert abs(float(jloss) - float(tloss)) <= 1e-5


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_remat_grads_equal_no_remat(jax_params, rate):
    """The remat trap: with dropout on, the recompute must draw the same
    masks, or the gradients are wrong with no error raised."""
    _, tcfg = _cfgs(attention_impl="flash", dropout=rate)
    batch = _batch(T=37)
    out = [_grads(_port(jax_params), dataclasses.replace(tcfg, remat=remat),
                  batch, training=True, dropout_seed=7)
           for remat in (False, True)]
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_dropout_changes_the_loss_only_when_training(jax_params):
    _, tcfg = _cfgs(dropout=0.1)
    b = torch.from_numpy(_batch())
    params = _port(jax_params)

    def loss(**kw):
        with torch.no_grad():
            return float(tgpt.loss_fn(params, tcfg, b[:, :-1], b[:, 1:],
                                      **kw))

    base = loss()
    assert loss(training=False, dropout_seed=3) == base
    assert loss(training=True) == base  # no seed: no dropout
    assert loss(training=True, dropout_seed=3) != base
    assert (loss(training=True, dropout_seed=3)
            == loss(training=True, dropout_seed=3))


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_saves_the_dense_products(jax_params):
    """The remat policy mirrors ``dots_with_no_batch_dims_saveable``: the
    backward recomputes the blocks (more ops run) but no dense ``mm``."""
    _, tcfg = _cfgs(attention_impl="mha")
    b = torch.from_numpy(_batch())
    counts = []
    for remat in (False, True):
        params = _port(jax_params)
        leaves = optim.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = tgpt.loss_fn(params, dataclasses.replace(tcfg, remat=remat),
                            b[:, :-1], b[:, 1:])
        with _CountOps() as mode:
            torch.autograd.grad(loss, leaves)
        counts.append(mode.counts)
    plain, remat = counts
    mm = torch.ops.aten.mm.default
    assert remat[mm] == plain[mm]
    assert sum(remat.values()) > sum(plain.values())


def _meta_params(cfg):
    params = tgpt.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return optim.tree_map(lambda t: t.to("meta").requires_grad_(), params)


@pytest.mark.parametrize("remat,per_step", [(False, 1), (True, 2)])
def test_kernel_launches_per_training_step(monkeypatch, remat, per_step):
    """On device tensors a training step launches the forward kernel once
    per layer, and once more in each block's recompute under remat; the
    backward itself launches nothing. T=37 reaches the kernel unpadded
    and the backward pads K/V (meta tensors: shapes only)."""
    calls = []

    def launch(q, k, v, causal):
        calls.append(tuple(q.shape))
        return torch.empty_like(q)

    monkeypatch.setattr(fa, "_launch", launch)
    cfg = dataclasses.replace(tgpt.GPTConfig.tiny(), attention_impl="flash",
                              attention_block_size=16, remat=remat)
    params = _meta_params(cfg)
    tokens = torch.zeros((2, 37), dtype=torch.long, device="meta")
    loss = tgpt.loss_fn(params, cfg, tokens, tokens)
    grads = torch.autograd.grad(loss, optim.leaves(params))
    assert [g.shape for g in grads] == [p.shape
                                        for p in optim.leaves(params)]
    H, hd = cfg.n_heads, cfg.head_dim
    assert calls == [(2, 37, H, hd)] * (per_step * cfg.n_layers)


# --- the train step -------------------------------------------------------

LR = 3e-4


def _jax_state_and_step(jcfg, jax_params, tx):
    state = jts.create_train_state(jax_params, tx, jax.random.PRNGKey(1))

    def loss(p, b, rng):
        return jgpt.loss_fn(p, jcfg, b[:, :-1], b[:, 1:]), {}

    return state, jts.make_train_step(loss, tx, donate=False)


def _port_state_and_step(tcfg, params, tx, **kw):
    state = tts.create_train_state(params, tx, seed=1)

    def loss(p, b, seed):
        return tgpt.loss_fn(p, tcfg, b[:, :-1], b[:, 1:]), {}

    return state, tts.make_train_step(loss, tx, **kw)


def _adamw_pair():
    # bench.py's optimizer
    return (optax.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1),
            optim.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1))


def test_adamw_step_matches_optax(jax_params):
    """One step from the same weights. Adam's first update is about
    ``lr * sign(g)``, so a gradient element near zero can move its
    parameter anywhere within ``2 * lr`` between the frameworks: the
    gradient norm is compared tightly, the parameters within ``lr / 100``
    where the gradient is above 1e-6 of its leaf's largest element and
    within ``2 * lr`` elsewhere."""
    jcfg, tcfg = _cfgs()
    jtx, ttx = _adamw_pair()
    batch = _batch()
    jstate, jstep = _jax_state_and_step(jcfg, jax_params, jtx)
    jgrads = jax.jit(jax.grad(
        lambda p: jgpt.loss_fn(p, jcfg, batch[:, :-1], batch[:, 1:])))(
            jax_params)
    jstate, jm = jstep(jstate, jnp.asarray(batch))
    tstate, tstep = _port_state_and_step(tcfg, _port(jax_params), ttx)
    tstate, tm = tstep(tstate, torch.from_numpy(batch))
    # optax's adamw state layout: (ScaleByAdamState, EmptyState, EmptyState)
    assert tstate.step == 1 and tstate.opt_state[0].count == 1
    assert tstate.opt_state[1:] == (optim.EmptyState(), optim.EmptyState())
    assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-5
    assert abs(float(jm["grad_norm"]) / float(tm["grad_norm"]) - 1) <= 1e-5
    for j, t, g in zip(jax.tree.leaves(jstate.params),
                       optim.leaves(tstate.params), jax.tree.leaves(jgrads)):
        j, t, g = np.asarray(j), t.detach().numpy(), np.abs(np.asarray(g))
        diff = np.abs(j - t)
        firm = g > 1e-6 * g.max()
        assert diff.max(initial=0.0) <= 2 * LR * (1 + 1e-3)
        assert diff[firm].max(initial=0.0) <= LR / 100


def _curve(step, state, batch, n=6):
    losses = []
    for _ in range(n):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses


def test_six_step_curves_match_jax():
    """The kernel regression gate of tests/test_flash_attention.py, held
    across frameworks: the port's flash and mha curves track the JAX
    curve step for step within 2%, and both train."""
    cfg = dict(vocab_size=128, n_layers=2, d_model=64, n_heads=4, d_ff=128,
               max_seq_len=64, remat=False, attention_block_size=32)
    jcfg = jgpt.GPTConfig(**cfg, attention_impl="mha")
    params = jax.jit(jgpt.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                  jcfg)
    batch = np.random.default_rng(2).integers(0, 128, (2, 65))
    jstate, jstep = _jax_state_and_step(jcfg, params, optax.adam(3e-3))
    jcurve = _curve(jax.jit(jstep), jstate, jnp.asarray(batch))
    for impl in ("flash", "mha"):
        tcfg = tgpt.GPTConfig(**cfg, attention_impl=impl)
        tstate, tstep = _port_state_and_step(tcfg, _port(params),
                                             optim.adam(3e-3))
        tcurve = _curve(tstep, tstate, torch.from_numpy(batch))
        for lt, lj in zip(tcurve, jcurve):
            assert abs(lt - lj) / abs(lj) < 0.02, (impl, tcurve, jcurve)
        assert tcurve[-1] < tcurve[0]


def test_fused_steps_equal_single_steps(jax_params):
    _, tcfg = _cfgs(dropout=0.1)
    batches = [torch.from_numpy(_batch(seed=s)) for s in (3, 4)]

    def loss(p, b, seed):
        return tgpt.loss_fn(p, tcfg, b[:, :-1], b[:, 1:], training=True,
                            dropout_seed=seed), {"tokens": torch.tensor(64.)}

    tx = optim.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1)
    single = tts.make_train_step(loss, tx)
    s1 = tts.create_train_state(_port(jax_params), tx, seed=5)
    per_step = []
    for b in batches:
        s1, m = single(s1, b)
        per_step.append(m)
    fused = tts.make_train_step(loss, tx, steps_per_dispatch=2)
    s2, summed = fused(tts.create_train_state(_port(jax_params), tx, seed=5),
                       *batches)
    assert (s1.step, s1.seed, s1.opt_state[0].count) == (
        s2.step, s2.seed, s2.opt_state[0].count) == (2, 5, 2)
    for tree in (lambda s: s.params, lambda s: s.opt_state[0].mu,
                 lambda s: s.opt_state[0].nu):
        for a, b in zip(optim.leaves(tree(s1)), optim.leaves(tree(s2))):
            assert torch.equal(a, b)
    assert set(summed) == {"loss", "grad_norm", "tokens"}
    for k, v in summed.items():
        assert torch.equal(v, per_step[0][k] + per_step[1][k])
    with pytest.raises(ValueError, match="expected 2 batches"):
        fused(s2, batches[0])
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        tts.make_train_step(loss, tx, steps_per_dispatch=0)


def test_step_metrics_report_params_before_the_update():
    """A metric that aliases a parameter reports its value before the
    step's in-place update, as the JAX step (which returns new arrays)
    reports it."""
    params = {"w": torch.tensor(1.0)}
    tx = optim.sgd(0.25)

    def loss(p, b, seed):
        return (p["w"] - 3.0) ** 2, {"w": p["w"]}

    state = tts.create_train_state(params, tx, seed=0)
    state, m = tts.make_train_step(loss, tx)(state, None)
    assert float(m["w"]) == 1.0 and float(state.params["w"].detach()) == 2.0
    assert float(m["loss"]) == 4.0 and float(m["grad_norm"]) == 4.0


def test_eval_step_and_metric_accumulator(jax_params):
    _, tcfg = _cfgs()
    seen = []

    def eval_fn(params, b, seed):
        seen.append(seed)
        logits = tgpt.apply(params, tcfg, b[:, :-1])
        return {"loss": tgpt.loss_fn(params, tcfg, b[:, :-1], b[:, 1:]),
                "accuracy": tlayers.accuracy(logits, b[:, 1:])}

    tx = optim.sgd(0.1)
    state = tts.create_train_state(_port(jax_params), tx, seed=0)
    step = tts.make_eval_step(eval_fn, seed=9)
    m = step(state, torch.from_numpy(_batch()))
    assert not m["loss"].requires_grad and seen == [tlayers.fold_seed(9, 0)]
    assert 0.0 <= float(m["accuracy"]) <= 1.0

    # exact: dyadic values, the same arithmetic as the JAX accumulator
    acc, jacc = MetricAccumulator(), jmetrics.MetricAccumulator()
    for vals, count in (((0.5, 1.25), 1), ((1.5, 2.0), 2), ((0.25, 4.0), 1)):
        acc.add({"a": torch.tensor(vals[0]), "b": torch.tensor(vals[1])},
                count=count)
        jacc.add({"a": jnp.float32(vals[0]), "b": jnp.float32(vals[1])},
                 count=count)
    assert len(acc) == 2
    assert acc.result() == jacc.result() == {"a": 0.5625, "b": 1.8125}
    assert len(acc) == 0 and acc.result() == {}
    assert mean_over_batches([{"x": torch.tensor(1.0)},
                              {"x": torch.tensor(2.0)}]) == {"x": 1.5}


def test_sgd_and_param_count(jax_params):
    params = _port(jax_params)
    before = [p.clone() for p in optim.leaves(params)]
    grads = optim.tree_map(torch.ones_like, params)
    tx = optim.sgd(0.5)
    empty = (optim.EmptyState(), optim.EmptyState())  # optax.sgd's state
    assert tx.init(params) == empty
    assert tx.update(grads, tx.init(params), params) == empty
    for b, p in zip(before, optim.leaves(params)):
        assert torch.equal(p, b - 0.5)
    assert tts.param_count(params) == jts.param_count(jax_params)


def test_adam_state_from_numpy_resumes_a_jax_run(jax_params):
    """One JAX step; params and optax's Adam state converted; the second
    step taken on both sides agrees as closely as one step does."""
    jcfg, tcfg = _cfgs()
    jtx, ttx = _adamw_pair()
    batches = [_batch(seed=s) for s in (5, 6)]
    jstate, jstep = _jax_state_and_step(jcfg, jax_params, jtx)
    jstate, _ = jstep(jstate, jnp.asarray(batches[0]))
    host = jax.device_get(jstate)
    adam_state = convert.adam_state_from_numpy(host.opt_state[0], "cpu")
    assert adam_state.count == 1
    tstate, tstep = _port_state_and_step(
        tcfg, convert.params_from_numpy(host.params, "cpu"), ttx)
    tstate = dataclasses.replace(
        tstate, opt_state=(adam_state,) + tstate.opt_state[1:])
    jstate, jm = jstep(jstate, jnp.asarray(batches[1]))
    tstate, tm = tstep(tstate, torch.from_numpy(batches[1]))
    assert tstate.opt_state[0].count == 2
    assert abs(float(jm["loss"]) - float(tm["loss"])) <= 1e-5
    # Adam's second update is no longer a sign: the moments carry the
    # first step's gradient, so the parameters agree far inside lr
    for j, t in zip(jax.tree.leaves(jstate.params),
                    optim.leaves(tstate.params)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=0, atol=LR / 100)
    for name in ("mu", "nu"):
        for j, t in zip(jax.tree.leaves(getattr(jstate.opt_state[0], name)),
                        optim.leaves(getattr(tstate.opt_state[0], name))):
            j = np.asarray(j)
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=1e-5 * np.abs(j).max() + 1e-30)


def test_train_step_flops_match_jax():
    for cfg_kw in ({}, {"n_layers": 2, "vocab_size": 256}):
        jcfg, tcfg = jgpt.GPTConfig(**cfg_kw), tgpt.GPTConfig(**cfg_kw)
        j = jflops.gpt_train_step_flops(jcfg, 8, 1024)
        t = tflops.gpt_train_step_flops(tcfg, 8, 1024)
        assert (t.total, t.per_token, t.tokens, t.breakdown) == (
            j.total, j.per_token, j.tokens, j.breakdown)
    full = tflops.gpt_train_step_flops(tgpt.GPTConfig(), 8, 1024)
    assert math.isclose(full.total, 7.0e12, rel_tol=0.05)
    assert tflops.mfu(full.total / 0.1) == full.total / 0.1 / 989e12


def test_entry_points_need_cuda_or_cpu_by_name(jax_params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    host = jax.device_get(optax.adam(1e-3).init(jax_params))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.adam_state_from_numpy(host[0])
    assert convert.adam_state_from_numpy(host[0], "cpu").count == 0
