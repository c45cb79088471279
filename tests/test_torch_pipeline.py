"""The second half of the port's parallelism slice against the JAX
package, on the CPU: the GPipe pipeline over ``pp``
(``parallel/pipeline.py``), the pipelined GPT (blocks split over ``pp``
or not) and its MoE train step, a ``pp``-sharded checkpoint moved both
ways, ring and Ulysses attention over ``sp`` (``ops/attention.py``), and
the GPT and the MoE GPT over ``sp``.

The JAX side runs in this process on the virtual 8-device CPU mesh
(``tests/conftest.py``). The port's side is one launch of four gloo
ranks (``exec/launch.py``) that runs this file as a script
(``worker_all``), reads its inputs from ``tmp_path`` and writes each
rank's results there; the ranks import no JAX and run while this
process computes the JAX references.

Tolerances: forwards, ``pipeline_apply`` and the sequence-parallel
attention in fp32 within 2e-4 (``tests/test_pipeline_moe.py`` and
``tests/test_sequence_parallel.py``); losses and gradient norms of
AdamW steps within 1e-5 relative and parameters within 1e-4 after them,
gradients leaf by leaf within 1e-5 of the largest element of JAX's leaf
(``tests/test_torch_parallel.py`` gives the reasons).
"""
import json
import os
import pickle
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from determined_clone_tpu_torch import convert  # noqa: E402
from determined_clone_tpu_torch.core._serialization import (  # noqa: E402
    load_pytree,
    save_pytree,
    tree_paths_and_leaves as port_paths,
)
from determined_clone_tpu_torch.exec import launch  # noqa: E402
from determined_clone_tpu_torch.models import gpt as tgpt  # noqa: E402
from determined_clone_tpu_torch.ops import attention as tatt  # noqa: E402
from determined_clone_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from determined_clone_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from determined_clone_tpu_torch.parallel import sharding as tsh  # noqa: E402
from determined_clone_tpu_torch.parallel.spmd import (  # noqa: E402
    local_tensor,
    split_over,
    spmd_of,
)
from determined_clone_tpu_torch.training import optim  # noqa: E402
from determined_clone_tpu_torch.training import train_step as tts  # noqa: E402

if __name__ != "__main__":  # the ranks never import JAX
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding as JNamedSharding

    from determined_clone_tpu.core import _serialization as jser
    from determined_clone_tpu.models import gpt as jgpt
    from determined_clone_tpu.ops import attention as jatt
    from determined_clone_tpu.parallel import mesh as jmesh
    from determined_clone_tpu.parallel import pipeline as jpipe
    from determined_clone_tpu.parallel import sharding as jsh
    from determined_clone_tpu.training import train_step as jts

    from tests.test_torch_parallel import join_ranks, start_ranks

FWD_TOL = 2e-4
REL = 1e-5
AFFINE = {"L": 8, "B": 8, "D": 16, "M": 4}
# the JAX package's pipelined GPT and its MoE train step
# (tests/test_pipeline_moe.py:218, :234)
PGPT = dict(vocab_size=64, n_layers=4, d_model=32, n_heads=2, d_ff=64,
            max_seq_len=16, remat=False, pipeline_microbatches=2)
PMOE = dict(PGPT, remat=True, moe_experts=2)
PMESH = {"pp": 2, "ep": 2}
MOE_LR = 1e-4   # Adam's sign noise near 1e-5 (tests/test_torch_parallel.py)
# the JAX package's sequence-parallel case (tests/test_sequence_parallel.py)
SP, QKV = 4, (2, 256, 8, 32)
TINY = dict(vocab_size=256, n_layers=2, d_model=64, n_heads=4, d_ff=128,
            max_seq_len=64, remat=False)
SPMESH = {"sp": 2, "fsdp": 2}
# the MoE GPT over sp: JAX's mesh and the port's four ranks. k = 2 choices
# of N tokens into E·C = 1.25·N slots, so every layer drops choices
MOE_SP = {"sp2": ({"sp": 2}, {"dp": 2, "sp": 2}),
          "sp2ep2": ({"sp": 2, "ep": 2}, {"dp": 1, "sp": 2, "ep": 2})}
LR, CLIP = 1e-4, 0.5


# -- the JAX side -------------------------------------------------------------

def _jmesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return jmesh.make_mesh(jmesh.MeshSpec.from_dict({"dp": 1, **sizes}),
                           jax.devices()[:n])


def _affine_stage(local, x):
    def body(h, lp):
        return jnp.tanh(h @ lp["w"] + lp["b"]), None
    return jax.lax.scan(body, x, local)[0]


def _jax_affine(stacked, x):
    out = {}
    for pp in (2, 4):
        mesh = _jmesh({"pp": pp})

        def loss(p, x):
            y = jpipe.pipeline_apply(_affine_stage, p, x, mesh=mesh,
                                     num_microbatches=AFFINE["M"])
            return jnp.sum(y ** 2), y

        (_, y), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                               has_aux=True))(stacked, x)
        out[pp] = {"y": np.asarray(y), "w": np.asarray(g[0]["w"]),
                   "b": np.asarray(g[0]["b"]), "x": np.asarray(g[1])}
    mesh = _jmesh({"pp": 2})
    errors = {}
    for name, args in (("zero_d", ({"x": jnp.ones((4, 16)),
                                    "s": jnp.zeros(())},)),
                       ("batch", (jnp.ones((5, 16)),))):
        try:
            jpipe.pipeline_apply(lambda p, c: c, stacked, *args, mesh=mesh,
                                 num_microbatches=2)
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    return out


def _jax_gpt_steps(cfg, sizes, params, batches, tx, rules, mesh_loss):
    """Losses and gradient norms of the JAX train step over ``batches`` on
    ``sizes``, the params after them, and the first batch's gradients."""
    jcfg = jgpt.GPTConfig(**cfg, compute_dtype=jnp.float32)
    jm = _jmesh(sizes)
    state = jts.create_train_state(params, tx, jax.random.PRNGKey(1))
    sh = jts.state_shardings(state, jm, rules)
    state = jax.device_put(state, sh)
    bsh = JNamedSharding(jm, jsh.batch_spec(1))
    kw = {"mesh": jm} if mesh_loss else {}

    def loss(p, b):
        return jgpt.loss_fn(p, jcfg, b[:, :-1], b[:, 1:], **kw)

    grads = jax.jit(jax.grad(loss))(state.params,
                                    jax.device_put(batches[0], bsh))
    step = jts.make_train_step(lambda p, b, rng: (loss(p, b), {}), tx,
                               mesh=jm, state_sharding=sh,
                               batch_sharding=bsh)
    metrics = []
    for b in batches:
        state, m = step(state, jnp.asarray(b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return (metrics,
            {p: np.asarray(v) for p, v in
             jsh.tree_paths_and_leaves(state.params)},
            {p: np.asarray(v) for p, v in jsh.tree_paths_and_leaves(grads)},
            state.params)


def _clip_adamw(mod):
    return mod.chain(mod.clip_by_global_norm(CLIP),
                     mod.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs; the launch of four ranks, started first; the JAX
    references meanwhile (the JAX checkpoint the ranks load, when it is
    written, behind a marker file); then the ranks' results."""
    d = tmp_path_factory.mktemp("pipeline")
    rng = np.random.RandomState(0)
    L, B, D = AFFINE["L"], AFFINE["B"], AFFINE["D"]
    stacked = {"w": (rng.randn(L, D, D) * 0.3).astype(np.float32),
               "b": (rng.randn(L, D) * 0.1).astype(np.float32)}
    x = rng.randn(B, D).astype(np.float32)
    pcfg = jgpt.GPTConfig(**PGPT, compute_dtype=jnp.float32)

    def init(**cfg):
        return jax.device_get(jgpt.init(jax.random.PRNGKey(0),
                                        jgpt.GPTConfig(**cfg)))

    pparams, mparams, tparams = init(**PGPT), init(**PMOE), init(**TINY)
    moe_params = init(**TINY, moe_experts=4)
    ptokens = rng.randint(0, 64, size=(4, 16)).astype(np.int32)
    mbatches = [rng.randint(0, 64, size=(8, 17)).astype(np.int32)
                for _ in range(2)]
    q, k, v = (rng.randn(*QKV).astype(np.float32) for _ in range(3))
    tbatches = [rng.randint(0, 256, size=(8, 17)).astype(np.int32)
                for _ in range(3)]
    with open(d / "in.pkl", "wb") as f:
        pickle.dump({"stacked": stacked, "x": x, "pparams": pparams,
                     "ptokens": ptokens, "mparams": mparams,
                     "mbatches": mbatches, "qkv": (q, k, v),
                     "tparams": tparams, "tbatches": tbatches,
                     "moe_params": moe_params}, f)
    ranks = start_ranks(4, "all", d, script=__file__)

    ref = {"affine": _jax_affine(stacked, x)}
    # the MoE GPT's train step on {pp: 2, ep: 2}, and a JAX checkpoint of
    # its params placed by GPT_PP_SHARDING_RULES
    metrics, final, grads, jparams = _jax_gpt_steps(
        PMOE, PMESH, mparams, mbatches, optax.adamw(MOE_LR),
        jgpt.GPT_PP_SHARDING_RULES, mesh_loss=True)
    ref["moe"] = {"metrics": metrics, "params": final, "grads": grads}
    jser.save_pytree(str(d / "jax_ckpt"), jparams)
    (d / "jax_ckpt.done").touch()

    # the pipelined GPT's forward at pp 2 and 4, and the scan GPT's
    ref["gpt_scan"] = np.asarray(jgpt.apply(pparams, pcfg, ptokens))
    ref["gpt_pp"] = {pp: np.asarray(jax.jit(
        lambda p, t, m=_jmesh({"pp": pp}): jgpt.apply(p, pcfg, t, mesh=m))(
            pparams, ptokens)) for pp in (2, 4)}

    # ring and Ulysses against mha
    def mha_loss(q, k, v):
        out = jatt.mha(q, k, v, causal=True)
        return jnp.sum(out ** 2), out

    (_, out), g = jax.jit(jax.value_and_grad(mha_loss, argnums=(0, 1, 2),
                                             has_aux=True))(q, k, v)
    ref["attention"] = {"out": np.asarray(out),
                        "grads": [np.asarray(t) for t in g]}
    sm = jax.sharding.Mesh(np.array(jax.devices()[:SP]), ("sp",))
    spec = jax.sharding.PartitionSpec(None, "sp")
    six = np.zeros((2, 8, 6, 4), np.float32)
    try:
        jax.jit(jax.shard_map(
            lambda q: jatt.ulysses_attention(q, q, q, axis_name="sp"),
            mesh=sm, in_specs=(spec,), out_specs=spec))(six)
    except ValueError as e:
        ref["ulysses_error"] = str(e)

    # the GPT over sp: three clipped AdamW steps on {sp: 2, fsdp: 2} (the
    # batch placed whole over sp), and on {sp: 4} the loss and gradients
    # of tokens split over sp by TOKENS_SPEC
    metrics, final, _, _ = _jax_gpt_steps(
        TINY, SPMESH, tparams, tbatches, _clip_adamw(optax),
        jgpt.GPT_SHARDING_RULES, mesh_loss=False)
    ref["sp_steps"] = {"metrics": metrics, "params": final}
    tcfg = jgpt.GPTConfig(**TINY, compute_dtype=jnp.float32)
    tok_sh = JNamedSharding(_jmesh({"sp": 4}), jgpt.TOKENS_SPEC)
    b = tbatches[0]
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, t, y: jgpt.loss_fn(p, tcfg, t, y)))(
            tparams, jax.device_put(b[:, :-1], tok_sh),
            jax.device_put(b[:, 1:], tok_sh))
    ref["sp_loss"] = {"loss": float(loss), "grads": {
        p: np.asarray(v) for p, v in jsh.tree_paths_and_leaves(g)}}

    # the MoE GPT with tokens split over sp, on {sp: 2} and {sp: 2, ep: 2}
    mcfg = jgpt.GPTConfig(**TINY, moe_experts=4, compute_dtype=jnp.float32)
    ref["moe_sp"] = {}
    for name, (sizes, _port) in MOE_SP.items():
        jm = _jmesh(sizes)
        tok_sh = JNamedSharding(jm, jgpt.TOKENS_SPEC)
        placed = jax.device_put(moe_params, jgpt.GPT_SHARDING_RULES
                                .shardings_for(moe_params, jm))
        loss, g = jax.jit(jax.value_and_grad(
            lambda p, t, y: jgpt.loss_fn(p, mcfg, t, y)))(
                placed, jax.device_put(b[:, :-1], tok_sh),
                jax.device_put(b[:, 1:], tok_sh))
        ref["moe_sp"][name] = {"loss": float(loss), "grads": {
            p: np.asarray(v) for p, v in jsh.tree_paths_and_leaves(g)}}

    # pipeline_microbatches=2 over {pp: 2} with the blocks not split
    # over pp (the default rules): JAX reshards the stack
    jm = _jmesh({"pp": 2})
    mb = mbatches[0]
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, t, y: jgpt.loss_fn(p, pcfg, t, y, mesh=jm)))(
            pparams, mb[:, :-1], mb[:, 1:])
    ref["pp_unsplit"] = {
        "logits": np.asarray(jax.jit(
            lambda p, t: jgpt.apply(p, pcfg, t, mesh=jm))(pparams,
                                                           mb[:, :-1])),
        "loss": float(loss),
        "grads": {p: np.asarray(v) for p, v in
                  jsh.tree_paths_and_leaves(g)}}

    join_ranks(ranks)
    outs = []
    for r in range(4):
        with open(d / f"out-{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    ported = jser.load_pytree(str(d / "port_ckpt"), jparams)
    ref["port_ckpt"] = {p: np.asarray(v) for p, v in
                        jsh.tree_paths_and_leaves(ported)}
    return ref, outs


def _close_leaves(got, want, tol, rel_to_max=False):
    assert set(got) == set(want)
    for path, w in want.items():
        atol = tol * max(float(np.abs(w).max()), 1e-30) if rel_to_max \
            else tol
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol,
                                   err_msg=path)


def _close_metrics(got, want):
    for (tl, tg), (jl, jg) in zip(got, want):
        assert abs(tl / jl - 1) <= REL and abs(tg / jg - 1) <= REL, (got,
                                                                     want)


# -- the pipeline ---------------------------------------------------------------

@pytest.mark.parametrize("pp", [2, 4])
def test_pipeline_apply_matches_jax(run, pp):
    """``pipeline_apply`` on the affine stage function: outputs and the
    gradients of every leaf and of the input, on every rank (plain
    tensor leaves at pp 2, DTensors placed by ``pipeline_stage_spec`` at
    pp 4)."""
    ref, outs = run
    want = ref["affine"][pp]
    for out in outs:
        got = out["affine"][pp]
        for key in ("y", "w", "b", "x"):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=FWD_TOL, err_msg=key)


def test_pipeline_refusals_and_bubble_match_jax(run):
    ref, outs = run
    errors = outs[0]["errors"]
    assert errors["zero_d"] == ref["affine"]["errors"]["zero_d"]
    assert errors["batch"] == ref["affine"]["errors"]["batch"]
    assert "not divisible by the 'pp' axis size 2" in errors["layers"]
    # a DTensor stack not split over pp is cut to each stage, as JAX
    # reshards it: no refusal, and the plain stack's outputs and gradients
    assert "unsplit" not in errors
    for out in outs:
        for key in ("y", "w", "b", "x"):
            np.testing.assert_allclose(out["unsplit"][key],
                                       ref["affine"][2][key], rtol=0,
                                       atol=FWD_TOL, err_msg=key)
    assert outs[0]["pp1_direct"] is True
    for m, p in ((1, 4), (15, 2), (4, 4), (16, 4)):
        assert tpipe.pipeline_bubble_fraction(m, p) == \
            jpipe.pipeline_bubble_fraction(m, p)
    assert tpipe.pipeline_stage_spec() == tuple(jpipe.pipeline_stage_spec())


@pytest.mark.parametrize("pp", [2, 4])
def test_pipelined_gpt_matches_jax(run, pp):
    """``apply`` with ``pipeline_microbatches=2`` over ``{dp: 2, pp: 2}``
    and ``{pp: 4}``, params placed by ``GPT_PP_SHARDING_RULES``: the JAX
    pipelined logits and the JAX scan GPT's."""
    ref, outs = run
    got = outs[0]["gpt_pp"][pp]
    np.testing.assert_allclose(got, ref["gpt_pp"][pp], rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(got, ref["gpt_scan"], rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_pipelined_moe_train_step_matches_jax(run):
    """The MoE GPT (remat, 2 microbatches) on ``{pp: 2, ep: 2}``: the
    first batch's gradient of every leaf, two AdamW steps' losses and
    gradient norms, and the parameters after them."""
    ref, outs = run
    want = ref["moe"]
    for out in outs:
        _close_metrics(out["moe"]["metrics"], want["metrics"])
    _close_leaves(outs[0]["moe"]["grads"], want["grads"], REL,
                  rel_to_max=True)
    _close_leaves(outs[0]["moe"]["params"], want["params"], 1e-4)
    # each pp stage ran its own layers: the flash count is per stage
    assert outs[0]["moe"]["stage_layers"] == [0, 1]
    assert outs[2]["moe"]["stage_layers"] == [2, 3]


def test_pp_checkpoint_moves_both_ways(run):
    """The port's ranks save their ``pp``-sharded blocks (a shard per
    rank) and the JAX reader assembles them; the port loads the JAX
    checkpoint of the same placements into its DTensors."""
    ref, outs = run
    port = outs[0]["moe"]["params"]
    assert set(ref["port_ckpt"]) == set(port)
    for path, v in ref["port_ckpt"].items():
        np.testing.assert_array_equal(v, port[path], err_msg=path)
    _close_leaves(outs[0]["moe"]["from_jax"], ref["moe"]["params"], 0.0)
    assert outs[0]["moe"]["manifest_blocks"] == 2  # pp-split: two blocks


# -- sequence parallelism ---------------------------------------------------------

@pytest.mark.parametrize("fn", ["ring_attention", "ulysses_attention"])
def test_sequence_parallel_attention_matches_mha(run, fn):
    """At sp 4 each rank's block of the output and of the gradients of
    sum(out²) with respect to q, k and v: the JAX ``mha``'s."""
    ref, outs = run
    T = QKV[1] // SP
    for r, out in enumerate(outs):
        sl = slice(r * T, (r + 1) * T)
        got = out["attention"][fn]
        np.testing.assert_allclose(got["out"], ref["attention"]["out"][:, sl],
                                   rtol=FWD_TOL, atol=FWD_TOL)
        for a, b in zip(got["grads"], ref["attention"]["grads"]):
            np.testing.assert_allclose(a, b[:, sl], rtol=FWD_TOL,
                                       atol=FWD_TOL)


def test_ulysses_refuses_indivisible_heads_as_jax(run):
    ref, outs = run
    assert outs[0]["ulysses_error"] == ref["ulysses_error"]


def test_gpt_over_sp_matches_jax(run):
    """Three clipped AdamW steps of the GPT on ``{sp: 2, fsdp: 2}`` (the
    batch placed whole; each rank takes its half of the sequence) and,
    on ``{sp: 4}``, the loss and every gradient of tokens split by
    ``TOKENS_SPEC`` — the placement the port once summed wrongly."""
    ref, outs = run
    for out in outs:
        _close_metrics(out["sp"]["metrics"], ref["sp_steps"]["metrics"])
        assert abs(out["sp"]["loss4"] / ref["sp_loss"]["loss"] - 1) <= REL
    _close_leaves(outs[0]["sp"]["params"], ref["sp_steps"]["params"], 1e-4)
    _close_leaves(outs[0]["sp"]["grads4"], ref["sp_loss"]["grads"], REL,
                  rel_to_max=True)


@pytest.mark.parametrize("name", list(MOE_SP))
def test_moe_gpt_over_sp_matches_jax(run, name):
    """The MoE GPT (4 experts, k 2, capacity factor 1.25) with tokens
    split over ``sp`` by ``TOKENS_SPEC``: the loss and every leaf's
    gradient against the JAX program on the global token array, at
    ``{sp: 2}`` (the port's ranks ``{dp: 2, sp: 2}``, batch blocks and
    sequence blocks at once) and ``{sp: 2, ep: 2}``. Choices are dropped
    at capacity on every layer, so the slot order over rows and ``sp``
    ranks decides which."""
    ref, outs = run
    want = ref["moe_sp"][name]
    dropped = [out["moe_sp"][name]["dropped"] for out in outs]
    print(f"{name}: choices dropped at capacity per rank {dropped}")
    assert sum(dropped) > 0
    for out in outs:
        assert abs(out["moe_sp"][name]["loss"] / want["loss"] - 1) <= REL
    _close_leaves(outs[0]["moe_sp"][name]["grads"], want["grads"], REL,
                  rel_to_max=True)


def test_pipelined_gpt_with_unsplit_blocks_matches_jax(run):
    """``apply`` and ``loss_fn`` with ``pipeline_microbatches=2`` over
    ``pp`` 2 (the port's ranks ``{dp: 2, pp: 2}``) with the params placed
    by the default ``GPT_SHARDING_RULES``, blocks not split over ``pp``:
    the JAX program's logits, loss and every gradient. After the sum over
    ``pp`` each rank holds every layer's whole gradient: a layer whose
    gradient is zero on any rank is a fault."""
    ref, outs = run
    want = ref["pp_unsplit"]
    for out in outs:
        got = out["pp_unsplit"]
        np.testing.assert_allclose(got["logits"], want["logits"],
                                   rtol=REL, atol=REL)
        assert abs(got["loss"] / want["loss"] - 1) <= REL
        _close_leaves(got["grads"], want["grads"], REL, rel_to_max=True)
        assert got["zero_layers"] == []


def test_gpt_over_sp_dropout_equals_one_rank(run):
    """Dropout masks are drawn at the whole batch and sequence and cut to
    the rank's block: the four ranks of ``{sp: 2, fsdp: 2}`` train as the
    port does on one."""
    _, outs = run
    got, want = outs[0]["sp"]["dropout"], outs[0]["sp"]["dropout_one"]
    for (tl, tg), (ol, og) in zip(got, want):
        assert abs(tl / ol - 1) <= REL and abs(tg / og - 1) <= REL
    assert outs[0]["sp"]["dropout_differs"]


# -- the ranks ------------------------------------------------------------------

def _full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach() \
        .numpy()


def _grads(loss, params):
    """Every leaf's gradient of ``loss`` as the global array: summed over
    the data axes, as the train step sums it."""
    from torch.distributed.tensor import DTensor

    paths, leaves = zip(*port_paths(params))
    targets = [local_tensor(p) for p in leaves]
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        targets, torch.autograd.grad(loss, targets, allow_unused=True))]
    sp = spmd_of(leaves[0])
    if sp is not None:
        sp.reduce_grads(leaves, grads)
        grads = [DTensor.from_local(g, p.device_mesh, p.placements,
                                    run_check=False, shape=p.shape,
                                    stride=p.stride())
                 for g, p in zip(grads, leaves)]
    return {p: _full(g) for p, g in zip(paths, grads)}


def _affine(spec):
    M = AFFINE["M"]

    def stage(lp, h):
        w, b = local_tensor(lp["w"]), local_tensor(lp["b"])
        for j in range(w.shape[0]):
            h = torch.tanh(h @ w[j] + b[j])
        return h

    out = {}
    for pp, sizes in ((2, {"dp": 2, "pp": 2}), (4, {"pp": 4})):
        mesh = tmesh.make_mesh(tmesh.MeshSpec.from_dict(sizes))
        raw = {k: torch.from_numpy(v) for k, v in spec["stacked"].items()}
        if pp == 4:
            sh = tsh.NamedSharding(mesh, tpipe.pipeline_stage_spec())
            params = tsh.shard_put(raw, {"w": sh, "b": sh})
        else:
            params = {k: v.clone() for k, v in raw.items()}
        targets = [local_tensor(params["w"]), local_tensor(params["b"])]
        for t in targets:
            t.requires_grad_(True)
        x = torch.from_numpy(spec["x"]).requires_grad_(True)
        y = tpipe.pipeline_apply(stage, params, x, mesh=mesh,
                                 num_microbatches=M)
        gw, gb, gx = torch.autograd.grad((y ** 2).sum(), targets + [x])
        if pp == 4:
            gw, gb = (torch.distributed.tensor.DTensor.from_local(
                g, mesh, params[k].placements, run_check=False,
                shape=params[k].shape, stride=params[k].stride())
                .full_tensor() for g, k in ((gw, "w"), (gb, "b")))
        out[pp] = {"y": y.detach().numpy(), "w": gw.numpy(),
                   "b": gb.numpy(), "x": gx.numpy()}
        if pp == 2:
            errors = {}
            for name, args in (
                    ("zero_d", (raw, {"x": torch.ones(4, 16),
                                      "s": torch.zeros(())})),
                    ("batch", (raw, torch.ones(5, 16))),
                    ("layers", ({"w": raw["w"][:3]}, torch.ones(4, 16))),
                    ("unsplit", (tsh.shard_put(raw, tsh.replicated(
                        mesh, raw)), torch.ones(4, 16)))):
                try:
                    tpipe.pipeline_apply(lambda p, c: c, *args, mesh=mesh,
                                         num_microbatches=2)
                except ValueError as e:
                    errors[name] = str(e)
            rep = tsh.shard_put(raw, tsh.replicated(mesh, raw))
            targets = [local_tensor(rep["w"]), local_tensor(rep["b"])]
            for t in targets:
                t.requires_grad_(True)
            x = torch.from_numpy(spec["x"]).requires_grad_(True)
            y = tpipe.pipeline_apply(stage, rep, x, mesh=mesh,
                                     num_microbatches=M)
            gw, gb, gx = torch.autograd.grad((y ** 2).sum(), targets + [x])
            unsplit = {"y": y.detach().numpy(), "w": gw.numpy(),
                       "b": gb.numpy(), "x": gx.numpy()}
    one = tmesh.make_mesh(tmesh.MeshSpec(dp=4))
    direct = tpipe.pipeline_apply(lambda p, c: c * 2, {}, torch.ones(3),
                                  mesh=one, num_microbatches=2)
    return out, errors, unsplit, bool((direct == 2).all())


def _gpt_pp(spec):
    cfg = tgpt.GPTConfig(**PGPT, compute_dtype=torch.float32)
    params = convert.params_from_numpy(spec["pparams"], device="cpu")
    tokens = torch.from_numpy(spec["ptokens"]).long()
    out = {}
    for pp, sizes in ((2, {"dp": 2, "pp": 2}), (4, {"pp": 4})):
        mesh = tmesh.make_mesh(tmesh.MeshSpec.from_dict(sizes))
        placed = tsh.shard_put(params, tgpt.GPT_PP_SHARDING_RULES
                               .shardings_for(params, mesh))
        with torch.no_grad():
            logits = tgpt.apply(placed, cfg, tsh.to_dtensor(
                tokens, tsh.NamedSharding(mesh, tsh.batch_spec(1))))
        out[pp] = logits.full_tensor().numpy()
    return out


def _moe(spec, d, rank):
    cfg = tgpt.GPTConfig(**PMOE, compute_dtype=torch.float32)
    mesh = tmesh.make_mesh(tmesh.MeshSpec.from_dict({"dp": 1, **PMESH}))
    tx = optim.adamw(MOE_LR)
    state = tts.create_train_state(
        convert.params_from_numpy(spec["mparams"], device="cpu"), tx, 7)
    state = tts.shard_state(state, tts.state_shardings(
        state, mesh, tgpt.GPT_PP_SHARDING_RULES))
    place = tsh.NamedSharding(mesh, tsh.batch_spec(1))
    batches = [tsh.to_dtensor(torch.from_numpy(b).long(), place)
               for b in spec["mbatches"]]

    def loss(p, b, seed=None):
        return tgpt.loss_fn(p, cfg, b[:, :-1], b[:, 1:])

    grads = _grads(loss(state.params, batches[0]), state.params)
    step = tts.make_train_step(lambda p, b, s: (loss(p, b), {}), tx)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    save_pytree(os.path.join(d, "port_ckpt"), state.params, host_id=rank)
    deadline = time.monotonic() + 200   # the test writes it meanwhile
    while (not os.path.exists(os.path.join(d, "jax_ckpt.done"))
           and time.monotonic() < deadline):
        time.sleep(0.1)
    from_jax = load_pytree(os.path.join(d, "jax_ckpt"), state.params)
    qkv = state.params["blocks"]["attn_qkv"]["kernel"]
    n_local = local_tensor(qkv).shape[0]
    stage = spmd_of(qkv).pp_rank
    torch.distributed.barrier()
    blocks = 0   # of the pp-split kernel, over every rank's manifest
    for r in range(torch.distributed.get_world_size()):
        with open(os.path.join(d, "port_ckpt", f"manifest-{r}.json")) as f:
            blocks += len(json.load(f)["leaves"]["blocks.attn_qkv.kernel"]
                          ["blocks"])
    return {"metrics": metrics, "grads": grads,
            "params": {p: _full(v) for p, v in port_paths(state.params)},
            "from_jax": {p: _full(v) for p, v in port_paths(from_jax)},
            "stage_layers": list(range(stage * n_local,
                                       (stage + 1) * n_local)),
            "manifest_blocks": blocks}


def _attention(spec, rank):
    mesh = tmesh.make_mesh(tmesh.MeshSpec(dp=1, sp=SP))
    T = QKV[1] // SP
    out = {}
    for fn in (tatt.ring_attention, tatt.ulysses_attention):
        qkv = [torch.from_numpy(a[:, rank * T:(rank + 1) * T]).clone()
               .requires_grad_(True) for a in spec["qkv"]]
        y = fn(*qkv, axis_name="sp", mesh=mesh)
        grads = torch.autograd.grad((y ** 2).sum(), qkv)
        out[fn.__name__] = {"out": y.detach().numpy(),
                            "grads": [g.numpy() for g in grads]}
    six = torch.zeros((2, 8, 6, 4))
    try:
        tatt.ulysses_attention(six, six, six, axis_name="sp", mesh=mesh)
    except ValueError as e:
        error = str(e)
    return out, error


def _sp_steps(cfg, params, batches, mesh):
    tcfg = tgpt.GPTConfig(**cfg, compute_dtype=torch.float32)
    tx = _clip_adamw(optim)
    state = tts.create_train_state(
        convert.params_from_numpy(params, device="cpu"), tx, 7)
    place = None
    if mesh is not None:
        state = tts.shard_state(state, tts.state_shardings(
            state, mesh, tgpt.GPT_SHARDING_RULES))
        place = tsh.NamedSharding(mesh, tsh.batch_spec(1))
    step = tts.make_train_step(
        lambda p, b, seed: (tgpt.loss_fn(p, tcfg, b[:, :-1], b[:, 1:],
                                         training=True, dropout_seed=seed),
                            {}), tx)
    metrics = []
    for b in batches:
        b = torch.from_numpy(b).long()
        state, m = step(state, b if place is None else tsh.to_dtensor(
            b, place))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, {p: _full(v) for p, v in port_paths(state.params)}


def _sp(spec):
    mesh = tmesh.make_mesh(tmesh.MeshSpec.from_dict({"dp": 1, **SPMESH}))
    metrics, params = _sp_steps(TINY, spec["tparams"], spec["tbatches"],
                                mesh)
    mesh4 = tmesh.make_mesh(tmesh.MeshSpec(dp=1, sp=4))
    cfg = tgpt.GPTConfig(**TINY, compute_dtype=torch.float32)
    placed = tsh.shard_put(
        convert.params_from_numpy(spec["tparams"], device="cpu"),
        tgpt.GPT_SHARDING_RULES.shardings_for(spec["tparams"], mesh4))
    for p in optim.leaves(placed):
        local_tensor(p).requires_grad_(True)
    b = torch.from_numpy(spec["tbatches"][0]).long()
    tok = tsh.NamedSharding(mesh4, tgpt.TOKENS_SPEC)
    loss = tgpt.loss_fn(placed, cfg,
                        tsh.to_dtensor(b[:, :-1].contiguous(), tok),
                        tsh.to_dtensor(b[:, 1:].contiguous(), tok))
    drop = dict(TINY, dropout=0.2, remat=True)
    dropped, _ = _sp_steps(drop, spec["tparams"], spec["tbatches"][:2], mesh)
    one, _ = _sp_steps(drop, spec["tparams"], spec["tbatches"][:2], None)
    plain, _ = _sp_steps(TINY, spec["tparams"], spec["tbatches"][:2], None)
    return {"metrics": metrics, "params": params, "loss4": float(loss),
            "grads4": _grads(loss, placed), "dropout": dropped,
            "dropout_one": one,
            "dropout_differs": abs(plain[0][1] / one[0][1] - 1) > 100 * REL}


def _moe_sp(spec):
    """The MoE GPT's loss and gradients with tokens split over sp, and the
    choices this rank's tokens had dropped at capacity (every layer)."""
    cfg = tgpt.GPTConfig(**TINY, moe_experts=4, compute_dtype=torch.float32)
    b = torch.from_numpy(spec["tbatches"][0]).long()
    dropped = [0]
    routed = tgpt.moe_ffn

    def counting(*args, **kwargs):
        stats = {}
        out = routed(*args, stats=stats, **kwargs)
        dropped[0] += int((~stats["keep"]).sum())
        return out

    out = {}
    tgpt.moe_ffn = counting
    try:
        for name, (_jax, sizes) in MOE_SP.items():
            mesh = tmesh.make_mesh(tmesh.MeshSpec.from_dict(sizes))
            placed = tsh.shard_put(
                convert.params_from_numpy(spec["moe_params"], device="cpu"),
                tgpt.GPT_SHARDING_RULES.shardings_for(spec["moe_params"],
                                                      mesh))
            for p in optim.leaves(placed):
                local_tensor(p).requires_grad_(True)
            tok = tsh.NamedSharding(mesh, tgpt.TOKENS_SPEC)
            dropped[0] = 0
            loss = tgpt.loss_fn(placed, cfg,
                                tsh.to_dtensor(b[:, :-1].contiguous(), tok),
                                tsh.to_dtensor(b[:, 1:].contiguous(), tok))
            out[name] = {"loss": float(loss), "dropped": dropped[0],
                         "grads": _grads(loss, placed)}
    finally:
        tgpt.moe_ffn = routed
    return out


def _pp_unsplit(spec):
    """``pipeline_microbatches=2`` over ``{dp: 2, pp: 2}`` with the params
    placed by ``GPT_SHARDING_RULES`` (blocks not split over pp): logits,
    loss, every gradient, and the (leaf, layer) pairs of the stacked
    blocks whose gradient is all zero on this rank."""
    cfg = tgpt.GPTConfig(**PGPT, compute_dtype=torch.float32)
    mesh = tmesh.make_mesh(tmesh.MeshSpec.from_dict({"dp": 2, "pp": 2}))
    placed = tsh.shard_put(
        convert.params_from_numpy(spec["pparams"], device="cpu"),
        tgpt.GPT_SHARDING_RULES.shardings_for(spec["pparams"], mesh))
    assert not any(split_over(t, "pp", 0) for _p, t in port_paths(placed))
    for p in optim.leaves(placed):
        local_tensor(p).requires_grad_(True)
    b = torch.from_numpy(spec["mbatches"][0]).long()
    place = tsh.NamedSharding(mesh, tsh.batch_spec(1))
    inp = tsh.to_dtensor(b[:, :-1].contiguous(), place)
    with torch.no_grad():
        logits = tgpt.apply(placed, cfg, inp).full_tensor().numpy()
    loss = tgpt.loss_fn(placed, cfg, inp,
                        tsh.to_dtensor(b[:, 1:].contiguous(), place))
    grads = _grads(loss, placed)
    zero = [(p, layer) for p, g in grads.items() if p.startswith("blocks")
            for layer in range(g.shape[0]) if not np.any(g[layer])]
    return {"logits": logits, "loss": float(loss), "grads": grads,
            "zero_layers": zero}


def worker_all(d):
    torch.set_num_threads(1)
    ctx = launch.init_from_env("cpu")
    with open(os.path.join(d, "in.pkl"), "rb") as f:
        spec = pickle.load(f)
    affine, errors, unsplit, direct = _affine(spec)
    attention, ulysses_error = _attention(spec, ctx.rank)
    out = {"affine": affine, "errors": errors, "unsplit": unsplit,
           "pp1_direct": direct, "gpt_pp": _gpt_pp(spec),
           "attention": attention, "ulysses_error": ulysses_error,
           "sp": _sp(spec), "moe_sp": _moe_sp(spec),
           "pp_unsplit": _pp_unsplit(spec)}
    out["moe"] = _moe(spec, d, ctx.rank)   # last: it reads the JAX checkpoint
    with open(os.path.join(d, f"out-{ctx.rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    launch.shutdown()


WORKERS = {"all": worker_all}

if __name__ == "__main__":
    WORKERS[sys.argv[1]](sys.argv[2])
