"""The parallelism slice of the port against the JAX package, on the CPU.

The JAX side runs in this process on the virtual 8-device CPU mesh
(``tests/conftest.py``). The port's ranks are subprocesses started by
``python -m determined_clone_tpu_torch.exec.launch --device cpu`` (gloo),
each running this file as a script with one of the ``WORKERS`` below;
they read their inputs from and write their results to ``tmp_path``.
A rank that hangs is killed at the launcher's ``--timeout`` and fails
its test.

Tolerances (fp32 compute): losses within 1e-5 relative and the reported
``grad_norm`` within 1e-5 relative of JAX's; parameters within 1e-4
after three AdamW steps. Adam's first updates are about ``lr·sign(g)``,
so an element whose gradient is rounding noise moves by up to ``2·lr``
between any two summation orders (``tests/test_torch_training.py``); at
``lr = 1e-4`` that noise stays near 1e-5 (measured 1e-6–1e-5).
"""
import os
import pickle
import subprocess
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
    tree_paths_and_leaves as port_paths,
)
from determined_clone_tpu_torch.exec import launch  # noqa: E402
from determined_clone_tpu_torch.models import gpt as tgpt  # noqa: E402
from determined_clone_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from determined_clone_tpu_torch.parallel import sharding as tsh  # noqa: E402
from determined_clone_tpu_torch.training import optim  # noqa: E402
from determined_clone_tpu_torch.training import train_step as tts  # noqa: E402

if __name__ != "__main__":  # the ranks never import JAX
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding as JNamedSharding

    from determined_clone_tpu.models import gpt as jgpt
    from determined_clone_tpu.parallel import mesh as jmesh
    from determined_clone_tpu.parallel import sharding as jsh
    from determined_clone_tpu.training import train_step as jts

TINY = dict(vocab_size=256, n_layers=2, d_model=64, n_heads=4, d_ff=128,
            max_seq_len=64, remat=False)
MOE = dict(TINY, moe_experts=4, moe_capacity_factor=0.5)
LR = 1e-4
CLIP = 0.5     # the tiny GPT's first gradient norm is ~1.9: the clip binds
LAUNCH_TIMEOUT = 240


def start_ranks(n, worker, d, timeout=LAUNCH_TIMEOUT, script=__file__):
    """Start ``worker`` of ``script`` (this file) on ``n`` gloo ranks;
    :func:`join_ranks` waits for them."""
    cmd = [sys.executable, "-m", "determined_clone_tpu_torch.exec.launch",
           "--nprocs", str(n), "--device", "cpu", "--timeout", str(timeout),
           "--", sys.executable, os.path.abspath(script), worker, str(d)]
    env = {**os.environ, "PYTHONPATH": REPO}
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def join_ranks(proc, timeout=LAUNCH_TIMEOUT):
    """Wait for ranks :func:`start_ranks` started; fail on any rank's
    failure, with the ranks' output."""
    try:
        out, err = proc.communicate(timeout=timeout + 60)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0, (proc.returncode, out[-2000:],
                                  err[-6000:])


def launch_ranks(n, worker, d, timeout=LAUNCH_TIMEOUT, script=__file__):
    """Run ``worker`` of ``script`` (this file) on ``n`` gloo ranks; fail
    on any rank's failure, with the ranks' output."""
    join_ranks(start_ranks(n, worker, d, timeout, script), timeout)


# -- MeshSpec and the rules ----------------------------------------------------

@pytest.mark.parametrize("spec,n", [
    ({}, 8), ({"fsdp": 2}, 8), ({"dp": 2, "tp": 2}, 4),
    ({"dp": -1, "fsdp": 2, "tp": 2}, 8), ({"fsdp": 3}, 8),
    ({"dp": 2, "fsdp": 2}, 8), ({"dp": -1, "fsdp": -1}, 4),
    ({"dp": 1, "tp": 0}, 1), ({"ep": 2, "dp": 1}, 2)])
def test_mesh_spec_resolve_matches_jax(spec, n):
    def outcome(mod):
        try:
            return mod.MeshSpec(**spec).resolve(n).to_dict()
        except ValueError as e:
            return ("ValueError", str(e))
    assert outcome(tmesh) == outcome(jmesh)


@pytest.mark.parametrize("raw", [{"fsdp": 8}, {"dp": "2", "tp": 4},
                                 {"fsdp": 2, "bogus": 1}, {}])
def test_mesh_spec_from_dict_matches_jax(raw):
    def outcome(mod):
        try:
            return mod.MeshSpec.from_dict(raw).to_dict()
        except ValueError as e:
            return ("ValueError", str(e))
    assert outcome(tmesh) == outcome(jmesh)
    assert tmesh.AXES == jmesh.AXES


class FakeMesh:
    """What the spec logic reads of a DeviceMesh, for rank ``rank`` of a
    mesh of the given axis sizes (ranks row-major over AXES)."""

    def __init__(self, sizes, rank=0):
        self.mesh_dim_names = tmesh.AXES
        self._sizes = [sizes.get(a, 1) for a in tmesh.AXES]
        self._coord = [int(c) for c in np.unravel_index(rank, self._sizes)]

    def size(self, i):
        return self._sizes[i]

    def get_coordinate(self):
        return self._coord


MESHES = [{"fsdp": 2}, {"dp": 2, "tp": 2}, {"dp": 2, "ep": 2},
          {"fsdp": 2, "tp": 2}]
MESH_IDS = ["fsdp2", "dp2_tp2", "dp2_ep2", "fsdp2_tp2"]


def _jax_shapes(cfg):
    return jax.eval_shape(lambda k: jgpt.init(k, jgpt.GPTConfig(**cfg)),
                          jax.random.PRNGKey(0))


def _jax_mesh(sizes):
    n = int(np.prod(list(sizes.values())))
    return jmesh.make_mesh(jmesh.MeshSpec.from_dict(
        {"dp": 1, **sizes}), jax.devices()[:n])


def _norm(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


@pytest.mark.parametrize("model", ["dense", "moe"])
@pytest.mark.parametrize("sizes", MESHES, ids=MESH_IDS)
def test_spec_for_matches_jax_on_every_gpt_leaf(model, sizes):
    shapes = _jax_shapes(TINY if model == "dense" else MOE)
    jm = _jax_mesh(sizes)
    spec = tmesh.MeshSpec.from_dict({"dp": 1, **sizes})
    for rules_t, rules_j in ((tgpt.GPT_SHARDING_RULES,
                              jgpt.GPT_SHARDING_RULES),
                             (tsh.ShardingRules(), jsh.ShardingRules())):
        for path, leaf in jsh.tree_paths_and_leaves(shapes):
            want = _norm(rules_j.spec_for(path, leaf, jm))
            assert _norm(rules_t.spec_for(path, leaf, spec)) == want, path
            assert _norm(rules_t.spec_for(path, leaf, sizes)) == want, path


@pytest.mark.parametrize("model", ["dense", "moe"])
@pytest.mark.parametrize("sizes", MESHES, ids=MESH_IDS)
def test_each_ranks_block_matches_jax_addressable_shards(model, sizes):
    """Rank r's block of every leaf (``shard_index`` on the placements of
    its spec) is the index JAX gives device r of the same mesh."""
    shapes = _jax_shapes(TINY if model == "dense" else MOE)
    jm = _jax_mesh(sizes)
    n = jm.devices.size
    for path, leaf in jsh.tree_paths_and_leaves(shapes):
        jspec = jgpt.GPT_SHARDING_RULES.spec_for(path, leaf, jm)
        index = JNamedSharding(jm, jspec).devices_indices_map(leaf.shape)
        for r in range(n):
            fake = FakeMesh(sizes, r)
            tspec = tgpt.GPT_SHARDING_RULES.spec_for(path, leaf, fake)
            got = tsh.shard_index(leaf.shape, fake,
                                  tsh.placements_for(tspec, fake))
            want = [[0 if s.start is None else s.start,
                     d if s.stop is None else s.stop]
                    for s, d in zip(index[jax.devices()[r]], leaf.shape)]
            assert got == want, (path, r)
    # the batch: dp-major over (dp, fsdp)
    bshape = (8, 17)
    bidx = JNamedSharding(jm, jsh.batch_spec(1)).devices_indices_map(bshape)
    for r in range(n):
        fake = FakeMesh(sizes, r)
        got = tsh.shard_index(bshape, fake, tsh.placements_for(
            tsh.batch_spec(1), fake))
        s = bidx[jax.devices()[r]][0]
        assert got[0] == [s.start or 0, 8 if s.stop is None else s.stop]


def test_placements_refuse_what_jax_would_order_otherwise():
    fake = FakeMesh({"dp": 2, "fsdp": 2})
    from torch.distributed.tensor import Replicate, Shard
    assert tsh.placements_for(tsh.batch_spec(1), fake) == (
        Shard(0), Shard(0), Replicate(), Replicate(), Replicate(),
        Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        tsh.placements_for(tsh.P(("fsdp", "dp")), fake)
    with pytest.raises(ValueError, match="twice"):
        tsh.placements_for(tsh.P("dp", "dp"), fake)
    with pytest.raises(ValueError, match="divide"):
        tsh.shard_index((3, 4), fake, tsh.placements_for(tsh.P("dp"), fake))
    assert tsh.batch_seq_spec() == jsh.batch_seq_spec()
    assert tgpt.TOKENS_SPEC == jgpt.TOKENS_SPEC
    assert tgpt.ACTIVATION_SPEC == jgpt.ACTIVATION_SPEC


def test_mesh_helpers_match_jax():
    for sizes in ({"dp": 2, "fsdp": 4}, {"tp": 8}, {"fsdp": 2, "tp": 2}):
        spec = tmesh.MeshSpec.from_dict({"dp": 1, **sizes})
        jm = _jax_mesh(sizes)
        assert (tmesh.data_parallel_submesh_size(spec)
                == jmesh.data_parallel_submesh_size(jm))
        assert (tmesh.mesh_axis_size(spec, "tp", "fsdp")
                == jmesh.mesh_axis_size(jm, "tp", "fsdp"))


# -- multi-rank steps against the JAX package on the same mesh ----------------

def _tx(mod):
    return mod.chain(mod.clip_by_global_norm(CLIP),
                     mod.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1))


def _batches(n=3, B=8, T=17, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=(B, T)).astype(np.int32)
            for _ in range(n)]


def _jax_steps(cfg, sizes, params, batches):
    jcfg = jgpt.GPTConfig(**cfg, compute_dtype=jnp.float32)
    jm = _jax_mesh(sizes)
    tx = _tx(optax)
    state = jts.create_train_state(params, tx, jax.random.PRNGKey(1))
    sh = jts.state_shardings(state, jm, jgpt.GPT_SHARDING_RULES)
    state = jax.device_put(state, sh)

    def loss(p, b, rng):
        return jgpt.loss_fn(p, jcfg, b[:, :-1], b[:, 1:]), {}

    step = jts.make_train_step(
        loss, tx, mesh=jm, state_sharding=sh,
        batch_sharding=JNamedSharding(jm, jsh.batch_spec(1)))
    metrics = []
    for b in batches:
        state, m = step(state, jnp.asarray(b))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, {p: np.asarray(v) for p, v in
                     jsh.tree_paths_and_leaves(state.params)}


@pytest.mark.parametrize("model,sizes", [
    ("dense", {"fsdp": 2}), ("dense", {"dp": 2, "tp": 2}),
    ("moe", {"dp": 2, "ep": 2})], ids=["fsdp2", "dp2_tp2", "moe_dp2_ep2"])
def test_adamw_steps_match_jax_on_the_mesh(tmp_path, model, sizes):
    """Three steps of ``chain(clip_by_global_norm(0.5), adamw)`` — the
    clip binds — with the state and batch placed by the GPT rules: the
    losses, the global gradient norms and the parameters agree with the
    JAX program on the same mesh. The MoE case's capacity factor 0.5
    drops tokens, so its routing depends on the other dp rank's tokens."""
    cfg = TINY if model == "dense" else MOE
    params = jax.device_get(jgpt.init(jax.random.PRNGKey(0),
                                      jgpt.GPTConfig(**cfg)))
    batches = _batches()
    jm, jp = _jax_steps(cfg, sizes, params, batches)
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump({"cfg": cfg, "mesh": sizes, "params": params,
                     "batches": batches}, f)
    launch_ranks(int(np.prod(list(sizes.values()))), "steps", tmp_path)
    with open(tmp_path / "out.pkl", "rb") as f:
        out = pickle.load(f)
    for (jl, jg), (tl, tg) in zip(jm, out["metrics"]):
        assert abs(tl / jl - 1) <= 1e-5 and abs(tg / jg - 1) <= 1e-5, (
            jm, out["metrics"])
    assert jm[0][1] > CLIP
    assert set(out["params"]) == set(jp)
    for path, v in out["params"].items():
        np.testing.assert_allclose(v, jp[path], rtol=0, atol=1e-4,
                                   err_msg=path)
    assert out["allgather"] == list(range(len(out["allgather"])))
    assert out["clip_equal"] and out["norm_rel"] <= 1e-6
    if len(out["allgather"]) == 2:
        assert out["pp_matches"] is True
    if len(out["allgather"]) == 4:
        # slice-major ranks, as the JAX function orders devices
        jm = jmesh.make_multislice_mesh(jmesh.MeshSpec(dp=1, tp=2),
                                        jmesh.MeshSpec(dp=2),
                                        jax.devices()[:4])
        ids = np.vectorize(lambda dev: dev.id)(jm.devices)
        assert out["multislice"] == (ids - ids.min()).tolist()
    assert out["apply_err"] <= 1e-5
    assert out["flash_refuses"] is True


def test_dropout_two_ranks_equal_one_rank(tmp_path):
    """Dropout masks are drawn at the global batch's shape and cut to the
    rank's rows: two fsdp ranks train as the port does on one."""
    cfg = dict(TINY, dropout=0.2, remat=True)
    params = jax.device_get(jgpt.init(jax.random.PRNGKey(0),
                                      jgpt.GPTConfig(**cfg)))
    batches = _batches(2)
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump({"cfg": cfg, "mesh": {"fsdp": 2}, "params": params,
                     "batches": batches}, f)
    launch_ranks(2, "steps", tmp_path)
    with open(tmp_path / "out.pkl", "rb") as f:
        out = pickle.load(f)
    ones, one_params = _port_steps(cfg, params, batches)
    for (tl, tg), (ol, og) in zip(out["metrics"], ones):
        assert abs(tl / ol - 1) <= 1e-5 and abs(tg / og - 1) <= 1e-5
    for path, v in out["params"].items():
        np.testing.assert_allclose(v, one_params[path], rtol=0, atol=1e-4,
                                   err_msg=path)
    # the masks are on: the same steps without dropout differ
    plain, _ = _port_steps(dict(cfg, dropout=0.0), params, batches)
    assert abs(plain[0][1] / ones[0][1] - 1) > 100 * 1e-5  # grad norms


def _port_steps(cfg, params, batches, mesh=None,
                rules=tgpt.GPT_SHARDING_RULES):
    """The port's steps on one rank (``mesh`` None) or on ``mesh``."""
    tcfg = tgpt.GPTConfig(**cfg, compute_dtype=torch.float32)
    tx = _tx(optim)
    state = tts.create_train_state(
        convert.params_from_numpy(params, device="cpu"), tx, 7)
    place = None
    if mesh is not None:
        state = tts.shard_state(state, tts.state_shardings(
            state, mesh, rules))
        place = tsh.NamedSharding(mesh, tsh.batch_spec(1))

    def loss(p, b, seed):
        return tgpt.loss_fn(p, tcfg, b[:, :-1], b[:, 1:], training=True,
                            dropout_seed=seed), {}

    step = tts.make_train_step(loss, tx)
    metrics = []
    for b in batches:
        b = torch.from_numpy(b)
        if place is not None:
            b = tsh.to_dtensor(b, place)
        state, m = step(state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    full = {p: (v.full_tensor() if hasattr(v, "full_tensor") else v)
            .detach().numpy() for p, v in port_paths(state.params)}
    return metrics, full


def _clip_check(mesh, params):
    """``clip_by_global_norm`` over DTensor gradients scales by the norm of
    the global tensors: the same update as on the full tensors."""
    shardings = tgpt.GPT_SHARDING_RULES.shardings_for(params, mesh)
    gen = torch.Generator().manual_seed(5)
    grads = optim.tree_map(
        lambda p: torch.randn(p.shape, generator=gen), params)
    full_p = optim.tree_map(lambda p: p.detach().clone(), params)
    tx = optim.clip_by_global_norm(0.01)
    tx.update(grads, tx.init(full_p), full_p)
    dp, dg = tsh.shard_put(params, shardings), tsh.shard_put(grads, shardings)
    tx.update(dg, tx.init(dp), dp)
    full_norm = float(optim.global_norm(optim.leaves(grads)))
    sharded_norm = float(optim.global_norm(optim.leaves(dg)))
    equal = all(torch.allclose(a.full_tensor(), b, rtol=0, atol=1e-7)
                for a, b in zip(optim.leaves(dp), optim.leaves(full_p)))
    return equal, abs(sharded_norm / full_norm - 1)


def _pp_parity(spec):
    """The GPipe pipeline (``pipeline_microbatches=2`` over ``pp: 2``,
    params placed by ``GPT_PP_SHARDING_RULES``): its loss and gradient
    norm equal the one-rank port's within 1e-5 relative."""
    mesh = tmesh.make_mesh(tmesh.MeshSpec.from_dict({"dp": 1, "pp": 2}))
    cfg = dict(spec["cfg"], pipeline_microbatches=2)
    piped, _ = _port_steps(cfg, spec["params"], spec["batches"][:1], mesh,
                           rules=tgpt.GPT_PP_SHARDING_RULES)
    alone, _ = _port_steps(cfg, spec["params"], spec["batches"][:1])
    (pl, pg), (ol, og) = piped[0], alone[0]
    return abs(pl / ol - 1) <= 1e-5 and abs(pg / og - 1) <= 1e-5


def _apply_check(mesh, spec):
    """``apply`` over the mesh: a DTensor of the global batch's logits,
    whole vocabulary, equal to the one-rank forward's."""
    cfg = tgpt.GPTConfig(**spec["cfg"], compute_dtype=torch.float32)
    params = convert.params_from_numpy(spec["params"], device="cpu")
    tokens = torch.from_numpy(spec["batches"][0]).long()
    with torch.no_grad():
        want = tgpt.apply(params, cfg, tokens)
        got = tgpt.apply(
            tsh.shard_put(params, tgpt.GPT_SHARDING_RULES.shardings_for(
                params, mesh)), cfg,
            tsh.to_dtensor(tokens, tsh.NamedSharding(mesh, tsh.batch_spec(1))))
        return float((got.full_tensor() - want).abs().max())


def _flash_refuses_dtensors(mesh):
    """The flash kernel's argument check refuses a DTensor (no fallback);
    the same tensor's local block passes it."""
    from determined_clone_tpu_torch.ops.flash_attention import (
        check_kernel_args,
    )
    q = torch.zeros((4, 16, 4, 64))
    dq = tsh.to_dtensor(q, tsh.NamedSharding(mesh, tsh.batch_spec(3)))
    try:
        check_kernel_args(dq, dq, dq)
    except ValueError as e:
        return "DTensor" in str(e) and check_kernel_args(
            dq.to_local(), dq.to_local(), dq.to_local())[2] == 16
    return False


def test_sequence_parallel_attention_matches_mha_on_two_ranks(tmp_path):
    """Ring and Ulysses attention at sp 2 (two gloo ranks): each rank's
    block of the output and of the gradients equal the port's ``mha`` on
    the whole sequence, and Ulysses refuses indivisible heads.
    ``tests/test_torch_pipeline.py`` holds both against JAX at sp 4."""
    launch_ranks(2, "sp", tmp_path)
    with open(tmp_path / "out.pkl", "rb") as f:
        out = pickle.load(f)
    assert out["ring_attention"] <= 2e-4
    assert out["ulysses_attention"] <= 2e-4
    assert "divisible by the 'sp' axis size (2)" in out["refusal"]


# -- the ranks ----------------------------------------------------------------

def worker_steps(d):
    torch.set_num_threads(1)
    dist = launch.init_from_env("cpu")
    with open(os.path.join(d, "in.pkl"), "rb") as f:
        spec = pickle.load(f)
    mesh = tmesh.make_mesh(tmesh.MeshSpec.from_dict(spec["mesh"]))
    metrics, full = _port_steps(spec["cfg"], spec["params"],
                                spec["batches"], mesh)
    gathered = dist.allgather(dist.rank)
    assert dist.broadcast(dist.rank) == 0
    dist.barrier()
    equal, norm_rel = _clip_check(
        mesh, convert.params_from_numpy(spec["params"], device="cpu"))
    pp_matches = _pp_parity(spec) if dist.size == 2 else None
    multislice = None
    if dist.size == 4:
        multislice = tmesh.make_multislice_mesh(
            tmesh.MeshSpec(dp=1, tp=2), tmesh.MeshSpec(dp=2)).mesh.tolist()
    apply_err = _apply_check(mesh, spec)
    if dist.is_chief:
        with open(os.path.join(d, "out.pkl"), "wb") as f:
            pickle.dump({"metrics": metrics, "params": full,
                         "allgather": gathered, "clip_equal": equal,
                         "norm_rel": norm_rel, "pp_matches": pp_matches,
                         "multislice": multislice, "apply_err": apply_err,
                         "flash_refuses": _flash_refuses_dtensors(mesh)},
                        f)
    launch.shutdown()


def worker_sp(d):
    """Ring and Ulysses at sp 2 against ``mha``: the largest difference
    over each function's output and gradients."""
    from determined_clone_tpu_torch.ops import attention as tatt

    torch.set_num_threads(1)
    dist = launch.init_from_env("cpu")
    mesh = tmesh.make_mesh(tmesh.MeshSpec(dp=1, sp=2))
    gen = torch.Generator().manual_seed(0)
    qkv = [torch.randn(2, 64, 4, 16, generator=gen) for _ in range(3)]
    whole = [t.clone().requires_grad_(True) for t in qkv]
    ref = tatt.mha(*whole, causal=True)
    ref_g = torch.autograd.grad((ref ** 2).sum(), whole)
    sl = slice(dist.rank * 32, (dist.rank + 1) * 32)
    out = {}
    for fn in (tatt.ring_attention, tatt.ulysses_attention):
        mine = [t[:, sl].clone().requires_grad_(True) for t in qkv]
        y = fn(*mine, axis_name="sp", mesh=mesh)
        g = torch.autograd.grad((y ** 2).sum(), mine)
        out[fn.__name__] = max(
            [float((y - ref[:, sl]).abs().max())]
            + [float((a - b[:, sl]).abs().max()) for a, b in zip(g, ref_g)])
    three = torch.zeros(1, 4, 3, 8)
    try:
        tatt.ulysses_attention(three, three, three, axis_name="sp",
                               mesh=mesh)
    except ValueError as e:
        out["refusal"] = str(e)
    worst = [None] * dist.size
    torch.distributed.all_gather_object(worst, out)
    if dist.is_chief:
        merged = {k: max(w[k] for w in worst) if k != "refusal" else
                  out[k] for k in out}
        with open(os.path.join(d, "out.pkl"), "wb") as f:
            pickle.dump(merged, f)
    launch.shutdown()


def test_mesh_check_holds_on_two_ranks():
    """``parallel/check.py``, the card's multi-rank check, on two gloo
    ranks: every case within its bounds."""
    import json
    cmd = [sys.executable, "-m", "determined_clone_tpu_torch.exec.launch",
           "--nprocs", "2", "--device", "cpu", "--timeout",
           str(LAUNCH_TIMEOUT), "--", sys.executable, "-m",
           "determined_clone_tpu_torch.parallel.check"]
    r = subprocess.run(cmd, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                       capture_output=True, text=True,
                       timeout=LAUNCH_TIMEOUT + 60)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    cases = [json.loads(line) for line in r.stdout.splitlines()
             if line.startswith("{")]
    assert [(c["model"], c["mesh"]) for c in cases] == [
        ("dense", {"fsdp": 2}), ("moe", {"ep": 2}), ("trial", {"fsdp": 2})]
    assert all(c["ok"] for c in cases)
    assert all(c["checkpoint_round_trip"] for c in cases[:2])
    assert cases[2]["restored_from"] and cases[2]["max_rel"] <= 1e-5


# -- the launcher ---------------------------------------------------------------

def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.mark.parametrize("fate", ["dies", "hangs"])
def test_launcher_reaps_every_rank(tmp_path, fate):
    """A rank that exits non-zero makes the launcher kill the others and
    exit with its code; ranks past ``--timeout`` are all killed (124)."""
    # rank 1 dies only once rank 0 has written its pid (within 20 s), so
    # the launcher has both ranks' pids to check
    script = ("import os, sys, time; r = int(os.environ['RANK']); "
              f"d = {str(tmp_path)!r}; "
              "open(os.path.join(d, f'pid{r}.tmp'), 'w')"
              ".write(str(os.getpid())); "
              "os.replace(os.path.join(d, f'pid{r}.tmp'), "
              "os.path.join(d, f'pid{r}')); "
              + ("t = time.monotonic() + 20\n"
                 "while r == 1 and not os.path.exists(os.path.join(d, 'pid0'))"
                 " and time.monotonic() < t: time.sleep(0.01)\n"
                 "sys.exit(3) if r == 1 else time.sleep(120)"
                 if fate == "dies" else "time.sleep(120)"))
    t0 = time.monotonic()
    code = launch.spawn([sys.executable, "-c", script], 2, device="cpu",
                        timeout_s=30 if fate == "dies" else 3)
    assert code == (3 if fate == "dies" else 124)
    assert time.monotonic() - t0 < 60
    pids = [int((tmp_path / f"pid{r}").read_text()) for r in range(2)]
    assert not any(_alive(p) for p in pids)
    env = launch.rank_env(1, 2, 1234, "cpu", base={})
    assert (env["RANK"], env["WORLD_SIZE"], env["LOCAL_RANK"],
            env["MASTER_PORT"], env["DCT_DEVICE"]) == ("1", "2", "1", "1234",
                                                       "cpu")
    with pytest.raises(ValueError):
        launch.spawn(["true"], 1, device="tpu")


WORKERS = {"steps": worker_steps, "sp": worker_sp}

if __name__ == "__main__":
    WORKERS[sys.argv[1]](sys.argv[2])
