"""The model families on meshes, against the JAX package on the CPU:
BASELINE #2 (``MnistTrial`` on ``{dp: 2}``, ``examples/mnist/
distributed.yaml``'s ``dp: 8`` cut to two ranks), BASELINE #3
(``ResNetTrial`` on ``{dp: 2, fsdp: 2}``, ``distributed.yaml``'s dp 4 ×
fsdp 2 cut to four ranks, small depth and image) through both packages'
``Trainer.fit``, and BERT's ``classify``, its loss and the MLM loss
under ``BERT_SHARDING_RULES`` on ``{fsdp: 2, tp: 2}``.

The JAX trials run in this process on the virtual 8-device CPU mesh
(``tests/conftest.py``), each on the mesh its ``mesh`` hparam and
``slots_per_trial`` make. The port's run on gloo ranks (``exec/
launch.py``) that run this file as a script, started before the JAX
side computes; each trial also runs alone on one rank (no mesh), the
port's one-card program.

Tolerances, fp32 with dropout off across the frameworks: reported losses
within 1e-3 relative and validation accuracies equal (the family trials'
bounds, ``tests/test_torch_family_trials.py``); meshed against the
port's own one-card run within 1e-5 relative, dropout on; BERT's
logits and losses within 2e-4, gradients within 1e-5 of the largest
element of JAX's leaf.
"""
import dataclasses
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from determined_clone_tpu_torch import convert  # noqa: E402
from determined_clone_tpu_torch import core as tcore  # noqa: E402
from determined_clone_tpu_torch.config import (  # noqa: E402
    ExperimentConfig as TConfig,
)
from determined_clone_tpu_torch.core._serialization import (  # noqa: E402
    tree_paths_and_leaves as port_paths,
)
from determined_clone_tpu_torch.examples import mnist as tmnist  # noqa: E402
from determined_clone_tpu_torch.examples import resnet50 as tresnet  # noqa: E402
from determined_clone_tpu_torch.exec import launch  # noqa: E402
from determined_clone_tpu_torch.models import bert as tbert  # noqa: E402
from determined_clone_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from determined_clone_tpu_torch.parallel import sharding as tsh  # noqa: E402
from determined_clone_tpu_torch.parallel.spmd import (  # noqa: E402
    local_tensor,
    spmd_of,
)
from determined_clone_tpu_torch.training import Trainer as TTrainer  # noqa: E402
from determined_clone_tpu_torch.training import (  # noqa: E402
    TrialContext as TContext,
)

if __name__ != "__main__":  # the ranks never import JAX
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding as JNamedSharding

    from determined_clone_tpu import core as jcore
    from determined_clone_tpu.config import ExperimentConfig as JConfig
    from determined_clone_tpu.models import bert as jbert
    from determined_clone_tpu.models import mnist_cnn as jmnist
    from determined_clone_tpu.models import resnet as jresnet
    from determined_clone_tpu.parallel import mesh as jmesh
    from determined_clone_tpu.parallel import sharding as jsh
    from determined_clone_tpu.training import Trainer as JTrainer
    from determined_clone_tpu.training import TrialContext as JContext

    from tests.test_torch_parallel import join_ranks, start_ranks

LOSS_RTOL, MESH_RTOL, FWD_TOL, GRAD_REL = 1e-3, 1e-5, 2e-4, 1e-5
MNIST_HP = {"global_batch_size": 16, "lr": 1e-3, "n_filters_1": 4,
            "n_filters_2": 8, "dropout_1": 0.0, "dropout_2": 0.0,
            "dataset": "digits", "mesh": {"dp": 2}}
RESNET_HP = {"global_batch_size": 4, "lr": 1e-4, "depth": 26, "width": 8,
             "n_classes": 10, "image_size": 64, "n_train": 32,
             "mesh": {"dp": 2, "fsdp": 2}}
BERT_MESH = {"fsdp": 2, "tp": 2}
TIMING = ("batches_per_second", "samples_per_second")
VAL_BATCHES = 4   # of each trial's validation set, to keep the run short


def _config(batches, slots, val):
    return {"searcher": {"name": "single", "metric": "loss",
                         "max_length": {"batches": batches}},
            "scheduling_unit": 5, "min_validation_period": {"batches": val},
            "checkpoint_policy": "none",
            "resources": {"slots_per_trial": slots}}


# -- the port's trials, from given numpy params -------------------------------

def _port_trial(base, init_np):
    class T(base):
        def __init__(self, context):
            super().__init__(context)
            self.cfg = dataclasses.replace(self.cfg,
                                           compute_dtype=torch.float32)

        def initial_params(self, gen):
            return convert.params_from_numpy(init_np, self.context.device)

        def validation_data(self):
            return list(super().validation_data())[:VAL_BATCHES]

    return T


def _reports(records):
    return sorted(((r["group"], r["steps_completed"],
                    {k: v for k, v in r["metrics"].items()
                     if k not in TIMING}) for r in records),
                  key=lambda r: r[:2])


def _fit_port(cls, cfg_dict, hp, d, dist=None, mesh="hparam"):
    cfg = TConfig.from_dict(cfg_dict)
    kw = {} if mesh == "hparam" else {"mesh": mesh}
    with tcore.init(config=cfg, distributed=dist, storage_path=d,
                    trial_id=1) as ctx:
        trainer = TTrainer(cls(TContext(config=cfg, hparams=hp, core=ctx,
                                        device="cpu", **kw)))
        trainer.fit()
        records = list(ctx.train._backend.records)
    params = {p: (v.full_tensor() if hasattr(v, "full_tensor") else v)
              .detach().numpy()
              for p, v in port_paths(trainer._final_state.params)}
    return _reports(records), params


# -- the JAX side -------------------------------------------------------------

def _load_example(subdir):
    path = os.path.join(REPO, "examples", subdir, "model_def.py")
    spec = importlib.util.spec_from_file_location(f"{subdir}_model_def",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fit_jax(base, init_np, cfg_dict, hp, d):
    class J(base):
        def __init__(self, context):
            super().__init__(context)
            self.cfg = dataclasses.replace(self.cfg,
                                           compute_dtype=jnp.float32)

        def initial_params(self, rng):
            return jax.tree.map(jnp.asarray, init_np)

        def validation_data(self):
            return list(super().validation_data())[:VAL_BATCHES]

    cfg = JConfig.from_dict({**cfg_dict, "checkpoint_storage": {
        "type": "shared_fs", "host_path": str(d)}})
    with jcore.init(config=cfg, trial_id=1) as ctx:
        trainer = JTrainer(J(JContext(config=cfg, hparams=hp, core=ctx)))
        trainer.fit()
        mesh = dict(trainer.trial.context.mesh.shape)
        records = list(ctx.train._backend.records)
    params = {p: np.asarray(v) for p, v in
              jsh.tree_paths_and_leaves(trainer._final_state.params)}
    return _reports(records), params, mesh


def _same_reports(got, want, rtol):
    assert [(g, s) for g, s, _ in got] == [(g, s) for g, s, _ in want]
    for (g, s, mt), (_, _, mj) in zip(got, want):
        assert abs(mt["loss"] / mj["loss"] - 1) <= rtol, (g, s, mt, mj)
        if "accuracy" in mj:
            if rtol == LOSS_RTOL:
                assert mt["accuracy"] == mj["accuracy"], (g, s, mt, mj)
            else:
                assert abs(mt["accuracy"] - mj["accuracy"]) <= rtol


def _params_close(got, want, rel_l2):
    assert set(got) == set(want)
    for path in want:
        dist = np.linalg.norm(got[path] - want[path])
        assert dist <= rel_l2 * np.linalg.norm(want[path]), (
            path, dist / np.linalg.norm(want[path]))


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnist-mesh")
    cfg = jmnist.MnistCNNConfig(n_filters_1=4, n_filters_2=8)
    init_np = jax.device_get(jmnist.init(jax.random.PRNGKey(3), cfg))
    cfg_dict = _config(10, 2, 5)
    with open(d / "in.pkl", "wb") as f:
        pickle.dump({"init": init_np, "cfg": cfg_dict}, f)
    ranks = start_ranks(2, "mnist", d, script=__file__)
    jrep, jparams, jm = _fit_jax(_load_example("mnist").MnistTrial, init_np,
                                 cfg_dict, MNIST_HP, d / "jax")
    join_ranks(ranks)
    with open(d / "out.pkl", "rb") as f:
        out = pickle.load(f)
    return {"jax": jrep, "jax_params": jparams, "jax_mesh": jm, **out}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """ResNet on {dp: 2, fsdp: 2} through both trainers, and BERT on
    {fsdp: 2, tp: 2}: the JAX side, then one launch of four ranks."""
    d = tmp_path_factory.mktemp("resnet-bert-mesh")
    jcfg = jresnet.ResNetConfig(depth=26, n_classes=10, width=8,
                                compute_dtype=jnp.float32)
    init_np = jax.device_get(jax.jit(jresnet.init, static_argnums=1)(
        jax.random.PRNGKey(4), jcfg))
    cfg_dict = _config(10, 4, 10)
    bcfg = jbert.BertConfig.tiny()
    bparams = jax.device_get(jbert.init(jax.random.PRNGKey(0), bcfg))
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, 256, size=(8, 16)).astype(np.int32)
    labels = rng.randint(0, 2, size=(8,)).astype(np.int32)
    targets = rng.randint(0, 256, size=(8, 16)).astype(np.int32)
    mask = (rng.rand(8, 16) < 0.3).astype(np.float32)
    with open(d / "in.pkl", "wb") as f:
        pickle.dump({"init": init_np, "cfg": cfg_dict, "bert": bparams,
                     "tokens": tokens, "labels": labels,
                     "targets": targets, "mask": mask}, f)
    ranks = start_ranks(4, "four", d, script=__file__)
    jrep, jparams, jm = _fit_jax(_load_example("resnet50").ResNetTrial,
                                 init_np, cfg_dict, RESNET_HP, d / "jax")
    bm = jmesh.make_mesh(jmesh.MeshSpec.from_dict({"dp": 1, **BERT_MESH}),
                         jax.devices()[:4])
    placed = jsh.shard_put(bparams, jbert.BERT_SHARDING_RULES.shardings_for(
        bparams, bm))
    t, y, tg, mk = (jsh.shard_put(a, JNamedSharding(
        bm, jsh.batch_spec(a.ndim - 1))) for a in (tokens, labels, targets,
                                                    mask))
    logits = jax.jit(lambda p, t: jbert.classify(p, bcfg, t))(placed, t)
    closs, cgrads = jax.jit(jax.value_and_grad(
        lambda p, t, y: jbert.classify_loss(p, bcfg, t, y)))(placed, t, y)
    mloss, mgrads = jax.jit(jax.value_and_grad(
        lambda p, t, tg, mk: jbert.mlm_loss(p, bcfg, t, tg, mk)))(
            placed, t, tg, mk)

    def flat(tree):
        return {p: np.asarray(v) for p, v in jsh.tree_paths_and_leaves(tree)}

    bert = {"logits": np.asarray(logits), "classify_loss": float(closs),
            "classify_grads": flat(cgrads), "mlm_loss": float(mloss),
            "mlm_grads": flat(mgrads)}
    join_ranks(ranks)
    with open(d / "out.pkl", "rb") as f:
        out = pickle.load(f)
    return {"jax": jrep, "jax_params": jparams, "jax_mesh": jm,
            "bert_ref": bert, **out}


def test_mnist_on_dp2_matches_the_jax_trial(mnist):
    """BASELINE #2 cut to two ranks: the reports of ``Trainer.fit`` on
    ``{dp: 2}`` against the JAX trainer on the same mesh, and the params
    after 10 batches (within 5e-3 in relative 2-norm, the family trials'
    cross-framework bound)."""
    assert mnist["jax_mesh"]["dp"] == 2
    assert ("training", 10) in [(g, s) for g, s, _ in mnist["port"]]
    _same_reports(mnist["port"], mnist["jax"], LOSS_RTOL)
    _params_close(mnist["params"], mnist["jax_params"], 5e-3)


def test_mnist_on_dp2_with_dropout_equals_one_rank(mnist):
    """Dropout on (the yaml's 0.25/0.5): masks drawn at the global batch's
    shape, so two ranks train as one, and validation metrics are the
    global batch's."""
    _same_reports(mnist["dropout"], mnist["dropout_one"], MESH_RTOL)
    _params_close(mnist["dropout_params"], mnist["dropout_one_params"],
                  MESH_RTOL)
    assert mnist["dropout"] != mnist["port"]


def test_resnet_on_dp2_fsdp2_matches_the_jax_trial(four):
    """BASELINE #3 cut to four ranks (dp 2 × fsdp 2; ResNet-26, width 8,
    64² images): reports against the JAX trainer on the same mesh and
    against the port alone (the family trials compare ResNet's losses,
    not its params: GroupNorm's near-zero biases move by Adam's
    sign noise); the conv kernels scattered over fsdp."""
    assert four["jax_mesh"]["dp"] == 2 and four["jax_mesh"]["fsdp"] == 2
    _same_reports(four["port"], four["jax"], LOSS_RTOL)
    _same_reports(four["port"], four["alone"], MESH_RTOL)
    assert four["fsdp_sharded_leaves"] > 0


@pytest.mark.parametrize("what", ["classify", "classify_loss", "mlm_loss"])
def test_bert_on_fsdp2_tp2_matches_jax(four, what):
    """BERT under ``BERT_SHARDING_RULES`` on ``{fsdp: 2, tp: 2}``: the
    classifier's logits, and each loss with the gradient of every leaf,
    against the JAX model on the same mesh (``tests/test_models.py:233``'s
    forward)."""
    ref, got = four["bert_ref"], four["bert"]
    if what == "classify":
        np.testing.assert_allclose(got["logits"], ref["logits"],
                                   rtol=FWD_TOL, atol=FWD_TOL)
        return
    assert abs(got[what] / ref[what] - 1) <= FWD_TOL
    want = ref[what.replace("loss", "grads")]
    have = got[what.replace("loss", "grads")]
    assert set(have) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(
            have[path], w, rtol=0,
            atol=GRAD_REL * max(float(np.abs(w).max()), 1e-30),
            err_msg=path)


def test_bert_rules_match_jax():
    spec = tmesh.MeshSpec.from_dict({"dp": 1, **BERT_MESH})
    jm = jmesh.make_mesh(jmesh.MeshSpec.from_dict({"dp": 1, **BERT_MESH}),
                         jax.devices()[:4])
    shapes = jax.eval_shape(lambda k: jbert.init(k, jbert.BertConfig.tiny()),
                            jax.random.PRNGKey(0))
    for path, leaf in jsh.tree_paths_and_leaves(shapes):
        want = tuple(jbert.BERT_SHARDING_RULES.spec_for(path, leaf, jm))
        got = tbert.BERT_SHARDING_RULES.spec_for(path, leaf, spec)
        assert tuple(got) == want, path


# -- the ranks ------------------------------------------------------------------

def worker_mnist(d):
    torch.set_num_threads(1)
    ctx = launch.init_from_env("cpu")
    with open(os.path.join(d, "in.pkl"), "rb") as f:
        spec = pickle.load(f)
    T = _port_trial(tmnist.MnistTrial, spec["init"])
    cfg = spec["cfg"]
    shared = os.path.join(d, "shared")
    out = {}
    out["port"], out["params"] = _fit_port(T, cfg, MNIST_HP, shared + "-a",
                                           ctx)
    drop = {**MNIST_HP, "dropout_1": 0.25, "dropout_2": 0.5}
    out["dropout"], out["dropout_params"] = _fit_port(T, cfg, drop,
                                                      shared + "-b", ctx)
    if ctx.is_chief:   # the one-card run, on one rank
        one = {**cfg, "resources": {"slots_per_trial": 1}}
        out["dropout_one"], out["dropout_one_params"] = _fit_port(
            T, one, {**drop, "mesh": {}}, os.path.join(d, "alone"),
            mesh=None)
    if ctx.is_chief:
        with open(os.path.join(d, "out.pkl"), "wb") as f:
            pickle.dump(out, f)
    launch.shutdown()


def _assemble(local, p):
    """The global array of DTensor ``p``'s placements from every rank's
    block ``local`` (DTensor's own redistribute plans slowly on a mesh of
    six axes)."""
    idx = tsh.shard_index(p.shape, p.device_mesh, p.placements)
    parts = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(parts, (idx, local.detach().numpy()))
    out = np.empty(tuple(p.shape), parts[0][1].dtype)
    for idx, block in parts:
        out[tuple(slice(a, b) for a, b in idx)] = block
    return out


def _bert(spec):
    cfg = tbert.BertConfig.tiny()
    mesh = tmesh.make_mesh(tmesh.MeshSpec.from_dict({"dp": 1, **BERT_MESH}))
    params = convert.params_from_numpy(spec["bert"], device="cpu")
    placed = tsh.shard_put(params, tbert.BERT_SHARDING_RULES.shardings_for(
        params, mesh))
    paths, leaves = zip(*port_paths(placed))
    for p in leaves:
        local_tensor(p).requires_grad_(True)
    # dtypes set before the DTensors are made: a DTensor's ``long()`` plans
    # its sharding for tens of seconds on a mesh of six axes
    t, y, tg, mk = (tsh.to_dtensor(
        torch.from_numpy(spec[k]).to(dt), tsh.NamedSharding(
            mesh, tsh.batch_spec(spec[k].ndim - 1)))
        for k, dt in (("tokens", torch.long), ("labels", torch.long),
                      ("targets", torch.long), ("mask", torch.float32)))
    out = {}
    with torch.no_grad():
        logits = tbert.classify(placed, cfg, t)
        out["logits"] = _assemble(logits.to_local(), logits)
    sp = spmd_of(leaves[0])
    for name, loss in (
            ("classify", tbert.classify_loss(placed, cfg, t, y)),
            ("mlm", tbert.mlm_loss(placed, cfg, t, tg, mk))):
        targets = [local_tensor(p) for p in leaves]
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
            targets, torch.autograd.grad(loss, targets, allow_unused=True))]
        sp.reduce_grads(leaves, grads)
        out[f"{name}_loss"] = float(loss)
        out[f"{name}_grads"] = {path: _assemble(g, p)
                                for path, g, p in zip(paths, grads, leaves)}
    return out


def worker_four(d):
    torch.set_num_threads(1)
    ctx = launch.init_from_env("cpu")
    with open(os.path.join(d, "in.pkl"), "rb") as f:
        spec = pickle.load(f)
    T = _port_trial(tresnet.ResNetTrial, spec["init"])
    cfg = spec["cfg"]
    out = {}
    out["port"], out["params"] = _fit_port(T, cfg, RESNET_HP,
                                           os.path.join(d, "shared"), ctx)
    if ctx.is_chief:   # the one-card run, on one rank
        one = {**cfg, "resources": {"slots_per_trial": 1}}
        out["alone"], _ = _fit_port(T, one, {**RESNET_HP, "mesh": {}},
                                    os.path.join(d, "alone"), mesh=None)
    mesh = tmesh.make_mesh(tmesh.MeshSpec.from_dict(
        {"dp": 1, **RESNET_HP["mesh"]}))
    rules = tsh.ShardingRules()
    out["fsdp_sharded_leaves"] = sum(
        "fsdp" in str(rules.spec_for(p, v, mesh))
        for p, v in port_paths(spec["init"]))
    out["bert"] = _bert(spec)
    if ctx.is_chief:
        with open(os.path.join(d, "out.pkl"), "wb") as f:
            pickle.dump(out, f)
    launch.shutdown()


WORKERS = {"mnist": worker_mnist, "four": worker_four}

if __name__ == "__main__":
    WORKERS[sys.argv[1]](sys.argv[2])
