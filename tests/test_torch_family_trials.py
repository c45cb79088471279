"""The port's family trials held against the JAX package's examples on
the CPU: ``MnistTrial`` and ``ResNetTrial`` through both packages'
``Trainer.fit`` from the same initial parameters, checkpoints that move
between the two trainers, the BERT fine-tune's Core API ``main`` in both
packages from one ``state.pkl``, and the data the trials read.

Tolerances, fp32 with dropout off: reported losses within 1e-3 relative
(the GPT trial's parity bound in ``tests/test_torch_trainer.py``; each
package sums its products in another order); validation accuracies
equal. Params after 20 Adam steps are compared leaf by leaf in relative
2-norm: within 5e-3 across frameworks (measured 1.7e-3: Adam moves an
element by about the learning rate whatever its gradient's size, so an
element whose tiny gradient rounding sends another way — a ReLU input
near 0 — ends a few steps apart; 0.4% of the mnist ``fc1`` elements
do, in the first steps), and within 1e-6 of the unbroken run of the
framework that trained the leg before the checkpoint: the checkpoint
carries the state across whole, and the other framework's leg after it
adds only rounding (measured 1.6e-8).

The ResNet trial runs at 64×64 and lr 1e-4: at 32×32 its last stage is
1×1, GroupNorm normalises 2 values per group, the gradient norm is
~6700, and at lr 1e-3 a 1e-5 difference in the first step grows to 1%
of the loss by the fifth in either framework alone (chaotic, not a
port error); at 64×64 and lr 1e-4 the losses agree within 1e-5.
"""
import dataclasses
import gzip
import importlib.util
import os
import pickle
import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_clone_tpu import core as jcore
from determined_clone_tpu.config import ExperimentConfig as JConfig
from determined_clone_tpu.exec.trial import ClusterInfo as JClusterInfo
from determined_clone_tpu.models import bert as jbert
from determined_clone_tpu.models import mnist_cnn as jmnist
from determined_clone_tpu.models import resnet as jresnet
from determined_clone_tpu.parallel import MeshSpec, make_mesh
from determined_clone_tpu.training import Trainer as JTrainer
from determined_clone_tpu.training import TrialContext as JContext
from determined_clone_tpu.utils import data as jdata
from determined_clone_tpu_torch import convert
from determined_clone_tpu_torch import core as tcore
from determined_clone_tpu_torch.config import ExperimentConfig as TConfig
from determined_clone_tpu_torch.examples import bert_finetune as tbert_ft
from determined_clone_tpu_torch.examples import mnist as tmnist_trial
from determined_clone_tpu_torch.examples import resnet50 as tresnet_trial
from determined_clone_tpu_torch.exec.trial import ClusterInfo as TClusterInfo
from determined_clone_tpu_torch.models import bert as tbert
from determined_clone_tpu_torch.training import Trainer as TTrainer
from determined_clone_tpu_torch.training import TrialContext as TContext
from determined_clone_tpu_torch.utils import data as tdata

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")
LOSS_RTOL = 1e-3


def _load_example(subdir, filename):
    path = os.path.join(EXAMPLES, subdir, filename)
    spec = importlib.util.spec_from_file_location(
        f"{subdir}_{filename[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


# -- both trainers -------------------------------------------------------------

def _config(path, batches, su=5, **extra):
    return {"searcher": {"name": "single", "metric": "loss",
                         "max_length": {"batches": batches}},
            "scheduling_unit": su,
            "checkpoint_storage": {"type": "shared_fs",
                                   "host_path": str(path)},
            **extra}


@dataclasses.dataclass
class Run:
    result: dict
    records: list
    params: dict        # final params as numpy, by tree path
    checkpoints: list


def _run(side, trial_cls, cfg_dict, hparams, latest=None) -> Run:
    jax_side = side == "jax"
    cfg = (JConfig if jax_side else TConfig).from_dict(cfg_dict)
    mod = jcore if jax_side else tcore
    with mod.init(config=cfg, trial_id=1) as ctx:
        if jax_side:
            trainer = JTrainer(trial_cls(JContext(
                config=cfg, hparams=hparams, core=ctx,
                mesh=make_mesh(MeshSpec(dp=1), jax.devices()[:1]))))
        else:
            trainer = TTrainer(trial_cls(TContext(
                config=cfg, hparams=hparams, core=ctx, device="cpu")))
        result = trainer.fit(latest_checkpoint=latest)
        records = list(ctx.train._backend.records)
    params = {k: np.asarray(v) if jax_side else v.detach().numpy()
              for k, v in _flat(trainer._final_state.params).items()}
    ckpts = mod.LocalCheckpointRegistry(os.path.join(
        cfg_dict["checkpoint_storage"]["host_path"],
        "checkpoints.jsonl")).list()
    return Run(result, records, params, ckpts)


def _reports(run, group):
    return [(r["steps_completed"], r["metrics"]) for r in run.records
            if r["group"] == group]


def _assert_same_losses(j, t):
    for group in ("training", "validation"):
        rj, rt = _reports(j, group), _reports(t, group)
        assert [s for s, _ in rj] == [s for s, _ in rt], group
        for (s, mj), (_, mt) in zip(rj, rt):
            assert abs(mt["loss"] / mj["loss"] - 1) <= LOSS_RTOL, (
                group, s, mj, mt)
            if "accuracy" in mj:
                assert mt["accuracy"] == mj["accuracy"], (group, s, mj, mt)


def _assert_params_close(got, want, rel_l2):
    """Each leaf within ``rel_l2`` of ``want``'s, in relative 2-norm."""
    assert set(got) == set(want)
    for path in want:
        dist = np.linalg.norm(got[path] - want[path])
        assert dist <= rel_l2 * np.linalg.norm(want[path]), (
            path, dist / np.linalg.norm(want[path]))


def _trial_pair(jcls, tcls, init_np, t_dtype=None, j_dtype=None):
    """The two trials, started from the same numpy params; with dtypes,
    each trial's model config computes in them."""

    class J(jcls):
        def __init__(self, context):
            super().__init__(context)
            if j_dtype is not None:
                self.cfg = dataclasses.replace(self.cfg, compute_dtype=j_dtype)

        def initial_params(self, rng):
            return jax.tree.map(jnp.asarray, init_np)

    class T(tcls):
        def __init__(self, context):
            super().__init__(context)
            if t_dtype is not None:
                self.cfg = dataclasses.replace(self.cfg, compute_dtype=t_dtype)

        def initial_params(self, gen):
            return convert.params_from_numpy(init_np, self.context.device)

    return J, T


MNIST_HP = {"global_batch_size": 16, "lr": 1e-3, "n_filters_1": 4,
            "n_filters_2": 8, "dropout_1": 0.0, "dropout_2": 0.0,
            "dataset": "digits"}


@pytest.fixture(scope="module")
def mnist_pair():
    jmod = _load_example("mnist", "model_def.py")
    cfg = jmnist.MnistCNNConfig(n_filters_1=4, n_filters_2=8)
    init_np = jax.device_get(jmnist.init(jax.random.PRNGKey(3), cfg))
    return _trial_pair(jmod.MnistTrial, tmnist_trial.MnistTrial, init_np)


@pytest.fixture(scope="module")
def mnist_whole(mnist_pair, tmp_path_factory):
    """20 batches unbroken in each trainer."""
    J, T = mnist_pair
    base = tmp_path_factory.mktemp("mnist-whole")
    return {side: _run(side, cls, _config(base / side, 20,
                                          min_validation_period={
                                              "batches": 10}), MNIST_HP)
            for side, cls in (("jax", J), ("port", T))}


def test_mnist_trial_through_both_trainers(mnist_whole):
    j, t = mnist_whole["jax"], mnist_whole["port"]
    assert j.result["batches_trained"] == t.result["batches_trained"] == 20
    assert [s for s, _ in _reports(t, "training")] == [5, 10, 15, 20]
    _assert_same_losses(j, t)
    losses = [m["loss"] for _, m in _reports(t, "training")]
    assert losses[-1] < losses[0]
    _assert_params_close(t.params, j.params, 5e-3)


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_mnist_checkpoint_moves_between_trainers(mnist_pair, mnist_whole,
                                                 tmp_path, first, second):
    """10 batches in one trainer, restored from its checkpoint in the
    other and trained to 20: the params end where either unbroken run
    ends, and the resumed reports are the unbroken run's."""
    J, T = mnist_pair
    trials = {"jax": J, "port": T}
    cfg = _config(tmp_path, 10, min_validation_period={"batches": 10})
    a = _run(first, trials[first], cfg, MNIST_HP)
    assert a.checkpoints[-1]["metadata"]["steps_completed"] == 10
    cfg["searcher"]["max_length"] = {"batches": 20}
    b = _run(second, trials[second], cfg, MNIST_HP,
             latest=a.checkpoints[-1]["storage_id"])
    assert b.result["batches_trained"] == 20
    assert [s for s, _ in _reports(b, "training")] == [15, 20]
    for side in ("jax", "port"):
        _assert_params_close(b.params, mnist_whole[side].params,
                             1e-6 if side == first else 5e-3)
        late = [r for r in _reports(mnist_whole[side], "training")
                if r[0] > 10]
        for (s, m), (s2, m2) in zip(late, _reports(b, "training")):
            assert s == s2 and abs(m2["loss"] / m["loss"] - 1) <= LOSS_RTOL


RESNET_HP = {"global_batch_size": 4, "lr": 1e-4, "depth": 26, "width": 8,
             "n_classes": 10, "image_size": 64, "n_train": 32}


def test_resnet_trial_through_both_trainers(tmp_path):
    jmod = _load_example("resnet50", "model_def.py")
    jcfg = jresnet.ResNetConfig(depth=26, n_classes=10, width=8,
                                compute_dtype=jnp.float32)
    init_np = jax.device_get(jax.jit(jresnet.init, static_argnums=1)(
        jax.random.PRNGKey(4), jcfg))
    J, T = _trial_pair(jmod.ResNetTrial, tresnet_trial.ResNetTrial, init_np,
                       t_dtype=torch.float32, j_dtype=jnp.float32)
    runs = {side: _run(side, cls, _config(tmp_path / side, 10,
                                          checkpoint_policy="none"),
                       RESNET_HP)
            for side, cls in (("jax", J), ("port", T))}
    j, t = runs["jax"], runs["port"]
    assert [s for s, _ in _reports(t, "training")] == [5, 10]
    _assert_same_losses(j, t)
    # the same synthetic batches in both trials
    hosts = []
    for mod, cls in ((jmod, jmod.ResNetTrial),
                     (tresnet_trial, tresnet_trial.ResNetTrial)):
        trial = object.__new__(cls)
        trial.cfg, trial.image_size, trial.n_train = jcfg, 64, 32
        trial.context = types.SimpleNamespace(
            get_hparam=lambda k, d=None: RESNET_HP.get(k, d))
        hosts.append(next(iter(trial.training_data())))
    for a, b in zip(*hosts):
        np.testing.assert_array_equal(a, b)


def test_trials_take_a_mesh_and_need_the_card(tmp_path):
    """The trials accept ``distributed.yaml``'s meshes (their parity on
    gloo ranks is ``tests/test_torch_family_mesh.py``); the trial's loss,
    through ``replicated_program`` with no mesh, is the JAX model's on
    the same params and batch; the card is the default device."""
    cfg = TConfig.from_dict({})
    with tcore.init(config=cfg, storage_path=str(tmp_path)) as ctx:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                TContext(config=cfg, hparams=RESNET_HP, core=ctx)
            with pytest.raises(RuntimeError, match="device='cpu'"):
                tbert_ft.main(ctx, types.SimpleNamespace(
                    hparams={}, latest_checkpoint=None))
        meshed = tresnet_trial.ResNetTrial(TContext(
            config=cfg, hparams={**RESNET_HP,
                                 "mesh": {"dp": 4, "fsdp": 2}},
            core=ctx, device="cpu"))
        assert meshed.cfg.depth == RESNET_HP["depth"]
        trial = tresnet_trial.ResNetTrial(TContext(
            config=cfg, hparams={**RESNET_HP, "mesh": {"dp": 1}}, core=ctx,
            device="cpu"))
        assert trial.cfg.compute_dtype == torch.bfloat16  # the default
        mt = tmnist_trial.MnistTrial(TContext(
            config=cfg, hparams={**MNIST_HP, "mesh": {"dp": 8}}, core=ctx,
            device="cpu"))
        assert mt.global_batch_size == 16
        default = tmnist_trial.MnistTrial(TContext(config=cfg, hparams={},
                                                   core=ctx, device="cpu"))
        assert (default.cfg.n_filters_1, default.cfg.n_filters_2,
                default.cfg.dropout_1, default.cfg.dropout_2) == (
                    32, 64, 0.25, 0.5)
        assert default.global_batch_size == 32
    jcfg = jmnist.MnistCNNConfig(n_filters_1=4, n_filters_2=8)
    init_np = jax.device_get(jmnist.init(jax.random.PRNGKey(3), jcfg))
    x, y = next(iter(mt.training_data()))
    want = float(jmnist.loss_fn(init_np, jcfg, jnp.asarray(x),
                                jnp.asarray(y)))
    got, _ = mt.loss(convert.params_from_numpy(init_np, "cpu"),
                     (torch.from_numpy(x), torch.from_numpy(y)), 0)
    assert abs(float(got) / want - 1) <= 1e-5


# -- BERT fine-tune through the Core API -----------------------------------------

BERT_HP = {"global_batch_size": 8, "lr": 1e-3, "vocab_size": 1000,
           "n_layers": 2, "d_model": 32, "n_heads": 2, "d_ff": 64,
           "seq_len": 32}


def _bert_main(side, storage, batches, latest):
    jax_side = side == "jax"
    cfg = (JConfig if jax_side else TConfig).from_dict(_config(
        storage, batches))
    info = types.SimpleNamespace(hparams=BERT_HP, latest_checkpoint=latest)
    with (jcore if jax_side else tcore).init(config=cfg, trial_id=1) as ctx:
        if jax_side:
            result = _load_example("bert_finetune", "train_bert.py").main(
                ctx, info)
        else:
            result = tbert_ft.main(ctx, info, device="cpu")
        records = list(ctx.train._backend.records)
    ckpts = tcore.LocalCheckpointRegistry(
        os.path.join(storage, "checkpoints.jsonl")).list()
    return result, records, ckpts[-1]["storage_id"]


def _read_state(storage, storage_id):
    with open(os.path.join(storage, storage_id, "state.pkl"), "rb") as f:
        return pickle.load(f)


def test_bert_main_matches_jax_and_checkpoints_cross(tmp_path):
    """Both mains from one JAX ``bert.init`` written as ``state.pkl`` at
    step 0: the same training losses at 10 and 20 and the same validation
    accuracy; then each resumes the other's ``state.pkl`` at 20 and trains
    to 30, reporting the same loss."""
    storage = str(tmp_path)
    jcfg = jbert.BertConfig(vocab_size=1000, n_layers=2, d_model=32,
                            n_heads=2, d_ff=64, max_seq_len=32,
                            compute_dtype=jnp.float32, remat=False)
    init_np = jax.device_get(jbert.init(jax.random.PRNGKey(0), jcfg))
    with tcore.init(config=TConfig.from_dict(_config(storage, 1))) as ctx:
        d = tmp_path / "init"
        d.mkdir()
        with open(d / "state.pkl", "wb") as f:
            pickle.dump(init_np, f)
        start = ctx.checkpoint.upload(str(d),
                                      metadata={"steps_completed": 0})
    out = {side: _bert_main(side, storage, 20, start)
           for side in ("jax", "port")}
    (jres, jrec, jckpt), (tres, trec, tckpt) = out["jax"], out["port"]
    assert jres == tres == {"state": "completed", "batches": 20}
    for group in ("training", "validation"):
        rj = [(r["steps_completed"], r["metrics"]) for r in jrec
              if r["group"] == group]
        rt = [(r["steps_completed"], r["metrics"]) for r in trec
              if r["group"] == group]
        assert [s for s, _ in rt] == [s for s, _ in rj] == (
            [10, 20] if group == "training" else [20])
        for (_, mj), (_, mt) in zip(rj, rt):
            assert abs(mt["loss"] / mj["loss"] - 1) <= LOSS_RTOL, (mj, mt)
            if "accuracy" in mj:
                assert mt["accuracy"] == mj["accuracy"]
    # the port's checkpoint: numpy fp32 under bert.init's tree, no torch
    saved = _read_state(storage, tckpt)
    assert {p: (a.shape, a.dtype) for p, a in _flat(saved).items()} == {
        p: (a.shape, np.dtype(np.float32)) for p, a in _flat(init_np).items()}
    assert all(type(a) is np.ndarray for a in _flat(saved).values())
    tbert_params = convert.params_from_numpy(saved, "cpu")
    assert tbert.param_count(tbert_params) == jbert.param_count(init_np)
    # each resumes the other's checkpoint
    resumed = {"jax": _bert_main("jax", storage, 30, tckpt),
               "port": _bert_main("port", storage, 30, jckpt)}
    losses = {}
    for side, (res, rec, _) in resumed.items():
        assert res == {"state": "completed", "batches": 30}
        train = [(r["steps_completed"], r["metrics"]["loss"]) for r in rec
                 if r["group"] == "training"]
        assert [s for s, _ in train] == [30]
        losses[side] = train[0][1]
    assert abs(losses["port"] / losses["jax"] - 1) <= LOSS_RTOL


def test_bert_main_preempts_and_resumes(tmp_path):
    """A preemption flag: the port's main saves at its first batch and
    returns ``preempted``; a second main resumes from that checkpoint."""
    storage = str(tmp_path)
    flag = tmp_path / "flag"
    flag.write_text("")
    cfg = TConfig.from_dict(_config(storage, 12))
    info = types.SimpleNamespace(hparams=BERT_HP, latest_checkpoint=None)
    with tcore.init(config=cfg, trial_id=1,
                    preemption_source=tcore.FilePreemptionSource(
                        str(flag))) as ctx:
        while not ctx.preempt.should_preempt():
            pass
        res = tbert_ft.main(ctx, info, device="cpu")
    assert res == {"state": "preempted", "batches": 1}
    ckpt = tcore.LocalCheckpointRegistry(
        os.path.join(storage, "checkpoints.jsonl")).list()[-1]
    assert ckpt["metadata"]["steps_completed"] == 1
    res, rec, _ = _bert_main("port", storage, 12, ckpt["storage_id"])
    assert res == {"state": "completed", "batches": 12}
    assert [r["steps_completed"] for r in rec
            if r["group"] == "training"] == [10]


def test_bert_config_dtype_follows_the_device():
    assert tbert_ft.config_from_hparams(
        BERT_HP, "cpu").compute_dtype == torch.float32
    if torch.cuda.is_available():
        assert tbert_ft.config_from_hparams(
            BERT_HP, "cuda").compute_dtype == torch.bfloat16


# -- data and cluster info -----------------------------------------------------

@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("image", [True, False])
def test_digits_dataset_equals_jax(split, image):
    jx, jy = jdata.digits_dataset(split, image=image)
    tx, ty = tdata.digits_dataset(split, image=image)
    assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
    assert tx.dtype == jx.dtype and ty.dtype == jy.dtype


def test_digits_dataset_needs_no_scikit_learn(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "sklearn", None)  # import fails
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    x, y = tdata.digits_dataset("train")
    assert x.shape == (1437, 784) and set(np.unique(y)) == set(range(10))


def _write_idx(path, arr, gz):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        f">{arr.ndim}I", *arr.shape)
    opener = gzip.open if gz else open
    with opener(str(path) + (".gz" if gz else ""), "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_idx_files_read_as_jax(tmp_path, gz):
    rng = np.random.RandomState(0)
    for prefix, n in (("train", 12), ("t10k", 5)):
        _write_idx(tmp_path / f"{prefix}-images-idx3-ubyte",
                   rng.randint(0, 256, size=(n, 28, 28)), gz)
        _write_idx(tmp_path / f"{prefix}-labels-idx1-ubyte",
                   rng.randint(0, 10, size=(n,)), gz)
    for split in ("train", "test"):
        for image in (True, False):
            jx, jy = jdata.load_mnist_idx(str(tmp_path), split, image)
            tx, ty = tdata.load_mnist_idx(str(tmp_path), split, image)
            assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
            mx, my = tdata.mnist_dataset(str(tmp_path), split, image)
            assert np.array_equal(mx, jx) and np.array_equal(my, jy)
    # without IDX files, the synthetic stand-in, as in the JAX package
    sx, sy = tdata.mnist_dataset(str(tmp_path / "none"), "test")
    jx, jy = jdata.mnist_dataset(str(tmp_path / "none"), "test")
    assert np.array_equal(sx, jx) and np.array_equal(sy, jy)


def test_cluster_info_from_env_matches_jax(monkeypatch):
    env = {"DCT_ALLOCATION_ID": "alloc-1", "DCT_TRIAL_ID": "7",
           "DCT_RANK": "0", "DCT_HPARAMS": '{"lr": 0.1}',
           "DCT_LATEST_CHECKPOINT": "abc",
           "DCT_EXPERIMENT_CONFIG": '{"name": "x"}'}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dataclasses.asdict(TClusterInfo.from_env()) == dataclasses.asdict(
        JClusterInfo.from_env())
    monkeypatch.delenv("DCT_TRIAL_ID")
    with pytest.raises(RuntimeError, match="DCT_TRIAL_ID"):
        TClusterInfo.from_env()
