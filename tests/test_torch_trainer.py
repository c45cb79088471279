"""The port's Trainer held against the JAX Trainer on the CPU: the same
trials, written once for each package, through both loops with the same
configs, and checkpoints that move between the two.

Tolerances, fp32: reported metrics within 1e-6 (the same arithmetic in
each package's kernels, summed in another order); params after a run
that changed framework at a checkpoint within 1e-5 relative of the run
that did not (each step of Adam rounds in fp32 in both). The tiny GPT's
per-chunk losses within 1e-3 relative with fp32 compute, and within the
2% of ``test_six_step_curves_match_jax`` (``tests/test_torch_training.py``)
in bf16, where the frameworks round activations at different places.
"""
import contextlib
import dataclasses
import importlib.util
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from determined_clone_tpu import core as jcore
from determined_clone_tpu.config import ExperimentConfig as JConfig
from determined_clone_tpu.models import gpt as jgpt
from determined_clone_tpu.parallel import MeshSpec, make_mesh
from determined_clone_tpu.training import JaxTrial
from determined_clone_tpu.training import Trainer as JTrainer
from determined_clone_tpu.training import TrialContext as JContext
from determined_clone_tpu.utils.data import batch_iterator as jbatches
from determined_clone_tpu_torch import convert
from determined_clone_tpu_torch import core as tcore
from determined_clone_tpu_torch.config import ExperimentConfig as TConfig
from determined_clone_tpu_torch.examples import gpt_fsdp as tgpt_trial
from determined_clone_tpu_torch.models import gpt as tgpt
from determined_clone_tpu_torch.training import TorchTrial
from determined_clone_tpu_torch.training import Trainer as TTrainer
from determined_clone_tpu_torch.training import TrialContext as TContext
from determined_clone_tpu_torch.training import optim
from determined_clone_tpu_torch.utils.data import batch_iterator as tbatches

torch.set_num_threads(1)

TIMING = ("batches_per_second", "samples_per_second")


# -- trials, one per package ----------------------------------------------

class JOneVar(JaxTrial):
    """loss = (w - 3)^2 (the JAX trainer tests' OneVarTrial)."""

    def initial_params(self, rng):
        return {"w": jnp.zeros(())}

    def optimizer(self):
        return optax.sgd(self.context.get_hparam("lr", 0.1))

    def loss(self, params, batch, rng):
        return (params["w"] - 3.0) ** 2, {"w": params["w"]}

    def training_data(self):
        for _ in range(64):
            yield np.zeros((4, 1), np.float32)

    def validation_data(self):
        return [np.zeros((4, 1), np.float32)]

    @property
    def global_batch_size(self):
        return 4


class TOneVar(TorchTrial):
    def initial_params(self, gen):
        return {"w": torch.zeros((), device=self.context.device)}

    def optimizer(self):
        return optim.sgd(self.context.get_hparam("lr", 0.1))

    def loss(self, params, batch, seed):
        return (params["w"] - 3.0) ** 2, {"w": params["w"]}

    training_data = JOneVar.training_data
    validation_data = JOneVar.validation_data
    global_batch_size = JOneVar.global_batch_size


def _regression_data():
    """Examples x [96, 4] with their index as a fifth column, targets y,
    and the initial params."""
    rng = np.random.RandomState(0)
    x = rng.normal(size=(96, 4)).astype(np.float32)
    y = (x @ np.array([1.0, -2.0, 0.5, 3.0], np.float32) + 0.7
         + 0.1 * rng.normal(size=96)).astype(np.float32)
    xi = np.concatenate([x, np.arange(96, dtype=np.float32)[:, None]], 1)
    return xi, y, {"w": np.array([0.3, 0.1, -0.2, 0.05], np.float32),
                   "b": np.float32(0.0)}


class JRegression(JaxTrial):
    """Linear regression under chain(clip_by_global_norm, adamw(linear
    schedule)): the optimizer state has the ``1/1/0/.mu`` and
    ``1/1/2/.count`` leaves. No randomness, so a run may change framework
    at a checkpoint and continue the same trajectory. 12 shuffled batches
    an epoch (``BatchIterator``, so a restore skips by arithmetic), each
    carrying its examples' indices: ``idx0`` reports the first one's."""

    def __init__(self, context):
        super().__init__(context)
        self.x, self.y, self.p0 = _regression_data()

    def initial_params(self, rng):
        return jax.tree.map(jnp.asarray, self.p0)

    def optimizer(self):
        return optax.chain(
            optax.clip_by_global_norm(1.0),
            optax.adamw(optax.linear_schedule(0.05, 0.005, 40), b1=0.9,
                        b2=0.95, weight_decay=0.01))

    def loss(self, params, batch, rng):
        xi, y = batch
        err = xi[:, :4] @ params["w"] + params["b"] - y
        return jnp.mean(err ** 2), {"idx0": xi[0, 4]}

    def training_data(self):
        return jbatches(self.x, self.y, self.global_batch_size, seed=3)

    def validation_data(self):
        return [(self.x[:8], self.y[:8])]

    @property
    def global_batch_size(self):
        return int(self.context.get_hparam("global_batch_size", 8))


class TRegression(TorchTrial):
    def __init__(self, context):
        super().__init__(context)
        self.x, self.y, self.p0 = _regression_data()

    def initial_params(self, gen):
        return {k: torch.tensor(v, device=self.context.device)
                for k, v in self.p0.items()}

    def optimizer(self):
        return optim.chain(
            optim.clip_by_global_norm(1.0),
            optim.adamw(optim.linear_schedule(0.05, 0.005, 40), b1=0.9,
                        b2=0.95, weight_decay=0.01))

    def loss(self, params, batch, seed):
        xi, y = batch
        err = xi[:, :4] @ params["w"] + params["b"] - y
        return torch.mean(err ** 2), {"idx0": xi[0, 4]}

    def training_data(self):
        return tbatches(self.x, self.y, self.global_batch_size, seed=3)

    validation_data = JRegression.validation_data
    global_batch_size = JRegression.global_batch_size


# -- running a trial through either trainer --------------------------------

def _config(tmp_path, batches, su=10, **extra):
    return {"searcher": {"name": "single", "metric": "loss",
                         "max_length": {"batches": batches}},
            "scheduling_unit": su,
            "checkpoint_storage": {"type": "shared_fs",
                                   "host_path": str(tmp_path)},
            **extra}


@dataclasses.dataclass
class Run:
    result: dict
    records: list
    params: dict        # final params as numpy, by name
    trainer: object
    checkpoints: list   # registry records, oldest first
    searcher: object


def _await_preemption(ctx, timeout=10.0):
    """Wait until the preemption watcher has seen the flag, so the run
    stops at its first chunk boundary however loaded the machine is."""
    deadline = time.monotonic() + timeout
    while not ctx.preempt.should_preempt():
        assert time.monotonic() < deadline, "the watcher never saw the flag"
        time.sleep(0.01)


def _run(side, trial_cls, cfg_dict, tmp_path, *, hparams=None,
         latest=None, preemption_source=None) -> Run:
    """One ``fit`` of ``trial_cls`` through the JAX (``side="jax"``) or the
    port's trainer, with the searcher source kept for its metrics; with a
    preemption source whose flag is set, the fit starts once it is seen."""
    jax_side = side == "jax"
    cfg = (JConfig if jax_side else TConfig).from_dict(cfg_dict)
    mod = jcore if jax_side else tcore
    src = mod.LocalSearcherSource(cfg.searcher.max_length)
    with mod.init(config=cfg, trial_id=1, searcher_source=src,
                  preemption_source=preemption_source) as ctx:
        if jax_side:
            tctx = JContext(config=cfg, hparams=hparams or {}, core=ctx,
                            mesh=make_mesh(MeshSpec(dp=1),
                                           jax.devices()[:1]))
            trainer = JTrainer(trial_cls(tctx))
        else:
            tctx = TContext(config=cfg, hparams=hparams or {}, core=ctx,
                            device="cpu")
            trainer = TTrainer(trial_cls(tctx))
        if preemption_source is not None:
            _await_preemption(ctx)
        result = trainer.fit(latest_checkpoint=latest)
        records = list(ctx.train._backend.records)
    params = trainer._final_state.params
    params = {k: np.asarray(v) if jax_side else v.detach().numpy()
              for k, v in _flat(params).items()}
    ckpts = mod.LocalCheckpointRegistry(
        os.path.join(cfg_dict["checkpoint_storage"]["host_path"],
                     "checkpoints.jsonl")).list()
    return Run(result, records, params, trainer, ckpts, src)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _reports(run, group):
    return [(r["steps_completed"], {k: v for k, v in r["metrics"].items()
                                    if k not in TIMING})
            for r in run.records if r["group"] == group]


def _assert_same_reports(a, b, tol=1e-6, groups=("training", "validation")):
    for group in groups:
        ra, rb = _reports(a, group), _reports(b, group)
        assert [s for s, _ in ra] == [s for s, _ in rb], group
        for (s, ma), (_, mb) in zip(ra, rb):
            assert set(ma) == set(mb), (group, s)
            for k in ma:
                assert abs(ma[k] - mb[k]) <= tol * max(1.0, abs(ma[k])), (
                    group, s, k, ma[k], mb[k])


def _meta(run):
    return [(c["metadata"]["steps_completed"], c["metadata"]["reason"])
            for c in run.checkpoints]


# -- the loop, through both trainers ----------------------------------------

def test_onevar_reports_checkpoints_and_searcher_match_jax(tmp_path):
    cfg = _config(tmp_path / "j", 30, min_validation_period={"batches": 10},
                  min_checkpoint_period={"batches": 10})
    j = _run("jax", JOneVar, cfg, tmp_path)
    cfg["checkpoint_storage"]["host_path"] = str(tmp_path / "t")
    t = _run("port", TOneVar, cfg, tmp_path)
    assert j.result["batches_trained"] == t.result["batches_trained"] == 30
    assert len(_reports(t, "training")) == 3
    _assert_same_reports(j, t)
    assert _meta(j) == _meta(t) and (30, "best") in _meta(t)
    for run in (j, t):
        rec = [r for r in run.records if r["group"] == "training"][0]
        assert rec["metrics"]["samples_per_second"] > 0
    assert abs(t.params["w"] - 3.0) < 0.1
    assert abs(t.params["w"] - j.params["w"]) <= 1e-6
    assert len(t.searcher.completed_metrics) == 1
    assert abs(j.searcher.completed_metrics[0]
               - t.searcher.completed_metrics[0]) <= 1e-6
    assert (j.result["best_validation"] is not None and abs(
        j.result["best_validation"] - t.result["best_validation"]) <= 1e-6)


def test_preemption_saves_and_exits_like_jax(tmp_path):
    flag = tmp_path / "flag"
    flag.write_text("")  # preempt at the first chunk boundary
    runs = {}
    for side, trial in (("jax", JOneVar), ("port", TOneVar)):
        mod = jcore if side == "jax" else tcore
        cfg = _config(tmp_path / side, 1000, su=5)
        runs[side] = _run(side, trial, cfg, tmp_path,
                          preemption_source=mod.FilePreemptionSource(
                              str(flag)))
    j, t = runs["jax"], runs["port"]
    assert t.result["preempted"] and j.result["preempted"]
    assert t.result["batches_trained"] == j.result["batches_trained"] == 5
    assert _meta(t) == _meta(j) == [(5, "preemption")]
    assert [r["metrics"] for r in t.records if r["group"] == "early_exit"] \
        == [{"reason": "preempted"}]
    _assert_same_reports(j, t)
    assert t.searcher.completed_metrics == []


@pytest.mark.parametrize("side", ["jax", "port"])
def test_restore_continues_20_to_40(tmp_path, side):
    trial = JOneVar if side == "jax" else TOneVar
    cfg = _config(tmp_path, 20)
    first = _run(side, trial, cfg, tmp_path)
    assert _meta(first) == [(20, "final")]
    cfg["searcher"]["max_length"] = {"batches": 40}
    second = _run(side, trial, cfg, tmp_path,
                  latest=first.checkpoints[-1]["storage_id"])
    assert second.result["batches_trained"] == 40
    assert [s for s, _ in _reports(second, "training")] == [30, 40]
    assert abs(second.params["w"] - 3.0) < abs(first.params["w"] - 3.0)
    whole = _run(side, trial, _config(tmp_path / "whole", 40), tmp_path)
    assert abs(second.params["w"] - whole.params["w"]) <= 1e-6


def _relative(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_checkpoint_moves_between_frameworks(tmp_path, first, second):
    """20 batches in one trainer, then a restore from its checkpoint in the
    other, to 40: the params end where a run that never changed framework
    ends, within 1e-5 relative."""
    trials = {"jax": JRegression, "port": TRegression}
    cfg = _config(tmp_path / "shared", 20,
                  min_validation_period={"batches": 10})
    a = _run(first, trials[first], cfg, tmp_path)
    assert [p for p, _ in _meta(a)] == [10, 20]  # best at 10 and at 20
    cfg["searcher"]["max_length"] = {"batches": 40}
    b = _run(second, trials[second], cfg, tmp_path,
             latest=a.checkpoints[-1]["storage_id"])
    assert b.result["batches_trained"] == 40
    assert [s for s, _ in _reports(b, "training")] == [30, 40]
    for side in ("jax", "port"):
        whole = _run(side, trials[side],
                     _config(tmp_path / f"whole-{side}", 40,
                             min_validation_period={"batches": 10}),
                     tmp_path)
        assert set(whole.params) == set(b.params) == {"w", "b"}
        for k in whole.params:
            assert _relative(b.params[k], whole.params[k]).max() <= 1e-5, (
                side, k, b.params[k], whole.params[k])
        # the resumed leg reports what the unbroken run reports after 20
        late = [r for r in _reports(whole, "training") if r[0] > 20]
        for (s, m), (s2, m2) in zip(late, _reports(b, "training")):
            assert s == s2 and m["idx0"] == m2["idx0"]
            assert abs(m["loss"] - m2["loss"]) <= 1e-5 * max(1, m["loss"])


def test_replay_trains_the_same_next_batch(tmp_path):
    """12 batches an epoch, a restore at 20 (inside the second epoch): each
    trainer replays 20 batches (the BatchIterator skips by arithmetic and
    rolls into the next epoch) and trains batch 21 next, batch by batch
    (scheduling_unit 1) equal to the unbroken run's."""
    host = list(tbatches(*_regression_data()[:2], 8, seed=3))
    stream = host + host + host + host
    for side, trial in (("jax", JRegression), ("port", TRegression)):
        cfg = _config(tmp_path / side, 20, su=1)
        a = _run(side, trial, cfg, tmp_path)
        cfg["searcher"]["max_length"] = {"batches": 27}
        b = _run(side, trial, cfg, tmp_path,
                 latest=a.checkpoints[-1]["storage_id"])
        idx = [(s, m["idx0"]) for s, m in _reports(b, "training")]
        assert idx == [(s, float(stream[s - 1][0][0, 4]))
                       for s in range(21, 28)], side
        whole = _run(side, trial, _config(tmp_path / f"{side}-whole", 27,
                                          su=1), tmp_path)
        assert [(s, m["idx0"]) for s, m in _reports(whole, "training")
                if s > 20] == idx


def test_fused_dispatch_with_remainders_equals_single_steps(tmp_path):
    """steps_per_dispatch=3 with 10-batch chunks: 3 fused calls and one
    single step per chunk, the same state and reports as k=1."""
    runs = {}
    for side, trial, k in (("port", TRegression, 1), ("port", TRegression, 3),
                           ("jax", JRegression, 3)):
        cfg = _config(tmp_path / f"{side}{k}", 20,
                      optimizations={"steps_per_dispatch": k})
        runs[side, k] = _run(side, trial, cfg, tmp_path)
    one, fused, jfused = runs["port", 1], runs["port", 3], runs["jax", 3]
    for key in one.params:
        np.testing.assert_array_equal(fused.params[key], one.params[key])
    state = fused.trainer._final_state
    assert state.step == 20 and state.opt_state[1][0].count == 20
    assert state.opt_state[1][2].count == 20
    # the chunk's sums associate differently (fused calls sum k at once)
    _assert_same_reports(one, fused, tol=1e-6)
    _assert_same_reports(jfused, fused, tol=1e-5)


# -- the GPT example trial ---------------------------------------------------

def _jax_gpt_trial_cls():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "gpt_fsdp", "model_def.py")
    spec = importlib.util.spec_from_file_location("gpt_fsdp_model_def", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GPTTrial


GPT_HP = {"global_batch_size": 4, "vocab_size": 256, "n_layers": 2,
          "d_model": 64, "n_heads": 4, "d_ff": 128, "seq_len": 32,
          "remat": False, "attention_impl": "mha", "lr": 3e-3,
          "n_train_tokens": 3000}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3),
                                       ("bfloat16", 0.02)])
def test_tiny_gpt_trial_through_both_trainers(tmp_path, dtype, tol):
    JGPT = _jax_gpt_trial_cls()
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    class J(JGPT):
        def __init__(self, context):
            super().__init__(context)
            self.cfg = dataclasses.replace(self.cfg, compute_dtype=jdt)

    jparams = {}

    class T(tgpt_trial.GPTTrial):
        def __init__(self, context):
            super().__init__(context)
            self.cfg = dataclasses.replace(self.cfg, compute_dtype=tdt)

        def initial_params(self, gen):
            # the JAX trainer's init key: split(PRNGKey(seed))[0]
            return convert.params_from_numpy(jparams["init"], "cpu")

    jcfg = jgpt.GPTConfig(vocab_size=256, n_layers=2, d_model=64, n_heads=4,
                          d_ff=128, max_seq_len=32, remat=False,
                          attention_impl="mha", compute_dtype=jdt)
    key = jax.random.split(jax.random.PRNGKey(0))[0]
    jparams["init"] = jax.device_get(jax.jit(jgpt.init, static_argnums=1)(
        key, jcfg))
    cfg = _config(tmp_path / "j", 10, su=5,
                  min_validation_period={"batches": 5},
                  checkpoint_policy="none")
    j = _run("jax", J, cfg, tmp_path, hparams=GPT_HP)
    cfg["checkpoint_storage"]["host_path"] = str(tmp_path / "t")
    t = _run("port", T, cfg, tmp_path, hparams=GPT_HP)
    for group in ("training", "validation"):
        rj, rt = _reports(j, group), _reports(t, group)
        assert [s for s, _ in rj] == [s for s, _ in rt]
        for (s, mj), (_, mt) in zip(rj, rt):
            assert abs(mt["loss"] / mj["loss"] - 1) <= tol, (group, s, mj, mt)
    losses = [m["loss"] for _, m in _reports(t, "training")]
    assert losses[-1] < losses[0]
    assert tgpt.param_count(t.trainer._final_state.params) == sum(
        int(np.prod(np.shape(x))) for x in jax.tree.leaves(jparams["init"]))


def test_gpt_trial_refuses_a_mesh_and_needs_the_card(tmp_path):
    cfg = TConfig.from_dict({})
    with tcore.init(config=cfg, storage_path=str(tmp_path)) as ctx:
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                TContext(config=cfg, hparams=GPT_HP, core=ctx)
        with pytest.raises(NotImplementedError, match="parallelism"):
            tgpt_trial.GPTTrial(TContext(
                config=cfg, hparams={**GPT_HP, "mesh": {"fsdp": 8}},
                core=ctx, device="cpu"))
        trial = tgpt_trial.GPTTrial(TContext(
            config=cfg, hparams={**GPT_HP, "mesh": {"dp": 1}}, core=ctx,
            device="cpu"))
        assert trial.cfg.attention_impl == "mha" and trial.cfg.vocab_size == 256
        batch = next(iter(trial.training_data()))
        assert batch.shape == (4, 33) and batch.dtype == np.int32
        assert tgpt.resolved_attention_impl(
            dataclasses.replace(trial.cfg, attention_impl="auto"),
            "cpu") == "mha"


# -- the prefetch thread joins on every exit --------------------------------

class _Boom(RuntimeError):
    pass


class TRegressionFails(TRegression):
    def loss(self, params, batch, seed):
        if float(batch[0][0, 4]) == self.fail_at:
            raise _Boom("trial failed mid-chunk")
        return super().loss(params, batch, seed)


def _prefetch_threads():
    return [t.name for t in threading.enumerate()
            if "prefetch" in t.name and t.is_alive()]


@pytest.mark.parametrize("exit_kind", ["normal", "preempted", "exception"])
@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_thread_joins_on_every_exit(tmp_path, exit_kind, depth):
    cfg = _config(tmp_path, 30, optimizations={"prefetch_depth": depth},
                  min_validation_period={"batches": 10})
    source = None
    trial = TRegression
    if exit_kind == "preempted":
        flag = tmp_path / "flag"
        flag.write_text("")
        source = tcore.FilePreemptionSource(str(flag))
    if exit_kind == "exception":
        stream = list(tbatches(*_regression_data()[:2], 8, seed=3))
        trial = type("Fails", (TRegressionFails,),
                     {"fail_at": float(stream[6][0][0, 4])})
    ctx = (pytest.raises(_Boom) if exit_kind == "exception"
           else contextlib.nullcontext())
    with ctx:
        run = _run("port", trial, cfg, tmp_path, preemption_source=source)
    deadline = time.monotonic() + 2.0
    while _prefetch_threads() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert _prefetch_threads() == []
    if exit_kind == "normal":
        assert run.result["batches_trained"] == 30
    if exit_kind == "preempted":
        assert run.result["preempted"] and _meta(run)[-1][1] == "preemption"
