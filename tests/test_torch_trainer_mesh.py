"""``Trainer.fit`` over a mesh: the port's GPT trial
(``examples/gpt_fsdp.py``) at ``mesh: {fsdp: 2}`` with
``slots_per_trial: 2`` on two gloo ranks (``exec/launch.py``), against
the JAX trainer on a 2-device mesh of the virtual CPU devices.

One launch runs two legs on the ranks: a fresh fit to 4 batches (a
sharded checkpoint at 4), and a fit restored from the JAX trainer's
checkpoint at 4 that trains to 8. The JAX trainer then restores the
port's two-rank checkpoint and trains to 8 as well. Every leg's reports
are held against the unbroken JAX run's at 1e-5 relative (fp32; the
learning rate is 1e-4 for the reason ``tests/test_torch_parallel.py``
gives), and the port's checkpoint has the JAX package's block layout.
"""
import dataclasses
import importlib.util
import json
import os
import pickle
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from determined_clone_tpu_torch import convert  # noqa: E402
from determined_clone_tpu_torch import core as tcore  # noqa: E402
from determined_clone_tpu_torch.config import (  # noqa: E402
    ExperimentConfig as TConfig,
)
from determined_clone_tpu_torch.examples import gpt_fsdp  # noqa: E402
from determined_clone_tpu_torch.exec import launch  # noqa: E402
from determined_clone_tpu_torch.training import Trainer as TTrainer  # noqa: E402
from determined_clone_tpu_torch.training import (  # noqa: E402
    TrialContext as TContext,
)

if __name__ != "__main__":  # the ranks never import JAX
    import jax
    import jax.numpy as jnp

    from determined_clone_tpu import core as jcore
    from determined_clone_tpu.config import ExperimentConfig as JConfig
    from determined_clone_tpu.models import gpt as jgpt
    from determined_clone_tpu.training import Trainer as JTrainer
    from determined_clone_tpu.training import TrialContext as JContext

    from tests.test_torch_parallel import launch_ranks

HP = {"global_batch_size": 4, "vocab_size": 256, "n_layers": 2,
      "d_model": 64, "n_heads": 4, "d_ff": 128, "seq_len": 32,
      "remat": False, "attention_impl": "mha", "lr": 1e-4,
      "n_train_tokens": 3000, "mesh": {"fsdp": 2}}
TIMING = ("batches_per_second", "samples_per_second")
TOL = 1e-5


def _config(storage, batches):
    return {"searcher": {"name": "single", "metric": "loss",
                         "max_length": {"batches": batches}},
            "scheduling_unit": 2, "min_validation_period": {"batches": 2},
            "min_checkpoint_period": {"batches": 4},
            "checkpoint_storage": {"type": "shared_fs",
                                   "host_path": str(storage)},
            "resources": {"slots_per_trial": 2}, "hyperparameters": HP}


class PortTrial(gpt_fsdp.GPTTrial):
    """The port's trial in fp32, from the JAX trainer's initial params."""
    init_path = None

    def __init__(self, context):
        super().__init__(context)
        self.cfg = dataclasses.replace(self.cfg, compute_dtype=torch.float32)

    def initial_params(self, gen):
        with open(self.init_path, "rb") as f:
            return convert.params_from_numpy(pickle.load(f), "cpu")


def _jax_trial_cls():
    path = os.path.join(REPO, "examples", "gpt_fsdp", "model_def.py")
    spec = importlib.util.spec_from_file_location("gpt_fsdp_model_def", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class J(mod.GPTTrial):
        def __init__(self, context):
            super().__init__(context)
            self.cfg = dataclasses.replace(self.cfg,
                                           compute_dtype=jnp.float32)
    return J


def _jax_fit(storage, batches, latest=None):
    cfg = JConfig.from_dict(_config(storage, batches))
    with jcore.init(config=cfg, trial_id=1) as ctx:
        trainer = JTrainer(_jax_trial_cls()(JContext(
            config=cfg, hparams=HP, core=ctx)))
        assert trainer.mesh.shape["fsdp"] == 2
        trainer.fit(latest_checkpoint=latest)
        return list(ctx.train._backend.records)


def _reports(records):
    return [(r["group"], r["steps_completed"],
             {k: v for k, v in r["metrics"].items() if k not in TIMING})
            for r in records]


def _assert_reports(port, jax_, steps):
    """Every (group, step) report in ``steps``; a leg that ends where the
    other run goes on repeats the validation at its end (the end of its
    searcher operation), with the same values."""
    def by_step(records):
        out = {}
        for g, s, m in _reports(records):
            if s in steps:
                assert out.setdefault((g, s), m) == m
        return out
    want, got = by_step(jax_), by_step(port)
    assert sorted(got) == sorted(want)
    for (g, s), mj in want.items():
        mt = got[g, s]
        assert set(mt) == set(mj), (g, s)
        for k in mj:
            assert abs(mt[k] - mj[k]) <= TOL * max(1.0, abs(mj[k])), (
                g, s, k, mt[k], mj[k])


def _registry(storage):
    with open(os.path.join(storage, "checkpoints.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_gpt_trial_on_two_ranks_matches_the_jax_trainer(tmp_path):
    sj, sp = tmp_path / "jax", tmp_path / "port"
    # the JAX trainer's init key: split(PRNGKey(seed))[0]
    jcfg = jgpt.GPTConfig(vocab_size=256, n_layers=2, d_model=64, n_heads=4,
                          d_ff=128, max_seq_len=32, remat=False,
                          attention_impl="mha", compute_dtype=jnp.float32)
    key = jax.random.split(jax.random.PRNGKey(0))[0]
    with open(tmp_path / "init.pkl", "wb") as f:
        pickle.dump(jax.device_get(jgpt.init(key, jcfg)), f)
    unbroken = _jax_fit(sj, 8)
    jax_at_4 = [r["storage_id"] for r in _registry(sj)
                if r["metadata"]["steps_completed"] == 4]
    assert len(jax_at_4) == 1

    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump({"init": str(tmp_path / "init.pkl"), "sp": str(sp),
                     "sj": str(sj), "jax_ckpt": jax_at_4[0]}, f)
    launch_ranks(2, "fit", tmp_path, script=__file__)
    with open(tmp_path / "out.pkl", "rb") as f:
        out = pickle.load(f)

    # leg A: fresh, 4 batches, as the unbroken JAX run's first half
    _assert_reports(out["fresh"], unbroken, {2, 4})
    # leg B: the JAX checkpoint at 4, restored into the two ranks' blocks
    _assert_reports(out["from_jax"], unbroken, {6, 8})
    # the JAX trainer restores the port's two-rank checkpoint
    port_ckpt = [r for r in _registry(sp)
                 if r["metadata"]["steps_completed"] == 4]
    assert len(port_ckpt) == 1
    resumed = _jax_fit(sp, 8, latest=port_ckpt[0]["storage_id"])
    _assert_reports(resumed, unbroken, {6, 8})

    # the JAX package's sharded layout: one npz and manifest per rank,
    # blocks keyed by rank with their global index
    ckpt = sp / port_ckpt[0]["storage_id"] / "state"
    assert sorted(os.listdir(ckpt)) == ["manifest-0.json", "manifest-1.json",
                                       "shard-0.npz", "shard-1.npz"]
    manifests = [json.loads((ckpt / f"manifest-{r}.json").read_text())
                 for r in range(2)]
    table = [m["leaves"]["0.embed.table"] for m in manifests]
    assert [b["key"] for t in table for b in t["blocks"]] == [
        "0.embed.table#0", "0.embed.table#1"]
    assert [b["index"] for t in table for b in t["blocks"]] == [
        [[0, 256], [0, 32]], [[0, 256], [32, 64]]]
    # a replicated leaf is written once, by rank 0
    scale = [m["leaves"]["0.final_norm.scale"]["blocks"] for m in manifests]
    assert [len(b) for b in scale] == [1, 0]
    assert out["world"] == [0, 1]


# -- the ranks ----------------------------------------------------------------

def worker_fit(d):
    torch.set_num_threads(1)
    dist = launch.init_from_env("cpu")
    with open(os.path.join(d, "in.pkl"), "rb") as f:
        spec = pickle.load(f)
    PortTrial.init_path = spec["init"]
    out = {"world": dist.allgather(dist.rank)}
    for leg, storage, batches, latest in (
            ("fresh", spec["sp"], 4, None),
            ("from_jax", spec["sj"], 8, spec["jax_ckpt"])):
        cfg = TConfig.from_dict(_config(storage, batches))
        with tcore.init(config=cfg, distributed=dist, trial_id=1) as ctx:
            trial = PortTrial(TContext(config=cfg,
                                       hparams=HP,
                                       core=ctx, device="cpu"))
            assert trial.context.mesh.size() == 2
            TTrainer(trial).fit(latest_checkpoint=latest)
            out[leg] = list(ctx.train._backend.records)
            assert bool(out[leg]) == dist.is_chief  # the chief reports
    if dist.is_chief:
        with open(os.path.join(d, "out.pkl"), "wb") as f:
            pickle.dump(out, f)
    launch.shutdown()


WORKERS = {"fit": worker_fit}

if __name__ == "__main__":
    WORKERS[sys.argv[1]](sys.argv[2])
