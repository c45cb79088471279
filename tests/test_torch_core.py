"""The port's Core API, config, optimizers, checkpoint format and data
feeders held against the JAX package on the CPU.

Exact comparisons where both sides do the same arithmetic: the config's
parsed fields and errors, tree paths and dtypes of the checkpointed
state, the bytes a checkpoint holds, batch orders. The optimizers are
compared with optax over several steps within 1e-6 relative in fp32: the
port clips by ``t * (max / norm)`` where optax computes ``(t / norm) *
max``, and schedules and bias corrections round in another order, each a
rounding of fp32 (~6e-8) per step.
"""
import dataclasses
import itertools
import json
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from determined_clone_tpu import core as jcore
from determined_clone_tpu.config import ConfigError as JConfigError
from determined_clone_tpu.config import ExperimentConfig as JConfig
from determined_clone_tpu.core import _serialization as jser
from determined_clone_tpu.parallel.sharding import tree_paths_and_leaves
from determined_clone_tpu.training import train_step as jts
from determined_clone_tpu.utils import data as jdata
from determined_clone_tpu_torch import core as tcore
from determined_clone_tpu_torch import faults as tfaults
from determined_clone_tpu_torch.config import ConfigError as TConfigError
from determined_clone_tpu_torch.config import ExperimentConfig as TConfig
from determined_clone_tpu_torch.config import Length
from determined_clone_tpu_torch.core import _serialization as tser
from determined_clone_tpu_torch.training import optim
from determined_clone_tpu_torch.training import train_step as tts
from determined_clone_tpu_torch.utils import data as tdata

torch.set_num_threads(1)


# -- config ---------------------------------------------------------------

GOOD_CONFIGS = [
    {},
    {"searcher": {"name": "single", "metric": "loss",
                  "max_length": {"batches": 30}},
     "scheduling_unit": 10},
    {"searcher": {"name": "single", "metric": "accuracy",
                  "smaller_is_better": False, "max_length": {"epochs": 2}},
     "records_per_epoch": 640, "min_validation_period": {"batches": 5},
     "min_checkpoint_period": {"records": 64}, "checkpoint_policy": "all",
     "reproducibility": {"experiment_seed": 7},
     "optimizations": {"prefetch_depth": 0, "steps_per_dispatch": 3},
     "checkpoint_storage": {"type": "shared_fs", "host_path": "/ckpt",
                            "storage_path": "sub"},
     "resources": {"slots_per_trial": 1},
     "faults": {"seed": 3, "rules": [{"point": "training.pre_step",
                                      "nth": 2}]},
     "hyperparameters": {"lr": 0.1, "global_batch_size": 8},
     "name": "x", "labels": ["a"], "max_restarts": 1},
    {"checkpoint_storage": {"type": "directory", "container_path": "/c"},
     "checkpoint_policy": "none", "observability": {"enabled": False},
     "optimizations": {"aggregation_frequency": 2}},
]

BAD_CONFIGS = [
    {"no_such_key": 1},
    {"searcher": {"name": "nope"}},
    {"searcher": {"name": "single", "max_length": {"minutes": 3}}},
    {"scheduling_unit": 0},
    {"scheduling_unit": "10"},
    {"checkpoint_policy": "sometimes"},
    {"optimizations": {"prefetch_depth": -1}},
    {"optimizations": {"steps_per_dispatch": 0}},
    {"checkpoint_storage": {"type": "shared_fs"}},
    {"checkpoint_storage": {"type": "directory"}},
    {"checkpoint_storage": {"type": "tape"}},
    {"reproducibility": {"experiment_seed": 1.5}},
    {"faults": {"rules": [{"action": "error"}]}},
    {"faults": {"rules": [{"point": "x", "action": "explode"}]}},
    {"resources": {"slots_per_trial": -1}},
]


def _fields(cfg):
    st = cfg.checkpoint_storage
    return {
        "searcher": (cfg.searcher.name, cfg.searcher.metric,
                     cfg.searcher.smaller_is_better,
                     cfg.searcher.max_length and cfg.searcher.max_length
                     .to_dict()),
        "scheduling_unit": cfg.scheduling_unit,
        "periods": [p and p.to_dict() for p in (
            cfg.min_validation_period, cfg.min_checkpoint_period)],
        "policy": cfg.checkpoint_policy,
        "records_per_epoch": cfg.records_per_epoch,
        "seed": cfg.experiment_seed,
        "storage": st and (st.type, st.host_path, st.storage_path,
                           st.container_path),
        "optimizations": (cfg.optimizations.prefetch_depth,
                          cfg.optimizations.steps_per_dispatch),
        "slots": cfg.resources.slots_per_trial,
        "faults": cfg.faults and (cfg.faults.enabled, cfg.faults.seed,
                                  cfg.faults.rules),
    }


@pytest.mark.parametrize("raw", GOOD_CONFIGS, ids=range(len(GOOD_CONFIGS)))
def test_config_parses_as_jax_does(raw):
    assert _fields(TConfig.from_dict(raw)) == _fields(JConfig.from_dict(raw))
    hp = raw.get("hyperparameters", {})
    assert TConfig.from_dict(raw).hyperparameters.raw == hp


@pytest.mark.parametrize("raw", BAD_CONFIGS, ids=range(len(BAD_CONFIGS)))
def test_config_rejects_as_jax_does(raw):
    with pytest.raises(JConfigError):
        JConfig.from_dict(raw)
    with pytest.raises(TConfigError):
        TConfig.from_dict(raw)


@pytest.mark.parametrize("raw,item", [
    ({"observability": {"enabled": True}}, None),
    ({"checkpoint_storage": {"type": "gcs", "bucket": "b"}}, "storage"),
    ({"checkpoint_storage": {"type": "s3", "bucket": "b"}}, "storage"),
], ids=["observability", "gcs", "s3"])
def test_config_blocks_not_ported_raise(raw, item):
    """The blocks the port once refused now parse as the JAX package
    parses them: ``observability`` (the telemetry slice) and the cloud
    ``checkpoint_storage`` types (the storage slice); none raises."""
    j = JConfig.from_dict(raw)  # valid for the JAX package
    t = TConfig.from_dict(raw)
    if item is None:
        assert dataclasses.asdict(t.observability) == \
            dataclasses.asdict(j.observability)
        return
    assert t.checkpoint_storage.to_dict() == j.checkpoint_storage.to_dict()


@pytest.mark.parametrize("slots", [0, 2, 4, 8])
def test_config_accepts_slots_per_trial_as_jax_does(slots):
    """``slots_per_trial`` above 1 is a trial over that many ranks."""
    raw = {"resources": {"slots_per_trial": slots}}
    t, j = TConfig.from_dict(raw), JConfig.from_dict(raw)
    assert t.resources.slots_per_trial == j.resources.slots_per_trial == slots


def test_config_from_yaml_reads_the_example(tmp_path):
    path = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "gpt_fsdp", "fsdp.yaml")
    t, j = (C.from_yaml(path) for C in (TConfig, JConfig))
    assert _fields(t) == _fields(j)
    assert t.resources.slots_per_trial == 8
    assert t.hyperparameters.raw["mesh"] == {"fsdp": 8}
    assert Length.batches(400) == t.searcher.max_length


# -- optimizers -----------------------------------------------------------

def _opt_pairs():
    sched = (optax.linear_schedule(1e-2, 1e-3, 5, 2),
             optim.linear_schedule(1e-2, 1e-3, 5, 2))
    return {
        "clip_adamw_schedule": (
            optax.chain(optax.clip_by_global_norm(1.0),
                        optax.adamw(sched[0], b1=0.9, b2=0.95,
                                    weight_decay=0.1)),
            optim.chain(optim.clip_by_global_norm(1.0),
                        optim.adamw(sched[1], b1=0.9, b2=0.95,
                                    weight_decay=0.1))),
        "clip_sgd": (optax.chain(optax.clip_by_global_norm(0.5),
                                 optax.sgd(0.1)),
                     optim.chain(optim.clip_by_global_norm(0.5),
                                 optim.sgd(0.1))),
        "adam_schedule": (optax.adam(sched[0]), optim.adam(sched[1])),
        "adamw": (optax.adamw(3e-3), optim.adamw(3e-3)),
    }


def _assert_same_leaves(jtree, ttree, rtol=0.0, atol=0.0):
    """Leaves matched by tree path (JAX lists dicts sorted, the port in
    insertion order)."""
    j = dict(tree_paths_and_leaves(jtree))
    t = dict(tser.tree_paths_and_leaves(ttree))
    assert sorted(j) == sorted(t)
    for path, leaf in t.items():
        np.testing.assert_allclose(tser._to_numpy(leaf), np.asarray(j[path]),
                                   rtol=rtol, atol=atol, err_msg=path)


@pytest.mark.parametrize("name", list(_opt_pairs()))
def test_optimizers_match_optax(name):
    """Eight steps from the same params and gradients; the gradients'
    scale alternates around the clip threshold, so both branches run."""
    jtx, ttx = _opt_pairs()[name]
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32),
          "b": {"z": rng.normal(size=(3,)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, p0)
    tp = {"w": torch.tensor(p0["w"]), "b": {"z": torch.tensor(p0["b"]["z"])}}
    js, ts = jtx.init(jp), ttx.init(tp)
    for i in range(8):
        scale = 5.0 if i % 2 else 0.05
        g = {"w": (scale * rng.normal(size=(4, 3))).astype(np.float32),
             "b": {"z": (scale * rng.normal(size=(3,))).astype(np.float32)}}
        upd, js = jtx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = ttx.update({"w": torch.tensor(g["w"]),
                         "b": {"z": torch.tensor(g["b"]["z"])}}, ts, tp)
        _assert_same_leaves(jp, tp, rtol=1e-6, atol=1e-7)
    # the same state layout, leaf for leaf
    jpaths = [(p, np.asarray(x).dtype) for p, x in tree_paths_and_leaves(js)]
    tpaths = [(p, tser._to_numpy(x).dtype)
              for p, x in tser.tree_paths_and_leaves(ts)]
    assert jpaths == tpaths


def test_linear_schedule_and_clip_edges():
    js = optax.linear_schedule(1.0, 0.01, 100, 5)
    ts = optim.linear_schedule(1.0, 0.01, 100, 5)
    for c in (0, 5, 6, 57, 104, 105, 110):
        assert ts(c) == float(js(c))
    assert optim.linear_schedule(2.0, 0.0, 0)(7) == 2.0
    u = [torch.zeros(3)]  # a zero norm leaves the updates as they are
    tx = optim.clip_by_global_norm(1.0)
    out, _ = tx.transform(u, tx.init({}), [])
    assert torch.equal(out[0], torch.zeros(3))


# -- checkpoint serialization ---------------------------------------------

def _states(seed=7):
    """The same params under the same optimizer, as a JAX and a port
    TrainState."""
    rng = np.random.default_rng(1)
    p0 = {"w": rng.normal(size=(3, 2)).astype(np.float32),
          "b": {"z": np.float32(0.5)}}
    sched = 1e-2
    jtx = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(optax.linear_schedule(sched, 0.0, 4)))
    ttx = optim.chain(optim.clip_by_global_norm(1.0),
                      optim.adamw(optim.linear_schedule(sched, 0.0, 4)))
    jstate = jts.create_train_state(jax.tree.map(jnp.asarray, p0), jtx,
                                    jax.random.PRNGKey(seed))
    tstate = tts.create_train_state(
        {"w": torch.tensor(p0["w"]), "b": {"z": torch.tensor(p0["b"]["z"])}},
        ttx, seed)
    return jstate, tstate


def test_train_state_paths_and_dtypes_match_jax():
    jstate, tstate = _states()
    j = [(p, str(np.asarray(x).dtype), np.shape(x))
         for p, x in tree_paths_and_leaves(jstate)]
    t = [(p, str(tser._to_numpy(x).dtype), tuple(np.shape(tser._to_numpy(x))))
         for p, x in tser.tree_paths_and_leaves(tstate)]
    assert j == t
    assert "1/1/0/.mu/b/z" in dict((p, 0) for p, *_ in t)
    assert "1/1/2/.count" in dict((p, 0) for p, *_ in t)


def test_checkpoint_written_by_jax_loads_in_port(tmp_path):
    jstate, tstate = _states(seed=7)
    jstate = dataclasses.replace(jstate, step=jnp.int32(20))
    jser.save_pytree(str(tmp_path), jstate)
    got = tser.load_pytree(str(tmp_path), tstate)
    assert got.step == 20 and isinstance(got.step, int)
    assert got.seed == 7  # PRNGKey(7) is [0, 7]
    assert got.opt_state[1][0].count == 0 and got.opt_state[1][2].count == 0
    assert all(t.dtype == torch.float32 for t in optim.leaves(got.params))
    _assert_same_leaves(jstate.params, got.params)


def test_checkpoint_written_by_port_loads_in_jax(tmp_path):
    jstate, tstate = _states(seed=(5 << 32) | 9)
    tstate = dataclasses.replace(tstate, step=12)
    tser.save_pytree(str(tmp_path), tstate)
    manifest = json.load(open(tmp_path / "manifest-0.json"))
    assert manifest["format"] == 2
    assert manifest["leaves"]["1.1.0..mu.b.z"]["path"] == "1/1/0/.mu/b/z"
    got = jser.load_pytree(str(tmp_path), jstate)
    assert int(got.step) == 12 and got.step.dtype == jnp.int32
    assert np.asarray(got.rng).tolist() == [5, 9]
    _assert_same_leaves(got.params, tstate.params)
    # and back: the seed survives both directions losslessly
    back = tser.load_pytree(str(tmp_path), tstate)
    assert back.seed == (5 << 32) | 9


def test_load_pytree_refuses_missing_or_misshapen_leaves(tmp_path):
    _, tstate = _states()
    tser.save_pytree(str(tmp_path), {"w": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        tser.load_pytree(str(tmp_path), {"v": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        tser.load_pytree(str(tmp_path), {"w": torch.zeros(4)})
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        tser.load_pytree(str(tmp_path / "empty"), tstate)


# -- checkpoint context and storage ---------------------------------------

def _stored(ck_mod, tmp_path, sub):
    from determined_clone_tpu_torch.storage import base as tstorage
    from determined_clone_tpu.storage import base as jstorage

    storage = (tstorage if ck_mod is tcore else jstorage
               ).SharedFSStorageManager(str(tmp_path / sub))
    dist = (tcore.DistributedContext.single() if ck_mod is tcore
            else jcore.DistributedContext.single())
    reg = ck_mod.LocalCheckpointRegistry(str(tmp_path / sub / "reg.jsonl"))
    return ck_mod.CheckpointContext(dist, storage, reg, trial_id=3), storage


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_validate_across_packages(tmp_path, writer):
    w, r = (tcore, jcore) if writer == "port" else (jcore, tcore)
    ck, storage = _stored(w, tmp_path, "s")
    with ck.store_path({"steps_completed": 4, "reason": "final"}) as (d, h):
        with open(os.path.join(d, "x.bin"), "wb") as f:
            f.write(b"abc" * 100)
    sid = h["storage_id"]
    root = tmp_path / "s" / sid
    assert sorted(os.listdir(root)) == ["COMMIT", "manifest.json",
                                        "metadata.json", "x.bin"]
    assert r.validate_checkpoint_dir(str(root), sid) is True
    assert r.verify_manifest_digests(str(root), sid, require_all=True)
    reader, _ = _stored(r, tmp_path, "s")
    assert reader.get_metadata(sid)["steps_completed"] == 4
    assert ck.committed_checkpoints() == [sid]
    # a torn file fails both validations
    with open(root / "x.bin", "r+b") as f:
        f.truncate(10)
    for mod in (tcore, jcore):
        with pytest.raises(mod.CheckpointCorruptError, match="torn"):
            mod.validate_checkpoint_dir(str(root), sid)
    os.remove(root / "COMMIT")
    with pytest.raises(tcore.CheckpointCorruptError, match="COMMIT"):
        tcore.validate_checkpoint_dir(str(root), sid)
    ck.delete(sid)
    assert not root.exists() and ck.committed_checkpoints() == []
    assert ck.wait_async() == [] and ck.abort_async() is None


def _sharded_save(mod, tmp_path, names):
    """Two ranks of an in-process group save with ``shard=True``, rank r
    writing ``names[r]``; returns each rank's storage id or error."""
    store = mod.SharedFSStorageManager(str(tmp_path / "s"))
    reg = mod.LocalCheckpointRegistry(str(tmp_path / "s" / "reg.jsonl"))
    group = mod.DistributedContext.make_local_group(2)
    out = [None, None]

    def rank(r):
        ck = mod.CheckpointContext(group[r], store, reg, trial_id=3)
        try:
            with ck.store_path({"steps_completed": 2}, shard=True) as (d, h):
                with open(os.path.join(d, names[r]), "w") as f:
                    f.write(f"rank {r}")
            out[r] = h["storage_id"]
        except ValueError as e:
            out[r] = e

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sharded_upload_over_two_ranks(tmp_path, writer):
    """``store_path(shard=True)``: one storage id for both ranks, each
    rank's file uploaded, the chief's merged manifest listing both and
    its metadata; the checkpoint validates in both packages. A path that
    two ranks write is refused on both, as in the JAX package."""
    from determined_clone_tpu.storage import base as jstorage
    from determined_clone_tpu_torch.storage import base as tstorage

    mod = types.SimpleNamespace(**vars(tcore if writer == "port" else jcore))
    mod.SharedFSStorageManager = (tstorage if writer == "port"
                                  else jstorage).SharedFSStorageManager
    sids = _sharded_save(mod, tmp_path / "ok", ["shard-0.npz", "shard-1.npz"])
    assert sids[0] == sids[1] and isinstance(sids[0], str)
    root = tmp_path / "ok" / "s" / sids[0]
    assert sorted(os.listdir(root)) == ["COMMIT", "manifest.json",
                                        "metadata.json", "shard-0.npz",
                                        "shard-1.npz"]
    files = json.loads((root / "manifest.json").read_text())["files"]
    assert sorted(files) == ["metadata.json", "shard-0.npz", "shard-1.npz"]
    for reader in (tcore, jcore):
        assert reader.validate_checkpoint_dir(str(root), sids[0]) is True
    bad = _sharded_save(mod, tmp_path / "bad", ["same.npz", "same.npz"])
    assert all(isinstance(e, ValueError) and "conflict" in str(e)
               for e in bad)


def test_storage_fault_points_fire(tmp_path):
    ck, _ = _stored(tcore, tmp_path, "s")
    rules = {"rules": [{"point": "storage.upload", "exc": "fault"}]}
    with tfaults.plan_active(rules) as plan:
        with pytest.raises(tfaults.FaultInjected):
            with ck.store_path({}) as (d, _h):
                open(os.path.join(d, "f"), "w").write("x")
        assert plan.stats()[0]["fires"] == 1
    assert tfaults.active_plan() is None
    assert ck.committed_checkpoints() == []


def test_core_init_local_mode(tmp_path, monkeypatch):
    flag = tmp_path / "preempt"
    monkeypatch.setenv("DCT_PREEMPT_FILE", str(flag))
    monkeypatch.setenv("DCT_FAULT_PLAN", json.dumps(
        {"rules": [{"point": "nowhere"}]}))
    cfg = TConfig.from_dict({"searcher": {"name": "single",
                                          "max_length": {"batches": 3}}})
    try:
        with tcore.init(config=cfg, storage_path=str(tmp_path)) as ctx:
            assert tfaults.active_plan() is not None
            assert not ctx.preempt.should_preempt()
            ops = list(ctx.searcher.operations())
            assert [op.length for op in ops] == [Length.batches(3)]
            assert ctx.telemetry is None and ctx.profiler is None
            ctx.train.report_training_metrics(3, {"loss": float("nan")})
            assert ctx.train._backend.records[0]["metrics"] == {"loss": "nan"}
    finally:
        tfaults.reset()
    with tcore.init() as ctx:  # no arguments: a temporary storage dir
        assert ctx.checkpoint.committed_checkpoints() == []
    # a rank of a larger world is valid; one outside it is not, as in JAX
    assert not tcore.DistributedContext(rank=1, size=2).is_chief
    for core in (tcore, jcore):
        with pytest.raises(core.DistributedError):
            core.DistributedContext(rank=2, size=2)


def test_preemption_flag_is_seen(tmp_path):
    flag = tmp_path / "flag"
    flag.write_text("")
    pc = tcore.PreemptContext(tcore.DistributedContext.single(),
                              tcore.FilePreemptionSource(str(flag)),
                              poll_interval=0.01).start()
    try:
        pc._watcher.join(timeout=5)
        assert pc.should_preempt()
    finally:
        pc.close()


# -- data -----------------------------------------------------------------

def test_batch_iterator_matches_jax_and_skips():
    x = np.arange(50, dtype=np.float32)[:, None]
    y = np.arange(50, dtype=np.int32)
    for kw in ({}, {"seed": 3, "epoch": 2}, {"drop_remainder": False},
               {"shuffle": False}):
        t = list(tdata.batch_iterator(x, y, 8, **kw))
        j = list(jdata.batch_iterator(x, y, 8, **kw))
        assert len(t) == len(j)
        for (tx_, ty), (jx, jy) in zip(t, j):
            np.testing.assert_array_equal(tx_, jx)
            np.testing.assert_array_equal(ty, jy)
    it, jt = tdata.BatchIterator(x, y, 8, seed=1), jdata.BatchIterator(
        x, y, 8, seed=1)
    assert it.skip_batches(4) == jt.skip_batches(4) == 4
    np.testing.assert_array_equal(next(it)[0], next(jt)[0])
    assert it.skip_batches(10) == 1 and len(it) == 0
    tx_, ty = tdata.synthetic_mnist(64, seed=2)
    jx, jy = jdata.synthetic_mnist(64, seed=2)
    np.testing.assert_array_equal(tx_, jx)
    np.testing.assert_array_equal(ty, jy)
    dx, dy = tdata.digits_dataset("test", image=True)
    ex, ey = jdata.digits_dataset("test", image=True)
    np.testing.assert_array_equal(dx, ex)
    np.testing.assert_array_equal(dy, ey)


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_device_feeder_hands_over_the_host_batches(depth):
    batches = [{"x": np.full((2, 3), i, np.float32),
                "y": (np.arange(2) + i, np.int32(i))} for i in range(7)]
    put = lambda b: tdata.batch_to_device(b, "cpu")  # noqa: E731
    feed = tdata.make_device_feeder(iter(batches), put, depth=depth,
                                    name="test-prefetch")
    got = list(feed)
    feed.close()
    assert len(got) == 7
    for b, g in zip(batches, got):
        assert isinstance(g["x"], torch.Tensor)
        np.testing.assert_array_equal(g["x"].numpy(), b["x"])
        np.testing.assert_array_equal(g["y"][0].numpy(), b["y"][0])
        assert int(g["y"][1]) == int(b["y"][1])
    assert feed.take_queue_wait() >= 0.0 and feed.take_host_time() >= 0.0
    assert not any(t.name == "test-prefetch" for t in threading.enumerate())


def test_prefetcher_forwards_errors_and_joins_mid_stream():
    def broken():
        yield np.zeros(2)
        raise ValueError("bad batch")

    feed = tdata.DevicePrefetcher(broken(), depth=2, name="test-prefetch")
    next(feed)
    with pytest.raises(ValueError, match="bad batch"):
        next(feed)
    feed.close()
    assert not feed.thread_alive
    endless = tdata.DevicePrefetcher(itertools.repeat(np.zeros(2)),
                                     depth=1, name="test-prefetch")
    next(endless)
    endless.close()  # the producer is blocked on a full queue
    assert not endless.thread_alive
    with pytest.raises(StopIteration):
        next(endless)


def test_cuda_stager_needs_the_card():
    with pytest.raises((RuntimeError, ValueError)):
        tdata.CudaStager("cpu" if torch.cuda.is_available() else "cuda")
