"""The port's async checkpoint saves (``store_path_async``, ``wait_async``,
``abort_async``) held against the JAX package's, as the async cases of
``tests/test_multislice_async.py`` drive them.

Each scenario runs once through each package on its own storage
directory, with the same seeded numpy payloads. Storage ids are fresh
uuids on both sides, so records are compared with the ids replaced by
their position; everything else — the order of publication, registry
records, metadata, resources, files, the errors raised — must be equal.
Timing is checked on each side alone: the caller goes on before the
upload ends (a storage that sleeps 0.3 s per upload call) and nothing is
published before ``wait_async``.
"""
import os
import threading
import time

import numpy as np
import pytest

from determined_clone_tpu import core as jcore
from determined_clone_tpu import storage as jstorage
from determined_clone_tpu.core import _distributed as jdist
from determined_clone_tpu_torch import core as tcore
from determined_clone_tpu_torch import storage as tstorage
from determined_clone_tpu_torch.core import _distributed as tdist

SIDES = {"jax": (jcore, jstorage, jdist), "port": (tcore, tstorage, tdist)}
DELAY = 0.3


def slow_storage(pkg, base, delay=DELAY, fail=False):
    class Slow(pkg.SharedFSStorageManager):
        """Sleeps in every upload call; records when each one ended."""

        def __init__(self):
            super().__init__(str(base))
            self.finished = []

        def upload(self, src_dir, storage_id, paths=None):
            time.sleep(delay)
            if fail:
                raise IOError("bucket gone")
            super().upload(src_dir, storage_id, paths)
            self.finished.append(time.monotonic())

    return Slow()


def payload(seed):
    return np.random.RandomState(seed).bytes(1024)


def normalise(records, sids):
    pos = {sid: i for i, sid in enumerate(sids)}
    out = []
    for r in records:
        r = dict(r)
        r["storage_id"] = pos[r["storage_id"]]
        r.pop("time")
        # COMMIT holds a wall-clock stamp: its size can differ by a digit
        r["resources"] = {k: v for k, v in r["resources"].items()
                          if k != "COMMIT"}
        out.append(r)
    return out


def run_in_flight(side, tmp, n_saves, seed):
    """n async saves, each drained by one wait_async; what each side
    observes, with its own timing checks."""
    mod, pkg, _ = SIDES[side]
    storage = slow_storage(pkg, tmp / "ckpts", delay=0.1)
    registry = mod.LocalCheckpointRegistry(str(tmp / "reg.jsonl"))
    ctx = mod.CheckpointContext(mod.DistributedContext.single(), storage,
                                registry, trial_id=7)
    sids, handoffs = [], []
    for step in range(n_saves):
        t0 = time.monotonic()
        with ctx.store_path_async({"step": step}) as (path, holder):
            with open(os.path.join(path, "weights.bin"), "wb") as f:
                f.write(payload(seed + step))
        handoffs.append(time.monotonic() - t0)
        sids.append(holder["storage_id"])
    published_early = registry.list()
    drained = ctx.wait_async()
    records = registry.list()
    files = []
    for sid in sids:
        with ctx.restore_path(sid) as path:
            with open(os.path.join(path, "weights.bin"), "rb") as f:
                files.append((sorted(os.listdir(path)), f.read()))
    assert published_early == []
    assert drained == sids
    assert ctx.wait_async() == []  # the drain is idempotent
    return {"records": normalise(records, sids), "files": files,
            "handoffs": handoffs}


@pytest.mark.parametrize("n_saves,seed", [(1, 0), (3, 5)])
def test_in_flight_saves_as_jax(n_saves, seed, tmp_path):
    j = run_in_flight("jax", tmp_path / "j", n_saves, seed)
    t = run_in_flight("port", tmp_path / "t", n_saves, seed)
    assert t["records"] == j["records"]
    assert t["files"] == j["files"]
    assert [r["metadata"] for r in t["records"]] == [
        {"step": s} for s in range(n_saves)]
    assert t["files"][0][0] == ["COMMIT", "manifest.json", "metadata.json",
                                "weights.bin"]


def test_save_overlaps_and_wait_drains(tmp_path):
    """The caller thread is back before the upload ends (two upload calls
    of 0.3 s each: the manifest, then the data), on both sides."""
    for side in SIDES:
        mod, pkg, _ = SIDES[side]
        storage = slow_storage(pkg, tmp_path / side)
        ctx = mod.CheckpointContext(mod.DistributedContext.single(),
                                    storage, mod.LocalCheckpointRegistry(
                                        str(tmp_path / f"{side}.jsonl")))
        t0 = time.monotonic()
        with ctx.store_path_async() as (path, holder):
            with open(os.path.join(path, "w.bin"), "wb") as f:
                f.write(payload(1))
        back = time.monotonic()
        assert back - t0 < DELAY, side
        assert holder["storage_id"]
        ctx.wait_async()
        assert storage.finished and min(storage.finished) > back, side


@pytest.mark.parametrize("where", ["upload", "body"])
def test_failures_as_jax(where, tmp_path):
    """An upload error is raised by wait_async and nothing is published;
    an error in the block hands nothing off. The same error and records
    on both sides."""
    out = {}
    for side in SIDES:
        mod, pkg, _ = SIDES[side]
        storage = slow_storage(pkg, tmp_path / side, delay=0.01,
                               fail=where == "upload")
        registry = mod.LocalCheckpointRegistry(
            str(tmp_path / f"{side}.jsonl"))
        ctx = mod.CheckpointContext(mod.DistributedContext.single(),
                                    storage, registry)
        errors = []
        try:
            with ctx.store_path_async() as (path, holder):
                with open(os.path.join(path, "w.bin"), "wb") as f:
                    f.write(b"x")
                if where == "body":
                    raise ValueError("trial code failed")
        except ValueError as e:
            errors.append(str(e))
        try:
            ctx.wait_async()
        except IOError as e:
            errors.append(str(e))
        out[side] = (errors, registry.list(), ctx.wait_async(),
                     sorted(os.listdir(tmp_path / side))
                     if os.path.isdir(tmp_path / side) else [])
    assert out["port"] == out["jax"]
    assert out["port"][0] == (["bucket gone"] if where == "upload"
                              else ["trial code failed"])


def test_abort_async_joins_and_publishes_nothing(tmp_path):
    """The crash-path drain: the upload finishes (its files land), but no
    COMMIT and no record, on both sides."""
    out = {}
    for side in SIDES:
        mod, pkg, _ = SIDES[side]
        storage = slow_storage(pkg, tmp_path / side, delay=0.05)
        registry = mod.LocalCheckpointRegistry(
            str(tmp_path / f"{side}.jsonl"))
        ctx = mod.CheckpointContext(mod.DistributedContext.single(),
                                    storage, registry)
        with ctx.store_path_async({"step": 1}) as (path, holder):
            with open(os.path.join(path, "w.bin"), "wb") as f:
                f.write(payload(2))
        ctx.abort_async()
        sid = holder["storage_id"]
        out[side] = (sorted(storage.list_files(sid)), registry.list(),
                     storage.is_committed(sid), ctx.wait_async())
    assert out["port"] == out["jax"]
    assert out["port"][0] == ["manifest.json", "metadata.json", "w.bin"]


def sharded(side, tmp, world=4):
    """world threads = world ranks of one gang: per-rank async shard
    uploads under one collective id, one drain."""
    mod, pkg, dist_mod = SIDES[side]
    chief = dist_mod._ChiefTransport(0, world)
    storage = slow_storage(pkg, tmp / "ckpts", delay=0.05)
    registry = mod.LocalCheckpointRegistry(str(tmp / "reg.jsonl"))
    results, errors = {}, []

    def member(rank):
        try:
            if rank == 0:
                dist = mod.DistributedContext(rank=0, size=world,
                                              transport=chief)
            else:
                dist = mod.DistributedContext.from_tcp(
                    "127.0.0.1", chief.port, rank, world)
            ctx = mod.CheckpointContext(dist, storage, registry, trial_id=1)
            with ctx.store_path_async({"step": 9},
                                      shard=True) as (path, holder):
                with open(os.path.join(path, f"shard-{rank}.bin"),
                          "wb") as f:
                    f.write(payload(10 + rank)[:8 * (rank + 1)])
            results[rank] = (holder["storage_id"], ctx.wait_async())
            dist.close()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=member, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and len(results) == world
    sids = {sid for sid, _ in results.values()}
    assert len(sids) == 1  # one collective id
    sid = sids.pop()
    assert all(drained == [sid] for _, drained in results.values())
    recs = mod.LocalCheckpointRegistry(str(tmp / "reg.jsonl")).list()
    return storage.list_files(sid), normalise(recs, [sid])


def test_sharded_async_across_ranks_as_jax(tmp_path):
    j = sharded("jax", tmp_path / "j")
    t = sharded("port", tmp_path / "t")
    files, recs = t
    assert set(files) == {"COMMIT", "manifest.json", "metadata.json",
                          "shard-0.bin", "shard-1.bin", "shard-2.bin",
                          "shard-3.bin"}
    assert ({k: v for k, v in files.items() if k != "COMMIT"}
            == {k: v for k, v in j[0].items() if k != "COMMIT"})
    assert recs == j[1] and len(recs) == 1
    assert len(recs[0]["resources"]) == 6


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_async_checkpoint_read_by_the_other_package(writer, tmp_path):
    """An async save of one package restores through the other's
    CheckpointContext, commit validation included."""
    reader = "port" if writer == "jax" else "jax"
    wmod, wpkg, _ = SIDES[writer]
    rmod, rpkg, _ = SIDES[reader]
    base = tmp_path / "ckpts"
    wctx = wmod.CheckpointContext(wmod.DistributedContext.single(),
                                  wpkg.SharedFSStorageManager(str(base)))
    with wctx.store_path_async({"step": 4}) as (path, holder):
        with open(os.path.join(path, "w.bin"), "wb") as f:
            f.write(payload(3))
    assert wctx.wait_async() == [holder["storage_id"]]
    rctx = rmod.CheckpointContext(rmod.DistributedContext.single(),
                                  rpkg.SharedFSStorageManager(str(base)))
    with rctx.restore_path(holder["storage_id"]) as path:
        with open(os.path.join(path, "w.bin"), "rb") as f:
            assert f.read() == payload(3)
    assert rctx.get_metadata(holder["storage_id"])["step"] == 4
