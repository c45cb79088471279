"""The port's GCS, S3 and Azure checkpoint managers held against the JAX
package's, over the in-memory fake clients of
``tests/test_storage_backends.py`` (no SDK, no network).

Each scenario runs once through each package, each with its own fresh
fake; the fakes' object stores (key → bytes), every listing and every
downloaded file must be equal, exactly. A checkpoint saved through one
package's ``CheckpointContext`` onto a fake is restored through the
other's on the same fake.
"""
import os

import numpy as np
import pytest

from determined_clone_tpu import core as jcore
from determined_clone_tpu import storage as jstorage
from determined_clone_tpu.config.experiment import (
    CheckpointStorageConfig as JStorageConfig,
)
from determined_clone_tpu_torch import core as tcore
from determined_clone_tpu_torch import storage as tstorage
from determined_clone_tpu_torch.config.experiment import ConfigError
from determined_clone_tpu_torch.config.experiment import (
    CheckpointStorageConfig as TStorageConfig,
)
from tests.test_storage_backends import (
    FakeAzureContainerClient,
    FakeGCSClient,
    FakeS3Client,
)

KINDS = ("gcs", "s3", "azure")


def make(pkg, kind, prefix="ckpts", client=None):
    """(manager, the fake's object store) of one package."""
    if kind == "gcs":
        client = client or FakeGCSClient()
        return pkg.GCSStorageManager("bkt", prefix, client=client), \
            client.store
    if kind == "s3":
        client = client or FakeS3Client()
        return pkg.S3StorageManager("bkt", prefix, client=client), \
            client.store
    client = client or FakeAzureContainerClient()
    return pkg.AzureStorageManager("cont", prefix=prefix,
                                   container_client=client), client.store


def seeded_tree(root, seed):
    """A checkpoint-like tree of random bytes from a numpy seed."""
    rng = np.random.RandomState(seed)
    files = {"weights.bin": rng.bytes(int(rng.randint(1, 300))),
             "sub/opt.bin": rng.bytes(int(rng.randint(1, 200))),
             "sub/deep/state.npz": rng.bytes(64),
             "meta.json": b"{}"}
    for rel, data in files.items():
        p = os.path.join(root, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)
    return files


def read_tree(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def scenario(pkg, kind, tmp, seed):
    """Upload, list, full and partial download, selective upload,
    store_path/restore_path, sibling ids and delete; returns everything
    observable."""
    mgr, store = make(pkg, kind)
    src = os.path.join(tmp, "src")
    seeded_tree(src, seed)
    obs = {}
    mgr.upload(src, "uuid-1")
    obs["keys"] = dict(store)
    obs["list"] = mgr.list_files("uuid-1")
    mgr.download("uuid-1", os.path.join(tmp, "full"))
    obs["full"] = read_tree(os.path.join(tmp, "full"))
    mgr.download("uuid-1", os.path.join(tmp, "part"),
                 paths=["meta.json", "sub/opt.bin"])
    obs["part"] = read_tree(os.path.join(tmp, "part"))
    mgr.upload(src, "uuid-12", paths=["weights.bin"])
    with mgr.store_path("ck-1") as path:
        with open(os.path.join(path, "model.bin"), "wb") as f:
            f.write(np.random.RandomState(seed + 1).bytes(33))
    with mgr.restore_path("ck-1") as path:
        obs["restored"] = read_tree(path)
    mgr.commit("uuid-1", {"step": 3})
    obs["committed"] = (mgr.is_committed("uuid-1"),
                        mgr.is_committed("uuid-12"))
    obs["commit_bytes"] = store[next(k for k in store
                                     if k.endswith("uuid-1/COMMIT"))]
    mgr.delete("uuid-1")
    mgr.delete_files("uuid-12", ["weights.bin"])
    obs["after_delete"] = dict(store)
    obs["lists_after"] = (mgr.list_files("uuid-1"),
                          mgr.list_files("uuid-12"),
                          mgr.list_files("ck-1"))
    return obs


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_manager_scenario_as_jax(kind, seed, tmp_path):
    """Exact: the same object keys, bytes, listings and downloads."""
    j = scenario(jstorage, kind, str(tmp_path / "j"), seed)
    t = scenario(tstorage, kind, str(tmp_path / "t"), seed)
    assert t == j
    assert all(k.startswith("ckpts/") for k in t["keys"])
    assert t["lists_after"][0] == {}


def test_s3_pagination_as_jax(tmp_path):
    """Seven keys over pages of two: every page is followed."""
    outs = []
    for pkg in (jstorage, tstorage):
        client = FakeS3Client(page_size=2)
        mgr = pkg.S3StorageManager("bkt", client=client)
        src = tmp_path / pkg.__name__ / "many"
        src.mkdir(parents=True)
        for i in range(7):
            (src / f"shard-{i}.bin").write_bytes(b"x" * (i + 1))
        mgr.upload(str(src), "big")
        listed = mgr.list_files("big")
        mgr.delete("big")
        outs.append((listed, dict(client.store)))
    assert outs[0] == outs[1]
    assert len(outs[1][0]) == 7 and outs[1][1] == {}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages_on_one_fake(kind, writer, tmp_path):
    """A committed checkpoint saved by one package's CheckpointContext on
    a fake bucket is listed, validated and restored by the other's."""
    client = {"gcs": FakeGCSClient, "s3": FakeS3Client,
              "azure": FakeAzureContainerClient}[kind]()
    jmgr, _ = make(jstorage, kind, client=client)
    tmgr, _ = make(tstorage, kind, client=client)
    sides = {"jax": (jcore, jmgr), "port": (tcore, tmgr)}
    reader = "port" if writer == "jax" else "jax"
    wmod, wmgr = sides[writer]
    wctx = wmod.CheckpointContext(wmod.DistributedContext.single(), wmgr,
                                  trial_id=3)
    with wctx.store_path({"steps_completed": 5}) as (path, holder):
        files = seeded_tree(path, 7)
    sid = holder["storage_id"]
    rmod, rmgr = sides[reader]
    rctx = rmod.CheckpointContext(rmod.DistributedContext.single(), rmgr,
                                  trial_id=3)
    assert rmgr.is_committed(sid)
    assert rmgr.list_files(sid) == wmgr.list_files(sid)
    with rctx.restore_path(sid) as path:
        got = read_tree(path)
    assert {k: got[k] for k in files} == files
    assert rctx.get_metadata(sid)["steps_completed"] == 5


CONFIGS = {
    "gcs": {"type": "gcs", "bucket": "b", "prefix": "p"},
    "s3": {"type": "s3", "bucket": "b"},
    "azure": {"type": "azure", "container": "c",
              "connection_string": "UseDevelopmentStorage=true"},
    "gcs_no_bucket": {"type": "gcs"},
    "s3_no_bucket": {"type": "s3"},
    "azure_no_container": {"type": "azure"},
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_and_build_as_jax(name):
    """The block parses as in JAX (or fails with JAX's message), and
    ``build`` reaches the backend, which without its SDK raises a
    RuntimeError naming it in both packages."""
    raw = CONFIGS[name]
    try:
        j = JStorageConfig.from_dict(raw)
    except ValueError as e:
        with pytest.raises(ConfigError) as t:
            TStorageConfig.from_dict(raw)
        assert str(t.value) == str(e)
        return
    t = TStorageConfig.from_dict(raw)
    assert t.to_dict() == j.to_dict()
    with pytest.raises(RuntimeError) as je:
        jstorage.build(j)
    with pytest.raises(RuntimeError) as te:
        tstorage.build(t)
    # the same first clause, naming the SDK (the JAX gcs message goes on
    # about TPU VMs)
    assert str(te.value).split(";")[0] == str(je.value).split(";")[0]
