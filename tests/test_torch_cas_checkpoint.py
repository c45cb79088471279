"""The checkpoint half of the port's content-addressed store
(``ChunkCache``, ``CASStorageManager``, ``build_cas``, ``type: cas``,
``checkpoint stats`` and ``kv stats --config``) held against the JAX
package's, case for case as ``tests/test_cas_store.py`` drives it.

Each scenario runs once through each package, on its own directory, with
the same seeded numpy payloads. Chunk digests are content addresses, so
the chunk namespaces, logical listings, downloaded bytes, session and
store stats must be equal exactly; only the chunk manifests' names
(random tokens) and the paths under ``tmp_path`` differ. Then one store
is written by one package and read, restored and garbage-collected by
the other, in each direction, directly and through ``core.init`` with a
``type: cas`` config.
"""
import json
import os
import types

import numpy as np
import pytest

from determined_clone_tpu import core as jcore
from determined_clone_tpu import storage as jstorage
from determined_clone_tpu.cli import cli as jcli
from determined_clone_tpu.config import ExperimentConfig as JConfig
from determined_clone_tpu.config.experiment import (
    CheckpointStorageConfig as JStorageConfig,
)
from determined_clone_tpu.storage import cas as jcas
from determined_clone_tpu_torch import core as tcore
from determined_clone_tpu_torch import storage as tstorage
from determined_clone_tpu_torch.cli import cli as tcli
from determined_clone_tpu_torch.config import ExperimentConfig as TConfig
from determined_clone_tpu_torch.config.experiment import (
    CheckpointStorageConfig as TStorageConfig,
)
from determined_clone_tpu_torch.storage import cas as tcas

CHUNK = 1024  # small chunks so a few KiB of payload spans many

SIDES = {
    "jax": types.SimpleNamespace(
        name="jax", core=jcore, storage=jstorage, cas=jcas, cli=jcli,
        Config=JConfig, StorageConfig=JStorageConfig),
    "port": types.SimpleNamespace(
        name="port", core=tcore, storage=tstorage, cas=tcas, cli=tcli,
        Config=TConfig, StorageConfig=TStorageConfig),
}


def both(fn, tmp_path, *args):
    """fn(side, its own directory, *args) through each package; the two
    results must be equal."""
    out = {name: fn(side, tmp_path / name, *args)
           for name, side in SIDES.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def blob(seed, n):
    return np.random.RandomState(seed).bytes(n)


def make_cas(side, tmp, *, cache=False, counting=False):
    inner_cls = side.storage.SharedFSStorageManager
    if counting:
        class CountingFS(inner_cls):
            """Counts chunk-object downloads (the cache-bypass probe)."""

            def __init__(self, base):
                super().__init__(base)
                self.chunk_fetches = 0

            def download(self, storage_id, dst_dir, paths=None):
                if storage_id == side.cas.CHUNK_NAMESPACE:
                    self.chunk_fetches += len(paths or [])
                return super().download(storage_id, dst_dir, paths=paths)

        inner_cls = CountingFS
    inner = inner_cls(str(tmp / "store"))
    ck_cache = (side.storage.ChunkCache(str(tmp / "cache"),
                                        max_bytes=1 << 20)
                if cache else None)
    mgr = side.storage.CASStorageManager(
        inner, chunk_size=CHUNK, cache=ck_cache,
        pool=side.storage.TransferPool(workers=0))
    return mgr, inner


def write_payload(src, data, extra=None):
    os.makedirs(os.path.join(src, "state"), exist_ok=True)
    with open(os.path.join(src, "state", "weights.bin"), "wb") as f:
        f.write(data)
    if extra is not None:
        with open(os.path.join(src, "opt.bin"), "wb") as f:
            f.write(extra)


def read(path):
    with open(path, "rb") as f:
        return f.read()


def chunks(inner):
    return inner.list_files("cas")


def stats_view(stats):
    """storage_stats() without the paths under tmp_path."""
    stats = json.loads(json.dumps(stats))
    if "cache" in stats:
        stats["cache"].pop("path")
    return stats


# -- the chunk cache ----------------------------------------------------------

def _digest(side, data):
    return side.cas._sha256_bytes(data)


def cache_scenario(side, tmp, case):
    cache = side.storage.ChunkCache(str(tmp / "cache"),
                                    max_bytes=250 if case == "lru" else
                                    1 << 20)
    if case == "roundtrip":
        data = blob(1, 300)
        d = _digest(side, data)
        first = cache.get(d)
        cache.put(d, data)
        hit = read(cache.get(d))
        s = cache.stats()
        again = side.storage.ChunkCache(str(tmp / "cache")).stats()
        return first, hit == data, stats_view({"cache": s}), \
            (again["hits"], again["misses"])
    if case == "corrupt":
        data = blob(2, 128)
        d = _digest(side, data)
        p = cache.put(d, data)
        with open(p, "wb") as f:
            f.write(b"x" * 128)
        return cache.get(d), os.path.exists(p), cache.stats()["misses"]
    if case == "lru":
        blobs = [bytes([i]) * 100 for i in range(3)]
        for i, b in enumerate(blobs):
            cache.put(_digest(side, b), b)
            os.utime(cache._entry(_digest(side, b)),
                     (1_000_000 + i, 1_000_000 + i))
        kept = [cache.get(_digest(side, b)) is not None for b in blobs]
        tiny = side.storage.ChunkCache(str(tmp / "tiny"), max_bytes=10)
        tiny.put(_digest(side, b"z" * 100), b"z" * 100)
        return kept, tiny.get(_digest(side, b"z" * 100)) is not None
    data = blob(3, 64)  # amortized stats flush
    d = _digest(side, data)
    cache.put(d, data)
    for _ in range(10):
        cache.get(d)
    before = os.path.exists(cache._stats_path)
    hits = cache.stats()["hits"]
    with open(cache._stats_path) as f:
        return before, hits, json.load(f)


@pytest.mark.parametrize("case", ["roundtrip", "corrupt", "lru", "flush"])
def test_chunk_cache_as_jax(case, tmp_path):
    both(cache_scenario, tmp_path, case)


# -- the store ----------------------------------------------------------------

def dedup_scenario(side, tmp, seed):
    mgr, inner = make_cas(side, tmp)
    data = bytearray(blob(seed, 8 * CHUNK))
    src = str(tmp / "src")
    write_payload(src, bytes(data))
    mgr.upload(src, "ck-1")
    per_save = [mgr.session_stats["bytes_uploaded"]]
    for n, sid in ((2, "ck-2"), (3, "ck-3")):
        data[0:CHUNK] = blob(seed + n, CHUNK)
        write_payload(src, bytes(data))
        before = mgr.session_stats["bytes_uploaded"]
        mgr.upload(src, sid)
        per_save.append(mgr.session_stats["bytes_uploaded"] - before)
        mgr.commit(sid)
    mgr.commit("ck-1")
    return per_save, stats_view(mgr.storage_stats()), chunks(inner)


@pytest.mark.parametrize("seed", [0, 4])
def test_dedup_across_saves_as_jax(seed, tmp_path):
    per_save, stats, _ = both(dedup_scenario, tmp_path, seed)
    assert per_save == [8 * CHUNK, CHUNK, CHUNK]
    assert stats["cas_checkpoints"] == 3 and stats["dedup_ratio"] == 2.4
    assert stats["session"]["chunks_deduped"] == 14


def restore_scenario(side, tmp, tail):
    mgr, _ = make_cas(side, tmp)
    data, extra = blob(5, 3 * CHUNK + tail), blob(6, CHUNK // 2)
    src = str(tmp / "src")
    write_payload(src, data, extra)
    (tmp / "src" / "empty.bin").write_bytes(b"")
    mgr.upload(src, "ck-1")
    listed = mgr.list_files("ck-1")
    mgr.download("ck-1", str(tmp / "dst"))
    partial = tmp / "part"
    mgr.download("ck-1", str(partial), paths=["opt.bin"])
    return (listed, read(tmp / "dst" / "state" / "weights.bin") == data,
            read(tmp / "dst" / "opt.bin") == extra,
            read(tmp / "dst" / "empty.bin"), sorted(os.listdir(partial)),
            mgr.list_storage_ids())


@pytest.mark.parametrize("tail", [0, 17])
def test_restore_bit_identical_as_jax(tail, tmp_path):
    out = both(restore_scenario, tmp_path, tail)
    assert out[1:5] == (True, True, b"", ["opt.bin"])
    assert out[5] == ["ck-1"]


def warm_scenario(side, tmp):
    mgr, inner = make_cas(side, tmp, cache=True, counting=True)
    data = blob(7, 4 * CHUNK)
    write_payload(str(tmp / "src"), data)
    mgr.upload(str(tmp / "src"), "ck-1")
    mgr.download("ck-1", str(tmp / "dst"))
    warm = (inner.chunk_fetches, mgr.session_stats["cache_hits"])
    cold = side.storage.CASStorageManager(
        inner, chunk_size=CHUNK, pool=side.storage.TransferPool(workers=0))
    cold.download("ck-1", str(tmp / "dst2"))
    return (warm, inner.chunk_fetches,
            read(tmp / "dst2" / "state" / "weights.bin") == data,
            cold.session_stats)


def test_warm_restore_never_touches_backend_as_jax(tmp_path):
    out = both(warm_scenario, tmp_path)
    assert out[0] == (0, 4) and out[1] == 4 and out[2]


def gc_scenario(side, tmp):
    mgr, inner = make_cas(side, tmp)
    shared = blob(8, 2 * CHUNK)
    src = str(tmp / "src")
    write_payload(src, shared)
    mgr.upload(src, "ck-1")
    write_payload(src, shared, extra=blob(9, CHUNK))
    mgr.upload(src, "ck-2")
    steps = [chunks(inner)]
    mgr.delete("ck-2")
    steps.append(chunks(inner))
    mgr.download("ck-1", str(tmp / "dst"))
    ok = read(tmp / "dst" / "state" / "weights.bin") == shared
    mgr.upload(src, "ck-inflight")  # never committed
    mgr.commit("ck-1")
    mgr.delete("ck-1")
    steps.append(chunks(inner))
    mgr.download("ck-inflight", str(tmp / "dst2"))
    ok2 = read(tmp / "dst2" / "state" / "weights.bin") == shared
    mgr.delete("ck-inflight")
    steps.append(chunks(inner))
    return [len(s) for s in steps], steps, ok, ok2


def test_gc_keeps_referenced_chunks_as_jax(tmp_path):
    counts, _, ok, ok2 = both(gc_scenario, tmp_path)
    assert counts == [3, 2, 3, 0] and ok and ok2


def manifest_first_scenario(side, tmp):
    mgr, inner = make_cas(side, tmp)

    def die(to_send):
        raise OSError("PUT died")

    mgr._upload_chunks = die
    write_payload(str(tmp / "src"), blob(10, 2 * CHUNK))
    with pytest.raises(OSError, match="PUT died"):
        mgr.upload(str(tmp / "src"), "ck-1")
    manifests = [r for r in inner.list_files("ck-1")
                 if side.cas._is_chunk_manifest(r)]
    return len(manifests), sorted(mgr._referenced_digests("ck-1"))


def test_chunk_manifest_written_before_chunk_data_as_jax(tmp_path):
    n, refs = both(manifest_first_scenario, tmp_path)
    assert n == 1 and len(refs) == 2


def repair_scenario(side, tmp):
    mgr, inner = make_cas(side, tmp)
    data = blob(11, 2 * CHUNK)
    src = str(tmp / "src")
    write_payload(src, data)
    mgr.upload(src, "ck-old")
    mgr.commit("ck-old")
    victims = [side.cas.chunk_rel(d)
               for d in sorted(mgr._referenced_digests("ck-old"))]
    orig = mgr._write_chunk_manifest

    def hostile(storage_id, entries):
        orig(storage_id, entries)
        if storage_id == "ck-new":  # another process's GC lands here
            inner.delete("ck-old")
            inner.delete_files(side.cas.CHUNK_NAMESPACE, victims)

    mgr._write_chunk_manifest = hostile
    before = mgr.session_stats["bytes_uploaded"]
    mgr.upload(src, "ck-new")
    resent = mgr.session_stats["bytes_uploaded"] - before
    mgr.commit("ck-new")
    mgr.download("ck-new", str(tmp / "dst"))
    return resent, read(tmp / "dst" / "state" / "weights.bin") == data


def test_upload_repairs_dedup_against_concurrent_gc_as_jax(tmp_path):
    assert both(repair_scenario, tmp_path) == (2 * CHUNK, True)


def foreign_gc_scenario(side, tmp):
    mgr, inner = make_cas(side, tmp)
    data = blob(12, 2 * CHUNK)
    src = str(tmp / "src")
    write_payload(src, data)
    mgr.upload(src, "ck-1")
    inner.delete("ck-1")
    inner.delete_files(side.cas.CHUNK_NAMESPACE,
                       [side.cas.chunk_rel(d) for d in
                        sorted(mgr._referenced_digests("ck-1"))])
    mgr._forget("ck-1")
    mgr.upload(src, "ck-2")
    mgr.download("ck-2", str(tmp / "dst"))
    return read(tmp / "dst" / "state" / "weights.bin") == data, \
        mgr.session_stats


def test_known_chunks_rebuilt_after_foreign_gc_as_jax(tmp_path):
    assert both(foreign_gc_scenario, tmp_path)[0]


def late_manifest_scenario(side, tmp):
    mgr, inner = make_cas(side, tmp)
    data = blob(13, 2 * CHUNK)
    src = str(tmp / "src")
    write_payload(src, data)
    mgr.upload(src, "ck-old")
    mgr.commit("ck-old")
    other = side.storage.CASStorageManager(
        inner, chunk_size=CHUNK, pool=side.storage.TransferPool(workers=0))
    orig = mgr.list_storage_ids
    walks = []

    def walk():
        out = orig()
        walks.append(out)
        if len(walks) == 1:  # ck-new's manifest lands after the first walk
            other.upload(src, "ck-new")
        return out

    mgr.list_storage_ids = walk
    mgr.delete("ck-old")
    mgr.download("ck-new", str(tmp / "dst"))
    return walks, read(tmp / "dst" / "state" / "weights.bin") == data


def test_gc_second_walk_honors_late_manifest_as_jax(tmp_path):
    walks, ok = both(late_manifest_scenario, tmp_path)
    assert len(walks) >= 2 and ok


def test_constructor_refusals_as_jax(tmp_path):
    msgs = {}
    for name, side in SIDES.items():
        inner = side.storage.SharedFSStorageManager(str(tmp_path))
        wrapped = side.storage.CASStorageManager(inner, chunk_size=CHUNK)
        got = []
        for kwargs in ({"inner": wrapped, "chunk_size": CHUNK},
                       {"inner": inner, "chunk_size": 0},
                       {"inner": inner, "namespace_budgets": {"chunks": 1}}):
            with pytest.raises(ValueError) as e:
                side.storage.CASStorageManager(**kwargs)
            got.append(str(e.value))
        msgs[name] = got
    assert msgs["port"] == msgs["jax"]


def budget_scenario(side, tmp):
    """The exec and kv namespaces over their byte budgets: the oldest
    objects go, chunks are never touched."""
    inner = side.storage.SharedFSStorageManager(str(tmp / "store"))
    mgr = side.storage.CASStorageManager(
        inner, chunk_size=CHUNK, namespace_budgets={"kv": 600, "exec": 300})
    write_payload(str(tmp / "src"), blob(19, 2 * CHUNK))
    mgr.upload(str(tmp / "src"), "ck-1")
    rng = np.random.RandomState(20)
    for i in range(12):
        ns = ("kv/blobs", "kv/index", "exec/blobs")[i % 3]
        data = rng.bytes(int(rng.randint(50, 300)))
        rel = f"{ns}/{i:02x}/{i:064x}"
        p = os.path.join(str(tmp / "store"), "cas", rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)
        os.utime(p, (1_000_000 + i, 1_000_000 + i))
    swept = mgr.sweep_namespaces()
    return (swept, mgr.storage_stats()["namespaces"],
            sorted(side.cas.namespace_usage(inner, "kv")),
            sorted(side.cas.namespace_usage(inner, "exec")), chunks(inner))


def test_namespace_budget_sweep_as_jax(tmp_path):
    swept, ns, kv_left, exec_left, chunk_objs = both(budget_scenario,
                                                     tmp_path)
    assert swept["kv"]["evicted"] > 0 and ns["kv"]["evictions"] > 0
    assert swept["exec"]["evicted"] > 0 and ns["exec"]["bytes"] <= 300
    assert ns["kv"]["bytes"] <= 600 and kv_left and exec_left
    assert len(chunk_objs) == 2 + len(kv_left) + len(exec_left)


# -- one store, two packages ----------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_one_store_read_by_the_other_package(writer, tmp_path):
    """Chunks, manifests and the cache written by one package are read,
    deduplicated against and collected by the other."""
    reader = "port" if writer == "jax" else "jax"
    w, _ = make_cas(SIDES[writer], tmp_path, cache=True)
    r, rinner = make_cas(SIDES[reader], tmp_path, cache=True)
    data, extra = blob(14, 5 * CHUNK + 3), blob(15, CHUNK)
    src = str(tmp_path / "src")
    write_payload(src, data, extra)
    w.upload(src, "ck-1")
    w.commit("ck-1")
    assert r.list_files("ck-1") == w.list_files("ck-1")
    r.download("ck-1", str(tmp_path / "dst"))
    assert read(tmp_path / "dst" / "state" / "weights.bin") == data
    assert read(tmp_path / "dst" / "opt.bin") == extra
    # the reader saves the same state: every chunk dedups
    r.upload(src, "ck-2")
    assert r.session_stats["bytes_uploaded"] == 0
    assert r.session_stats["chunks_deduped"] == 7
    # the store as each package sees it (the session and cache counters
    # are each process's own)
    rs, ws = stats_view(r.storage_stats()), stats_view(w.storage_stats())
    for doc in (rs, ws):
        doc.pop("session"), doc.pop("cache")
    assert rs == ws and rs["cas_checkpoints"] == 2
    r.delete("ck-1")
    w.download("ck-2", str(tmp_path / "dst2"))
    assert read(tmp_path / "dst2" / "state" / "weights.bin") == data
    w.delete("ck-2")
    assert chunks(rinner) == {}


def _exp_config(side, tmp_path):
    return side.Config.from_dict({
        "searcher": {"name": "single", "metric": "loss",
                     "max_length": {"batches": 4}},
        "checkpoint_storage": {
            "type": "cas", "chunk_size_kb": 1,
            "cache_path": str(tmp_path / "cache"),
            "inner": {"type": "shared_fs", "host_path": str(tmp_path)}}})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_core_checkpoints_on_a_cas_config_cross_packages(writer, tmp_path):
    """``core.init`` with ``type: cas``: a checkpoint saved twice by one
    package (the second save deduplicates all of it) is registered and
    restored bit for bit by the other's Core API."""
    reader = "port" if writer == "jax" else "jax"
    payloads = {"model.npz": blob(16, 3000), "opt/adam.npz": blob(17, 2100)}
    sids = []
    with SIDES[writer].core.init(
            config=_exp_config(SIDES[writer], tmp_path), trial_id=1) as ctx:
        for step in (1, 2):
            with ctx.checkpoint.store_path({"steps_completed": step}) as (
                    path, holder):
                for rel, data in payloads.items():
                    os.makedirs(os.path.dirname(os.path.join(path, rel)),
                                exist_ok=True)
                    with open(os.path.join(path, rel), "wb") as f:
                        f.write(data)
            sids.append(holder["storage_id"])
        stats = ctx.checkpoint._storage.storage_stats()
    assert stats["cas_checkpoints"] == 2
    assert stats["session"]["bytes_uploaded"] == 5100
    assert stats["session"]["bytes_deduped"] == 5100
    with SIDES[reader].core.init(
            config=_exp_config(SIDES[reader], tmp_path), trial_id=1) as ctx:
        assert ctx.checkpoint.committed_checkpoints() == sids[::-1]
        with ctx.checkpoint.restore_path(sids[1]) as path:
            for rel, data in payloads.items():
                assert read(os.path.join(path, rel)) == data
        assert ctx.checkpoint.get_metadata(sids[1])["steps_completed"] == 2


# -- config and build ---------------------------------------------------------

CAS_RAW = {
    "type": "cas", "chunk_size_kb": 64, "cache_path": "/var/cache/dct",
    "cache_size_mb": 16, "transfer_workers": 2,
    "inner": {"type": "shared_fs", "host_path": "/data/ckpts"},
}
CONFIG_CASES = {
    "full": CAS_RAW,
    "flat_host_path": {"type": "cas", "host_path": "/data"},
    "flat_container_path": {"type": "cas", "container_path": "/c"},
    "inner_s3": {"type": "cas", "inner": {"type": "s3", "bucket": "b"}},
    "no_inner": {"type": "cas"},
    "nested": {"type": "cas", "inner": dict(CAS_RAW)},
    "chunk_0": dict(CAS_RAW, chunk_size_kb=0),
    "cache_0": dict(CAS_RAW, cache_size_mb=0),
    "workers_neg": dict(CAS_RAW, transfer_workers=-1),
    "plain": {"type": "shared_fs", "host_path": "/x"},
}


@pytest.mark.parametrize("name", list(CONFIG_CASES))
def test_cas_config_as_jax(name):
    raw = CONFIG_CASES[name]
    out = {}
    for side_name, side in SIDES.items():
        try:
            out[side_name] = ("ok", side.StorageConfig.from_dict(
                raw).to_dict())
        except ValueError as e:
            out[side_name] = (type(e).__name__, str(e))
    assert out["port"] == out["jax"]


def build_scenario(side, tmp):
    cfg = side.StorageConfig.from_dict({
        "type": "cas", "chunk_size_kb": 1, "transfer_workers": 0,
        "cache_path": str(tmp / "cache"), "cache_size_mb": 1,
        "inner": {"type": "shared_fs", "host_path": str(tmp / "s")}})
    mgr = side.storage.build(cfg)
    plain = side.storage.build(side.StorageConfig.from_dict(
        {"type": "shared_fs", "host_path": str(tmp / "s")}))
    return (type(mgr).__name__, type(mgr._inner).__name__, mgr._chunk_size,
            mgr._cache.max_bytes, mgr._pool.workers,
            isinstance(plain, side.storage.CASStorageManager))


def test_build_wires_cas_chain_as_jax(tmp_path):
    assert both(build_scenario, tmp_path) == (
        "CASStorageManager", "SharedFSStorageManager", 1024, 1 << 20, 0,
        False)


# -- the CLI -------------------------------------------------------------------

def cli_scenario(side, tmp, capsys):
    mgr, _ = make_cas(side, tmp)
    write_payload(str(tmp / "src"), blob(18, 2 * CHUNK))
    mgr.upload(str(tmp / "src"), "ck-1")
    mgr.commit("ck-1")
    mgr.upload(str(tmp / "src"), "ck-2")
    mgr.commit("ck-2")
    mgr.kv_store().store({"fp": "f", "chain": "0"},
                         {"k": np.zeros((2, 4), np.float32)})
    capsys.readouterr()
    outs = []
    cfg = tmp / "exp.yaml"
    cfg.write_text("checkpoint_storage:\n  type: cas\n  inner:\n"
                   f"    type: shared_fs\n    host_path: {tmp / 'store'}\n")
    plain = tmp / "plain.yaml"
    plain.write_text("checkpoint_storage:\n  type: shared_fs\n"
                     f"  host_path: {tmp}\n")
    for argv in (["checkpoint", "stats", "--host-path", str(tmp / "store"),
                  "--cache-path", str(tmp / "cli-cache")],
                 ["checkpoint", "stats", "--config", str(cfg)],
                 ["checkpoint", "stats", "--config", str(plain)],
                 ["checkpoint", "stats"],
                 ["kv", "stats", "--config", str(cfg)],
                 ["kv", "stats", "--host-path", str(tmp / "store")],
                 ["kv", "stats", "--config", str(plain)]):
        rc = side.cli.main(argv)
        cap = capsys.readouterr()
        body = json.loads(cap.out) if rc == 0 else None
        if body is not None and "cache" in body:
            assert body["cache"].pop("path") == str(tmp / "cli-cache")
        # the KV index record holds a wall-clock stamp: its size can
        # differ by a digit between the two runs
        kv = (body or {}).get("namespaces", {}).get("kv", body or {})
        if "bytes" in kv:
            assert kv.pop("bytes") > 0
        outs.append((rc, body, cap.err.replace(str(tmp), "<tmp>")))
    return outs


def test_cli_checkpoint_and_kv_stats_as_jax(tmp_path, capsys):
    outs = both(cli_scenario, tmp_path, capsys)
    assert [rc for rc, _, _ in outs] == [0, 0, 2, 2, 0, 0, 2]
    assert outs[0][1]["cas_checkpoints"] == 2
    assert outs[0][1]["dedup_ratio"] == 2.0
    assert outs[4][1]["entries"] == 1


def test_the_same_state_saves_to_the_same_chunks(tmp_path):
    """The port's ``save_pytree`` stamps its npz entries with a fixed
    time, so a state saved again later (here 1.1 s later) is the same
    bytes and a ``type: cas`` store uploads none of it; the JAX package
    reads it. (``np.savez`` stamps the time of the save.)"""
    import time

    import torch

    from determined_clone_tpu.core import _serialization as jser
    from determined_clone_tpu_torch.core import _serialization as tser

    rng = np.random.RandomState(21)
    tree = {"w": torch.from_numpy(rng.randn(64, 300).astype(np.float32)),
            "b": {"x": torch.from_numpy(rng.randn(7).astype(np.float32)),
                  "n": 3}}
    mgr, inner = make_cas(SIDES["port"], tmp_path)
    uploaded = []
    for i in range(2):
        src = tmp_path / f"src{i}"
        tser.save_pytree(str(src / "state"), tree)
        before = mgr.session_stats["bytes_uploaded"]
        mgr.upload(str(src), f"ck-{i}")
        uploaded.append(mgr.session_stats["bytes_uploaded"] - before)
        if i == 0:
            time.sleep(1.1)
    assert read(tmp_path / "src0" / "state" / "shard-0.npz") == read(
        tmp_path / "src1" / "state" / "shard-0.npz")
    assert uploaded[0] > 0 and uploaded[1] == 0
    like = {"w": np.zeros((64, 300), np.float32),
            "b": {"x": np.zeros(7, np.float32), "n": 0}}
    loaded = jser.load_pytree(str(tmp_path / "src1" / "state"), like)
    np.testing.assert_array_equal(np.asarray(loaded["w"]),
                                  tree["w"].numpy())
    assert int(loaded["b"]["n"]) == 3
