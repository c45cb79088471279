"""The port's KV tiers on the CPU against the JAX package's: the params
fingerprint, chain keys and prefix inventory; the host tier's LRU order
and counters; the ``cas/kv/`` blob tier (spill, promote, and every torn,
corrupt or index-only blob a plain miss); the namespace sweep; the
prefix cache's spill, ``adopt`` and ``entries``; the engine with
``kv_store=`` in tokens and ``kv_*`` counters; and one CAS directory
shared by both packages, written by either and promoted by the other.

Tolerance: fingerprints, keys, digests, orders and counters are
compared exactly; tokens exactly (fp32 compute, where the two
frameworks differ only in summation order, far below the logit gaps of
these prompts); fp32 K/V bytes exactly, bf16 K/V bits exactly.
"""
import dataclasses
import glob
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_clone_tpu import faults as jfaults
from determined_clone_tpu.models import gpt as jgpt
from determined_clone_tpu.serving import bucketing as jbucket
from determined_clone_tpu.serving import engine as jengine
from determined_clone_tpu.serving import kv_cache as jkv
from determined_clone_tpu.serving import kv_store as jstore
from determined_clone_tpu.storage import base as jbase
from determined_clone_tpu.storage import cas as jcas
from determined_clone_tpu_torch import convert, faults
from determined_clone_tpu_torch.models import gpt as tgpt
from determined_clone_tpu_torch.serving import (
    BlockAllocator,
    BucketSpec,
    InferenceEngine,
    KVBlockStore,
    KVCacheConfig,
    PrefixCache,
    PrefixInventory,
    ReplicaFailed,
    params_fingerprint,
    prompt_chain_keys,
)
from determined_clone_tpu_torch.serving.kv_store import (
    payload_array,
    payload_fits,
)
from determined_clone_tpu_torch.storage import SharedFSStorageManager
from determined_clone_tpu_torch.storage import transfer
from determined_clone_tpu_torch.storage.cas import (
    KV_BLOB_PREFIX,
    BlobIntegrityError,
    BlobService,
    KVBlobStore,
    namespace_usage,
    sweep_namespace,
)

torch.set_num_threads(1)
if torch.get_num_interop_threads() != 1:
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:  # already fixed once inter-op work has run here
        pass

JCFG = dataclasses.replace(jgpt.GPTConfig.tiny(), compute_dtype=jnp.float32,
                           attention_impl="mha")
TCFG = dataclasses.replace(tgpt.GPTConfig.tiny(), compute_dtype=torch.float32,
                           attention_impl="mha")
LADDER = (2, 32)              # batch buckets (1, 2), prefill (8, 16, 32)
POOL = dict(num_blocks=12, block_size=8)
SYSTEM = [5, 9, 2, 7, 4, 8, 3, 6, 11, 13, 17, 19, 23, 29, 31, 37]  # 2 blocks
NEW = 6


@pytest.fixture(scope="module")
def models():
    """(jax, port) params: JAX ``init`` scaled by 10, so greedy tokens
    depend on the context (a fresh tiny GPT repeats its last token)."""
    jp = jax.jit(jgpt.init, static_argnums=1)(jax.random.PRNGKey(0), JCFG)
    jp = jax.tree_util.tree_map(lambda x: x * 10.0, jp)
    return jp, convert.params_from_numpy(jax.device_get(jp), "cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def payload(seed: int, nbytes: int = 1024) -> dict:
    rng = np.random.default_rng(seed)
    half = nbytes // 2
    return {"k": rng.standard_normal(half // 8).astype(np.float64),
            "v": rng.standard_normal(half // 8).astype(np.float64)}


def jax_engine(jparams, **kw):
    return jengine.InferenceEngine(
        jparams, JCFG, buckets=jbucket.BucketSpec.build(*LADDER),
        cache=jkv.KVCacheConfig(**POOL), prefix_cache=True, **kw)


def port_engine(tparams, cfg=TCFG, **kw):
    return InferenceEngine(tparams, cfg, buckets=BucketSpec.build(*LADDER),
                           cache=KVCacheConfig(**POOL), prefix_cache=True,
                           device="cpu", **kw)


def kv_counts(st):
    return (st.kv_host_hit_blocks, st.kv_cas_hit_blocks, st.kv_miss_blocks,
            st.kv_promoted_blocks, st.kv_spilled_blocks,
            st.prefix_hit_blocks, st.prefix_miss_blocks, st.free_blocks)


def tails(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 250, int(rng.integers(2, 7))).tolist()
            for _ in range(n)]


# -- keys, fingerprints, inventory ------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_fingerprint_matches_jax(models, dtype):
    jp, _ = models
    if dtype == "bfloat16":
        jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    tp = convert.params_from_numpy(jax.device_get(jp), "cpu",
                                   dtype=getattr(torch, dtype))
    assert all(t.dtype == getattr(torch, dtype)
               for t in jax.tree_util.tree_leaves(tp))
    assert params_fingerprint(tp) == jstore.params_fingerprint(jp)
    # one changed element changes it
    tp["embed"]["table"][0, 0] += 1.0
    assert params_fingerprint(tp) != jstore.params_fingerprint(jp)


def test_params_fingerprint_of_scalars_and_numpy_matches_jax():
    tree = {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
            "a": {"s": np.float32(2.5), "z": np.zeros((1,), np.int32)}}
    ttree = {"b": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "a": {"s": torch.tensor(2.5), "z": torch.zeros(1,
                                                          dtype=torch.int32)}}
    want = jstore.params_fingerprint(jax.tree_util.tree_map(jnp.asarray,
                                                            tree))
    assert params_fingerprint(tree) == want
    assert params_fingerprint(ttree) == want


@pytest.mark.parametrize("n,bs,cap", [(19, 8, 8), (3, 8, 8), (64, 8, 3),
                                      (40, 16, 8), (32, 4, 100)])
def test_prompt_chain_keys_match_jax(n, bs, cap):
    prompt = [(7 * i) % 250 + 1 for i in range(n)]
    keys = prompt_chain_keys(prompt, bs, cap)
    assert keys == jstore.prompt_chain_keys(prompt, bs, cap)
    assert len(keys) == min(n // bs, cap)


def test_prefix_inventory_matches_jax():
    keys = [f"{i:02x}" * 32 for i in range(40)]
    for top_k, bits in ((32, 256), (4, 64), (0, 256)):
        mine = PrefixInventory.build(keys, top_k=top_k, bits=bits)
        ref = jstore.PrefixInventory.build(keys, top_k=top_k, bits=bits)
        assert mine.to_dict() == ref.to_dict()
        probe = keys[:7] + ["ff" * 32] + keys[7:9]
        assert [mine.covers(k) for k in probe] == \
            [ref.covers(k) for k in probe]
        assert mine.coverage_depth(probe) == ref.coverage_depth(probe)
        back = PrefixInventory.from_dict(ref.to_dict())
        assert back.to_dict() == ref.to_dict()
    assert PrefixInventory.build([]).coverage_depth(keys[:3]) == 0


# -- host tier (KVBlockStore) -----------------------------------------------

def _host_script(store_cls, blob_store=None, budget=4096):
    """put/get/keys/contains script; the stats after every step."""
    store = store_cls(budget_bytes=budget, blob_store=blob_store)
    trace = []

    def snap(tag, extra=None):
        st = store.stats()
        st.pop("cas", None)
        trace.append((tag, st, store.keys("fp0"), extra))

    for i in range(6):
        store.put("fp0", f"{i:02d}" * 16, payload(i))
        snap(f"put{i}")
    store.put("fp0", "05" * 16, payload(5))  # duplicate
    store.put("fp1", "aa" * 16, payload(9, 256))
    snap("dup", store.keys("fp1"))
    for hx in ("03", "00", "05", "04", "00"):
        got = store.get("fp0", hx * 16)
        snap(f"get{hx}", None if got is None else got["k"].tolist())
    store.put("fp0", "big" * 16, payload(1, budget * 2))  # over budget
    snap("big", store.contains("fp0", "big" * 16))
    return trace


def test_host_tier_lru_script_matches_jax():
    assert _host_script(KVBlockStore) == _host_script(jstore.KVBlockStore)


def test_host_tier_cascade_to_cas_matches_jax(tmp_path):
    mine = _host_script(KVBlockStore, KVBlobStore(
        SharedFSStorageManager(str(tmp_path / "port"))), budget=2048)
    ref = _host_script(jstore.KVBlockStore, jcas.KVBlobStore(
        jbase.SharedFSStorageManager(str(tmp_path / "jax"))), budget=2048)
    assert mine == ref
    st = mine[-1][1]
    assert st["cas_spills"] >= st["host_evictions"] > 0 and st["cas_hits"] > 0


def test_host_tier_budget_must_be_positive():
    with pytest.raises(ValueError, match="budget_bytes"):
        KVBlockStore(budget_bytes=0)


# -- CAS tier (cas/kv/), both packages ----------------------------------------

PACKAGES = {
    "port": (KVBlobStore, SharedFSStorageManager, faults),
    "jax": (jcas.KVBlobStore, jbase.SharedFSStorageManager, jfaults),
}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_cas_kv_store_load_and_double_spill(tmp_path, pkg):
    blob_cls, fs_cls, _ = PACKAGES[pkg]
    blobs = blob_cls(fs_cls(str(tmp_path)))
    key = {"fingerprint": "fp", "chain": "ab" * 32}
    assert blobs.load(key) is None
    assert blobs.store(key, payload(3)) is True
    assert blobs.store(key, payload(3)) is True
    got = blobs.load(key)
    np.testing.assert_array_equal(got["k"], payload(3)["k"])
    assert blobs.contains(key)
    assert blobs.session["stores"] == 1
    assert blobs.session["duplicate_stores"] == 1
    st = blobs.stats()
    assert st["entries"] == 1 and st["objects"] == 2
    assert st["session"]["hits"] == 1 and st["session"]["misses"] == 1


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_cas_kv_torn_spill_is_a_plain_miss(tmp_path, pkg):
    blob_cls, fs_cls, fmod = PACKAGES[pkg]
    blobs = blob_cls(fs_cls(str(tmp_path)))
    key = {"fingerprint": "fp", "chain": "cd" * 32}
    plan = fmod.activate(fmod.plan_from_dict({"rules": [
        {"point": "kv_store.spill", "action": "truncate",
         "keep_bytes": 7, "times": 1}]}))
    try:
        blobs.store(key, payload(4))
    finally:
        fmod.deactivate(plan)
    assert blobs.load(key) is None
    assert blobs.session["misses"] >= 1 and blobs.session["errors"] >= 1


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_cas_kv_corrupt_blob_on_disk_is_a_plain_miss(tmp_path, pkg):
    blob_cls, fs_cls, _ = PACKAGES[pkg]
    blobs = blob_cls(fs_cls(str(tmp_path)))
    key = {"fingerprint": "fp", "chain": "ef" * 32}
    assert blobs.store(key, payload(5)) is True
    paths = [p for p in glob.glob(str(tmp_path) + "/**/kv/blobs/**",
                                  recursive=True) if os.path.isfile(p)]
    assert len(paths) == 1
    with open(paths[0], "r+b") as f:
        f.truncate(11)
    assert blobs.load(key) is None
    assert blobs.session["errors"] == 1


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_cas_kv_index_without_blob_is_a_plain_miss(tmp_path, pkg):
    blob_cls, fs_cls, _ = PACKAGES[pkg]
    blobs = blob_cls(fs_cls(str(tmp_path)))
    key = {"fingerprint": "fp", "chain": "0f" * 32}
    assert blobs.store(key, payload(6)) is True
    for p in glob.glob(str(tmp_path) + "/**/kv/blobs/**", recursive=True):
        if os.path.isfile(p):
            os.unlink(p)
    assert blobs.contains(key)  # the index alone is still there ...
    assert blobs.load(key) is None  # ... and serves nothing


def test_cas_kv_foreign_key_blob_is_a_plain_miss(tmp_path):
    """An index pointing at another key's blob can only serve wrong K/V:
    refused, a plain miss."""
    blobs = KVBlobStore(SharedFSStorageManager(str(tmp_path)))
    a = {"fingerprint": "fp", "chain": "aa" * 32}
    b = {"fingerprint": "fp", "chain": "bb" * 32}
    blobs.store(a, payload(1))
    blobs.store(b, payload(2))
    idx = glob.glob(str(tmp_path) + "/**/kv/index/*.json", recursive=True)
    docs = {p: open(p).read() for p in idx}
    import json
    by_key = {json.loads(t)["key"]["chain"]: p for p, t in docs.items()}
    doc_a = json.loads(docs[by_key["aa" * 32]])
    doc_b = json.loads(docs[by_key["bb" * 32]])
    doc_a["blob"] = doc_b["blob"]
    with open(by_key["aa" * 32], "w") as f:
        json.dump(doc_a, f)
    assert blobs.load(a) is None
    assert blobs.load(b) is not None


def test_sweep_namespace_matches_jax(tmp_path):
    """One ``cas/kv/`` directory (written by the port, copied with its
    mtimes) swept by each package to half its bytes: the same objects
    evicted, the same entries surviving."""
    import shutil

    inner = SharedFSStorageManager(str(tmp_path / "port"))
    blobs = KVBlobStore(inner)
    keys = [{"fingerprint": "fp", "chain": f"{i:02d}" * 32}
            for i in range(8)]
    for i, key in enumerate(keys):
        blobs.store(key, payload(i, 4096))
        time.sleep(0.01)  # distinct mtimes, oldest first
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    before = sum(namespace_usage(inner, "kv").values())
    out = {}
    for pkg, (blob_cls, fs_cls, _) in PACKAGES.items():
        fs = fs_cls(str(tmp_path / pkg))
        sweep = sweep_namespace if pkg == "port" else jcas.sweep_namespace
        res = sweep(fs, "kv", before // 2)
        store = blob_cls(fs)
        out[pkg] = (res, [store.load(k) is not None for k in keys])
    assert out["port"] == out["jax"]
    res, hits = out["port"]
    assert res["swept"] and res["evicted"] > 0
    assert res["bytes"] <= before // 2 and 0 < sum(hits) < 8


def test_kv_blob_store_budget_sweeps_every_n_stores(tmp_path):
    inner = SharedFSStorageManager(str(tmp_path))
    blobs = KVBlobStore(inner, budget_bytes=8192, sweep_every=4)
    for i in range(8):
        blobs.store({"fingerprint": "fp", "chain": f"{i:02d}" * 32},
                    payload(i, 4096))
    assert blobs.session["evictions"] > 0
    assert sum(namespace_usage(inner, "kv").values()) <= 8192 + 6000


# -- storage base: per-object delete, mtimes, absent files, the pool ----------

def test_storage_delete_files_mtimes_and_absent_download(tmp_path,
                                                          monkeypatch):
    fs = SharedFSStorageManager(str(tmp_path / "root"))
    src = tmp_path / "src"
    (src / "a" / "b").mkdir(parents=True)
    (src / "a" / "b" / "x.bin").write_bytes(b"x" * 10)
    (src / "y.bin").write_bytes(b"y" * 3)
    fs.upload(str(src), "sid")
    assert fs.list_files("sid") == {"a/b/x.bin": 10, "y.bin": 3}
    mt = fs.file_mtimes("sid", ["a/b/x.bin", "nope"])
    assert set(mt) == {"a/b/x.bin"}
    copies = []
    real_copy = SharedFSStorageManager._copy_out
    monkeypatch.setattr(SharedFSStorageManager, "_copy_out", staticmethod(
        lambda src, out: copies.append(src) or real_copy(src, out)))
    assert fs.has_file("sid", "a/b/x.bin") and fs.has_file("sid", "y.bin")
    assert not fs.has_file("sid", "missing.bin")
    assert not fs.has_file("no-such-sid", "y.bin")
    # a download retries an absent file as the JAX manager does
    # (STORAGE_IO_POLICY: 4 attempts) ...
    with pytest.raises(FileNotFoundError):
        fs.download("sid", str(tmp_path / "dst"), paths=["missing.bin"])
    assert len(copies) == 4
    fs.download("sid", str(tmp_path / "dst"), paths=["y.bin"])
    assert len(copies) == 5
    # ... while a KV tier miss asks has_file and never downloads
    del copies[:]
    blobs = KVBlobStore(fs)
    assert blobs.load({"fingerprint": "fp", "chain": "9a" * 32}) is None
    with pytest.raises(BlobIntegrityError):
        BlobService(fs, KV_BLOB_PREFIX).get("0" * 64)
    assert copies == []
    fs.delete_files("sid", ["a/b/x.bin", "already-gone"])
    assert fs.list_files("sid") == {"y.bin": 3}
    assert not (tmp_path / "root" / "sid" / "a").exists()  # pruned
    with fs.restore_path("sid", str(tmp_path)) as d:
        assert os.path.dirname(d) == str(tmp_path)
        assert open(os.path.join(d, "y.bin")).read() == "yyy"


def test_transfer_pool_runs_every_task_and_raises_the_first_error():
    pool = transfer.TransferPool(workers=3)
    try:
        out = []
        pool.run([lambda i=i: out.append(i) for i in range(50)])
        assert sorted(out) == list(range(50))

        def boom():
            raise OSError("disk")
        with pytest.raises(OSError, match="disk"):
            pool.run([lambda: None, boom, lambda: None])
    finally:
        pool.shutdown()
    inline = transfer.TransferPool(workers=0)
    order = []
    inline.run([lambda i=i: order.append(i) for i in range(5)])
    assert order == list(range(5))


# -- prefix cache: spill on eviction, adopt, entries ---------------------------

def test_prefix_cache_spill_adopt_entries_script_matches_jax():
    cfg = dict(num_blocks=10, block_size=4)
    ta = BlockAllocator(KVCacheConfig(**cfg))
    ja = jkv.BlockAllocator(jkv.KVCacheConfig(**cfg))
    tspill, jspill = [], []
    tc = PrefixCache(KVCacheConfig(**cfg), ta,
                     spill=lambda k, b, d: tspill.append((k, b, d)))
    jc = jkv.PrefixCache(jkv.KVCacheConfig(**cfg), ja,
                         spill=lambda k, b, d: jspill.append((k, b, d)))
    p1 = list(range(1, 11))   # 2 full blocks + a tail of 2
    p2 = list(range(1, 9)) + [50, 51, 52, 53]
    for alloc, cache, spills in ((ta, tc, tspill), (ja, jc, jspill)):
        b1 = alloc.allocate(len(p1))
        cache.register(p1, b1)
        alloc.release(b1)
        b2 = alloc.allocate(len(p2))
        cache.register(p2, b2)
        alloc.release(b2)
        key = PrefixCache._chain(b"", [90, 91, 92, 93])
        blk = alloc.allocate_blocks(1)[0]
        cache.adopt(key, blk, 0)
        assert cache.has_key(key)
        with pytest.raises(ValueError):
            cache.adopt(key, blk, 0)
        cache.evict(alloc.free_blocks() + 3)
    assert tc.entries() == jc.entries()
    assert tspill == jspill and tspill
    assert all(d >= 0 for _, _, d in tspill)
    assert ta.free_blocks() == ja.free_blocks()
    assert [ta.refcount(b) for b in range(10)] == \
        [ja.refcount(b) for b in range(10)]
    assert tc.flush() == jc.flush()  # flush never spills
    assert tspill == jspill


# -- payload representation -----------------------------------------------------

def test_payload_arrays_keep_exact_bits_and_fit_only_their_pool():
    gen = torch.Generator().manual_seed(0)
    shape = (2, 5, 3, 8, 4)  # [L, N, bs, H, hd]
    p32 = torch.randn(shape, generator=gen)
    p16 = torch.randn(shape, generator=gen).to(torch.bfloat16)
    a32, a16 = payload_array(p32[:, 2]), payload_array(p16[:, 2])
    assert isinstance(a32, np.ndarray) and a32.dtype == np.float32
    assert isinstance(a16, torch.Tensor) and a16.dtype == torch.bfloat16
    np.testing.assert_array_equal(a32, p32[:, 2].numpy())
    assert torch.equal(a16.view(torch.int16), p16[:, 2].view(torch.int16))
    p16[:, 2] = 0  # a copy, never a view of the pool
    assert not torch.equal(a16, p16[:, 2])
    assert payload_fits(a32, p32) and payload_fits(a16, p16)
    assert not payload_fits(a16, p32) and not payload_fits(a32, p16)
    assert not payload_fits(torch.from_numpy(a32), p32)  # fp32: numpy only
    assert not payload_fits(a16.float().numpy(), p16)    # never via fp32
    assert not payload_fits(a32[:1], p32) and not payload_fits(None, p32)


# -- the engine with kv_store= -------------------------------------------------

def _tier_script(eng, prompts):
    """Serve each prompt alone (deterministic admission order); the pool
    of 12 blocks forces evictions, which spill; then serve the first
    prompts again (promotions)."""
    out = [eng.generate(p, NEW, timeout=120.0).tokens for p in prompts]
    out += [eng.generate(p, NEW, timeout=120.0).tokens for p in prompts[:3]]
    eng.wait_idle()
    return out


def test_engine_kv_store_tokens_and_counters_match_jax(models):
    jp, tp = models
    prompts = [SYSTEM[:8 * (1 + i % 2)] + t for i, t in enumerate(tails(6))]
    prompts += [[90 + i] * 17 for i in range(3)]
    with port_engine(tp, kv_store=KVBlockStore()) as eng:
        mine = _tier_script(eng, prompts)
        mine_stats = kv_counts(eng.stats())
    with jax_engine(jp, kv_store=jstore.KVBlockStore()) as eng:
        ref = _tier_script(eng, prompts)
        ref_stats = kv_counts(eng.stats())
    assert mine == ref
    assert mine_stats == ref_stats
    host, cas, miss, promoted, spilled = mine_stats[:5]
    assert spilled > 0 and promoted == host > 0 and cas == 0 and miss > 0


def test_engine_kv_store_requires_prefix_cache(models):
    _, tp = models
    with pytest.raises(ValueError, match="prefix_cache"):
        InferenceEngine(tp, TCFG, kv_store=KVBlockStore(), device="cpu")


def test_flush_and_promote_into_another_engine_bit_exact(models):
    """Engine A flushes its resident blocks; engine B (same weights)
    promotes them into its own pool: every promoted block's K/V equal
    A's bit for bit, in fp32 and bf16; the tokens equal A's."""
    _, tp = models
    for cfg in (TCFG, dataclasses.replace(TCFG,
                                          compute_dtype=torch.bfloat16)):
        store = KVBlockStore()
        prompt = SYSTEM + [41, 42, 43]
        with port_engine(tp, cfg, kv_store=store) as a:
            want = a.generate(prompt, NEW).tokens
            a.wait_idle()
            assert a.flush_kv_to_tier() == 2
            a_blocks = {k: b for k, b, _ in a._prefix.entries()}
            a_k, a_v = a._k_pool.clone(), a._v_pool.clone()
        with port_engine(tp, cfg, kv_store=store) as b:
            b.generate([200, 201, 202], 2)  # occupy other blocks first
            got = b.generate(prompt, NEW).tokens
            b.wait_idle()
            st = b.stats()
            b_blocks = {k: blk for k, blk, _ in b._prefix.entries()}
            for key, blk in a_blocks.items():
                for mine, src in ((b._k_pool, a_k), (b._v_pool, a_v)):
                    x, y = mine[:, b_blocks[key]], src[:, blk]
                    bits = torch.int16 if x.dtype == torch.bfloat16 \
                        else torch.int32
                    assert torch.equal(x.contiguous().view(bits),
                                       y.contiguous().view(bits))
        assert got == want
        assert st.kv_host_hit_blocks == st.kv_promoted_blocks == 2
        assert st.kv_miss_blocks == 0


def test_foreign_payload_is_a_plain_miss(models):
    """A tier entry under the engine's own key whose arrays do not fit
    the pools (an fp32 payload for bf16 pools) is a miss, never a
    write: the block is prefilled and the tokens stay right."""
    _, tp = models
    cfg = dataclasses.replace(TCFG, compute_dtype=torch.bfloat16)
    store = KVBlockStore()
    prompt = SYSTEM + [41, 42]
    with port_engine(tp, cfg, kv_store=store) as eng:
        want = eng.generate(prompt, NEW).tokens
        fp = eng._params_fp
        shape = (cfg.n_layers, 8, cfg.n_heads, cfg.head_dim)
    for key in prompt_chain_keys(prompt, 8, 8):
        store.put(fp, key, {"k": np.zeros(shape, np.float32),
                            "v": np.zeros(shape, np.float32)})
    with port_engine(tp, cfg, kv_store=store) as eng:
        got = eng.generate(prompt, NEW).tokens
        st = eng.stats()
    assert got == want
    assert st.kv_miss_blocks == 1 and st.kv_promoted_blocks == 0


def test_hot_swap_changes_the_tier_scope(models):
    _, tp = models
    store = KVBlockStore()
    prompt = SYSTEM + [41, 42]
    def times3(tree):
        return ({k: times3(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree * 3.0)
    other = times3(tp)
    with port_engine(tp, kv_store=store) as eng:
        eng.generate(prompt, NEW)
        eng.wait_idle()
        eng.flush_kv_to_tier()
        fp_old = eng._params_fp
        eng.hot_swap(other)
        eng.generate([1, 2, 3], 1)
        assert eng._params_fp == params_fingerprint(other) != fp_old
        eng.generate(prompt, NEW)  # the old weights' blocks: not served
        st = eng.stats()
    assert st.kv_promoted_blocks == 0 and st.kv_miss_blocks >= 1
    assert store.keys(fp_old)  # still there, for a rollback


def test_prefix_inventory_lists_resident_then_host_keys(models):
    _, tp = models
    store = KVBlockStore()
    with port_engine(tp, kv_store=store) as eng:
        assert PrefixInventory.from_dict(
            eng.prefix_inventory()).coverage_depth(
                prompt_chain_keys(SYSTEM, 8, 8)) == 0
        eng.generate(SYSTEM + [1, 2], NEW)
        eng.wait_idle()
        inv = eng.prefix_inventory()
        assert PrefixInventory.from_dict(inv).coverage_depth(
            prompt_chain_keys(SYSTEM, 8, 8)) == 2
        store.put(eng._params_fp, "ab" * 32, payload(0))
        assert "ab" * 32 in eng.prefix_inventory()["top"]
    with port_engine(tp) as eng:
        assert eng.prefix_inventory() is not None
    with InferenceEngine(tp, TCFG, device="cpu") as eng:
        assert eng.prefix_inventory() is None


def test_promote_fault_point_kills_the_scheduler_like_jax(models):
    """A rule at ``kv_store.promote`` fires only when promotion writes
    are pending, and an error there fails the request with
    ReplicaFailed in both packages."""
    jp, tp = models
    prompt = SYSTEM + [41, 42]
    outcome = {}
    for pkg, (mk, store_cls, fmod, params) in {
            "port": (port_engine, KVBlockStore, faults, tp),
            "jax": (jax_engine, jstore.KVBlockStore, jfaults, jp)}.items():
        store = store_cls()
        with mk(params, kv_store=store) as eng:
            eng.generate(prompt, NEW)
            eng.wait_idle()
            eng.flush_kv_to_tier()
            eng.hot_swap(params)  # same weights: drops the resident copies
            plan = fmod.activate(fmod.plan_from_dict({"rules": [
                {"point": "kv_store.promote", "action": "error",
                 "times": 1}]}))
            try:
                eng.generate([7, 8, 9], 2)  # nothing to promote: no fire
                fired_before = plan.rules[0].fires
                with pytest.raises(ReplicaFailed if pkg == "port"
                                   else jengine.ReplicaFailed):
                    eng.generate(prompt, NEW)
                outcome[pkg] = (fired_before, plan.rules[0].fires,
                                eng.liveness()["fatal"] is not None)
            finally:
                fmod.deactivate(plan)
            eng.assert_kv_balanced(0)
    assert outcome["port"] == outcome["jax"] == (0, 1, True)


# -- one CAS directory, both packages ---------------------------------------------

def _jax_fleet(jp, store, name):
    from determined_clone_tpu.serving.fleet import ServingFleet as JFleet
    return JFleet(jp, JCFG, name=name, buckets=jbucket.BucketSpec.build(
        *LADDER), cache=jkv.KVCacheConfig(**POOL), warmup=False,
        prefix_cache=True, kv_store=store, tracing=False)


def _port_fleet(tp, store, name):
    from determined_clone_tpu_torch.serving import ServingFleet
    return ServingFleet(tp, TCFG, name=name, buckets=BucketSpec.build(
        *LADDER), cache=KVCacheConfig(**POOL), warmup=False,
        prefix_cache=True, kv_store=store, tracing=False, device="cpu")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cas_directory_written_by_one_package_promoted_by_the_other(
        models, tmp_path, direction):
    """One package's fleet serves a prompt and closes (its replicas flush
    to a host tier with a budget below one block, so every block lands in
    ``cas/kv/``); a fleet of the other package on the same directory
    serves the prompt by promoting the blocks from CAS, with the same
    tokens (fp32)."""
    jp, tp = models
    prompt = SYSTEM + [41, 42, 43]
    block_bytes = 2 * TCFG.n_layers * 8 * TCFG.d_model * 4
    budget = block_bytes // 2
    jstore_ = jstore.KVBlockStore(budget_bytes=budget, blob_store=(
        jcas.KVBlobStore(jbase.SharedFSStorageManager(str(tmp_path)))))
    tstore = KVBlockStore(budget_bytes=budget, blob_store=KVBlobStore(
        SharedFSStorageManager(str(tmp_path))))
    writer, reader = ((_jax_fleet(jp, jstore_, "w"),
                       _port_fleet(tp, tstore, "r"))
                      if direction == "jax_to_port" else
                      (_port_fleet(tp, tstore, "w"),
                       _jax_fleet(jp, jstore_, "r")))
    try:
        writer.scale_up(1)
        want, _ = writer.handle_request(prompt, NEW, timeout=120.0)
    finally:
        writer.close()
    assert len(glob.glob(str(tmp_path) + "/cas/kv/index/*.json")) == 2
    try:
        reader.scale_up(1)
        got, _ = reader.handle_request(prompt, NEW, timeout=120.0)
        st = reader.replicas()[0].engine.stats()
    finally:
        reader.close()
    assert list(got.tokens) == list(want.tokens)
    assert st.kv_cas_hit_blocks == st.kv_promoted_blocks == 2
    assert st.kv_host_hit_blocks == 0 and st.kv_miss_blocks == 0
