"""Content-addressed blob storage (CAS) — the port's copy of
``determined_clone_tpu/storage/cas.py``: chunk-level dedup, a local
chunk cache, and the KV spill tier.

The reserved ``cas/`` storage_id is a content-addressed blob store with
two clients in the port:

- **checkpoint chunks** (``cas/chunks/``): :class:`CASStorageManager`
  sits between ``CheckpointContext`` and any concrete
  :class:`~determined_clone_tpu_torch.storage.base.StorageManager`. It
  splits checkpoint payload files into fixed-size chunks keyed by their
  sha256, stores each chunk once, and writes a per-upload chunk manifest
  beside the ``manifest.json``/``COMMIT`` protocol files, so successive
  checkpoints re-upload only the chunks that changed.
- **spilled KV blocks** (``cas/kv/``): :class:`KVBlobStore` is the
  durable tier of the fleet KV memory hierarchy (serving/kv_store.py) —
  exact K/V block payloads keyed by the prefix cache's chained content
  hash, so a restarted or replacement replica warms shared prefixes by
  fetching instead of re-prefilling.

The JAX package's third client, the XLA executable cache under
``cas/exec/``, has no port (``ROADMAP.md``, Queue 1, item 6); the stats
still count its objects, so one store shared by both packages reads the
same from either.

The layout, the chunk manifests and the pickled KV record are the JAX
package's, so a store written by either package is read by the other.
Every blob read goes through :class:`BlobService`: digest-keyed object
paths, sha256 verification on every read, the local :class:`ChunkCache`
read-through, and the fault points. A checkpoint is restorable iff its
COMMIT marker exists and every chunk its manifests reference exists and
digest-verifies; a torn or missing chunk surfaces as
``CheckpointCorruptError``, which the trainer's restore walk handles.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import pickle
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from determined_clone_tpu_torch import faults
from determined_clone_tpu_torch.storage import transfer
from determined_clone_tpu_torch.storage.base import (
    COMMIT_FILE,
    StorageManager,
    _walk_relative,
)

logger = logging.getLogger(__name__)

# Reserved storage_id holding the shared blob objects; never a checkpoint.
# GC sweeps and list_storage_ids() skip it.
CHUNK_NAMESPACE = "cas"

# Blob namespaces inside the reserved storage_id. Chunk GC only ever
# deletes ``chunks/...`` rels (BlobService.rel), so ``exec/...`` and
# ``kv/...`` entries are never swept as orphan chunks; their lifecycle is
# the per-namespace budget sweep (:func:`sweep_namespace`).
CHUNK_PREFIX = "chunks"
EXEC_BLOB_PREFIX = "exec/blobs"
EXEC_INDEX_PREFIX = "exec/index"
KV_BLOB_PREFIX = "kv/blobs"
KV_INDEX_PREFIX = "kv/index"

# Per-upload-call chunk manifest written into the checkpoint's namespace:
# one file per upload() call (so sharded ranks never collide); restore
# merges every cas-manifest-*.json it finds.
CHUNK_MANIFEST_PREFIX = "cas-manifest-"

# Files stored verbatim in the checkpoint namespace: the commit-protocol
# files stay directly readable, and chunking them would gain nothing.
_PASSTHROUGH_FILES = ("manifest.json", "metadata.json", COMMIT_FILE)

DEFAULT_CHUNK_SIZE = 1 << 20  # 1 MiB
DEFAULT_CACHE_BYTES = 256 << 20


def _is_chunk_manifest(rel: str) -> bool:
    return rel.startswith(CHUNK_MANIFEST_PREFIX) and rel.endswith(".json")


def _is_passthrough(rel: str) -> bool:
    return rel in _PASSTHROUGH_FILES or _is_chunk_manifest(rel)


def chunk_rel(digest: str) -> str:
    """Backend-relative object path of a chunk."""
    return f"{CHUNK_PREFIX}/{digest[:2]}/{digest}"


def _sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _sha256_file(path: str, block: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for piece in iter(lambda: f.read(block), b""):
            h.update(piece)
    return h.hexdigest()


def _corrupt(storage_id: str, reason: str) -> Exception:
    # lazy import: core._checkpoint imports storage.base
    from determined_clone_tpu_torch.core._checkpoint import (
        CheckpointCorruptError,
    )

    return CheckpointCorruptError(storage_id, reason)


class ChunkCache:
    """Local on-disk LRU chunk cache, keyed by sha256, size-capped.

    Every hit is digest-verified before it is served — a corrupted entry
    is discarded and counts as a miss, so the cache never launders bad
    bytes into a restore. Hit/miss counters persist in ``stats.json``
    (flushed every :data:`FLUSH_EVERY` lookups and on every ``stats()``
    call) so ``checkpoint stats`` reports the hit rate across processes.
    Recency is the files' mtimes (touched on every hit), which survives
    restarts. Two processes may share a cache path: every filesystem
    operation tolerates entries vanishing underneath it, a foreign
    eviction being a plain miss. The layout is the JAX package's.
    """

    FLUSH_EVERY = 64

    def __init__(self, path: str,
                 max_bytes: int = DEFAULT_CACHE_BYTES) -> None:
        if max_bytes < 1:
            raise ValueError(f"cache max_bytes must be >= 1, got {max_bytes}")
        self.path = path
        self.max_bytes = max_bytes
        self._dir = os.path.join(path, "chunks")
        self._stats_path = os.path.join(path, "stats.json")
        self._lock = threading.RLock()
        os.makedirs(self._dir, exist_ok=True)
        self._stats = {"hits": 0, "misses": 0}
        self._unflushed = 0
        if os.path.exists(self._stats_path):
            try:
                with open(self._stats_path) as f:
                    doc = json.load(f)
                self._stats["hits"] = int(doc.get("hits", 0))
                self._stats["misses"] = int(doc.get("misses", 0))
            except (ValueError, OSError):
                pass  # unreadable stats file: counters restart at zero

    def _entry(self, digest: str) -> str:
        return os.path.join(self._dir, digest)

    def _flush_stats(self) -> None:
        self._unflushed = 0
        try:
            tmp = self._stats_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._stats, f)
            os.replace(tmp, self._stats_path)
        except OSError:
            pass  # a cache that cannot persist counters must not fail I/O

    def _note(self, key: str) -> None:
        self._stats[key] += 1
        self._unflushed += 1
        if self._unflushed >= self.FLUSH_EVERY:
            self._flush_stats()

    def get(self, digest: str) -> Optional[str]:
        """Path of the verified cached chunk, or None (counted as a miss)."""
        with self._lock:
            p = self._entry(digest)
            try:
                if os.path.exists(p) and _sha256_file(p) == digest:
                    os.utime(p)  # LRU touch
                    self._note("hits")
                    return p
                if os.path.exists(p):
                    # a torn cache write or bit rot: evict, so the next
                    # restore re-fetches the real bytes
                    os.remove(p)
            except FileNotFoundError:
                pass  # another process evicted it mid-check: a miss
            self._note("misses")
            return None

    def put(self, digest: str, data: bytes) -> str:
        with self._lock:
            p = self._entry(digest)
            with contextlib.suppress(FileNotFoundError):
                if os.path.exists(p):
                    os.utime(p)
                    return p
            fd, tmp = tempfile.mkstemp(dir=self._dir, prefix=".put-")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                os.replace(tmp, p)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            self._evict(keep=digest)
            return p

    def _evict(self, keep: str) -> None:
        entries = []
        for name in os.listdir(self._dir):
            ep = os.path.join(self._dir, name)
            try:
                if os.path.isfile(ep) and not name.startswith("."):
                    entries.append((os.path.getmtime(ep),
                                    os.path.getsize(ep), name, ep))
            except FileNotFoundError:
                pass  # vanished between listdir and stat (shared cache)
        total = sum(e[1] for e in entries)
        # oldest first, but never the entry just written (a cache smaller
        # than one chunk would otherwise thrash forever)
        for _, size, name, ep in sorted(entries):
            if total <= self.max_bytes:
                return
            if name == keep:
                continue
            with contextlib.suppress(FileNotFoundError):
                os.remove(ep)
            total -= size

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            sizes = []
            for n in os.listdir(self._dir):
                p = os.path.join(self._dir, n)
                try:
                    if not n.startswith(".") and os.path.isfile(p):
                        sizes.append(os.path.getsize(p))
                except FileNotFoundError:
                    pass  # vanished between listdir and stat (shared cache)
            self._flush_stats()  # make the durable counters current
            hits, misses = self._stats["hits"], self._stats["misses"]
            looked = hits + misses
            return {
                "path": self.path,
                "entries": len(sizes),
                "bytes": sum(sizes),
                "max_bytes": self.max_bytes,
                "hits": hits,
                "misses": misses,
                "hit_rate": round(hits / looked, 4) if looked else None,
            }


class BlobIntegrityError(Exception):
    """A blob is missing from the store or fails digest verification."""

    def __init__(self, digest: str, reason: str, *,
                 missing: bool = False) -> None:
        super().__init__(f"blob {digest[:12]}…: {reason}")
        self.digest = digest
        self.reason = reason
        self.missing = missing


class BlobService:
    """Digest-keyed blob transport over the reserved ``cas`` storage_id,
    one instance per namespace (``prefix``):

    - objects live at ``<prefix>/<digest[:2]>/<digest>`` (fanned out so
      shared_fs directories stay enumerable);
    - every read is sha256-verified against its key before it is served
      (:class:`BlobIntegrityError` on mismatch — a torn object can never
      launder bad bytes into a pool);
    - ``fault_store`` / ``fault_drop`` / ``fault_load`` name the
      injection points (faults/core.py) for torn writes, lost objects,
      and failed reads;
    - an optional local :class:`ChunkCache` serves repeat reads without
      touching the backend (itself digest-verified per hit).

    The ``counter`` hook receives ``(key, n)`` accounting events
    (``cache_hits`` / ``cache_misses`` / ``bytes_downloaded``) so the
    owning manager folds them into its session stats.
    """

    def __init__(self, inner: StorageManager, prefix: str = CHUNK_PREFIX, *,
                 cache: Optional[ChunkCache] = None,
                 fault_store: Optional[str] = None,
                 fault_drop: Optional[str] = None,
                 fault_load: Optional[str] = None,
                 counter: Optional[Any] = None) -> None:
        self._inner = inner
        self.prefix = prefix
        self._cache = cache
        self._fault_store = fault_store
        self._fault_drop = fault_drop
        self._fault_load = fault_load
        self._count = counter if counter is not None else (lambda k, n: None)

    def rel(self, digest: str) -> str:
        """Backend-relative object path of a blob."""
        return f"{self.prefix}/{digest[:2]}/{digest}"

    def digest_of_rel(self, rel: str) -> Optional[str]:
        """Inverse of :meth:`rel`; None for anything outside this
        namespace (another namespace's blobs, index files, strays)."""
        head = self.prefix + "/"
        if not rel.startswith(head):
            return None
        parts = rel[len(head):].split("/")
        if (len(parts) == 2 and len(parts[1]) == 64
                and parts[0] == parts[1][:2]):
            return parts[1]
        return None

    def list_blobs(self) -> Dict[str, int]:
        """digest -> size for every blob in this namespace RIGHT NOW
        (fresh backend listing, no memo)."""
        listing = self._inner.list_files(CHUNK_NAMESPACE)
        out: Dict[str, int] = {}
        for rel, size in listing.items():
            d = self.digest_of_rel(rel)
            if d is not None:
                out[d] = int(size)
        return out

    def put(self, data: bytes, *, digest: Optional[str] = None
            ) -> Optional[str]:
        """Store bytes under their sha256 (or a caller-supplied digest —
        the chunk path already hashed during scan). Returns the digest,
        or None when an injected drop swallowed the object (the caller
        decides whether that is fatal)."""
        if digest is None:
            digest = _sha256_bytes(data)
        if self._fault_store is not None:
            faults.point(self._fault_store)
        if (self._fault_drop is not None
                and faults.truncate_bytes(self._fault_drop) is not None):
            return None
        rel = self.rel(digest)
        with tempfile.TemporaryDirectory(prefix="dct-blob-up-") as stage:
            staged = os.path.join(stage, rel)
            os.makedirs(os.path.dirname(staged), exist_ok=True)
            with open(staged, "wb") as f:
                f.write(data)
            if self._fault_store is not None:
                keep = faults.truncate_bytes(self._fault_store)
                if keep is not None:
                    # injected torn object: truncated bytes land under the
                    # full digest's key — read-side digest-verify convicts
                    with open(staged, "r+b") as f:
                        f.truncate(keep)
            self._inner.upload(stage, CHUNK_NAMESPACE, paths=[rel])
        if self._cache is not None:
            self._cache.put(digest, data)
        return digest

    def get(self, digest: str) -> bytes:
        """Fetch + digest-verify one blob (cache first, then backend).
        Raises :class:`BlobIntegrityError` when missing or torn."""
        if self._fault_load is not None:
            faults.point(self._fault_load)
        if self._cache is not None:
            hit = self._cache.get(digest)
            if hit is not None:
                self._count("cache_hits", 1)
                with open(hit, "rb") as f:
                    return f.read()
            self._count("cache_misses", 1)
        rel = self.rel(digest)
        if not self._inner.has_file(CHUNK_NAMESPACE, rel):
            raise BlobIntegrityError(
                digest, "missing from the blob store", missing=True)
        with tempfile.TemporaryDirectory(prefix="dct-blob-dl-") as tmp:
            try:
                self._inner.download(CHUNK_NAMESPACE, tmp, paths=[rel])
                with open(os.path.join(tmp, rel), "rb") as f:
                    data = f.read()
            except (FileNotFoundError, KeyError):
                raise BlobIntegrityError(
                    digest, "missing from the blob store",
                    missing=True) from None
        if _sha256_bytes(data) != digest:
            raise BlobIntegrityError(
                digest, "content digest mismatch (torn blob)")
        self._count("bytes_downloaded", len(data))
        if self._cache is not None:
            self._cache.put(digest, data)
        return data

    def delete(self, digests: Iterable[str]) -> None:
        self._inner.delete_files(
            CHUNK_NAMESPACE, [self.rel(d) for d in sorted(digests)])


def namespace_usage(inner: StorageManager, namespace: str) -> Dict[str, int]:
    """rel -> size for every object (blobs AND index files) under one
    blob namespace (``exec``/``kv``) of the reserved ``cas`` storage_id."""
    head = namespace.rstrip("/") + "/"
    try:
        listing = inner.list_files(CHUNK_NAMESPACE)
    except (FileNotFoundError, KeyError):
        return {}
    return {rel: int(size) for rel, size in listing.items()
            if rel.startswith(head)}


def sweep_namespace(inner: StorageManager, namespace: str,
                    budget_bytes: int) -> Dict[str, Any]:
    """LRU-by-mtime byte-budget sweep for one blob namespace (``exec`` or
    ``kv``).

    Deletes the oldest objects (by backend mtime, via the optional
    ``file_mtimes`` capability) until the namespace fits its budget.
    Objects are evicted individually — an index whose blob got swept
    (or vice versa) is harmless, because :class:`KVBlobStore` treats
    ANY load failure as a plain miss and re-creates the pair on the
    next store. Backends that cannot stat mtimes or delete per-object
    skip the sweep gracefully (``swept: False``).
    """
    usage = namespace_usage(inner, namespace)
    total = sum(usage.values())
    out: Dict[str, Any] = {"namespace": namespace, "swept": True,
                           "budget_bytes": int(budget_bytes),
                           "evicted": 0, "evicted_bytes": 0,
                           "bytes": total}
    if total <= budget_bytes:
        return out
    try:
        mtimes = inner.file_mtimes(CHUNK_NAMESPACE, sorted(usage))
    except NotImplementedError:
        out["swept"] = False
        return out
    # oldest first; objects the backend could not stat sort first (age
    # unknown — most likely vanished already, deleting them is a no-op)
    order = sorted(usage, key=lambda rel: (mtimes.get(rel, 0.0), rel))
    doomed: List[str] = []
    for rel in order:
        if total <= budget_bytes:
            break
        doomed.append(rel)
        total -= usage[rel]
        out["evicted"] += 1
        out["evicted_bytes"] += usage[rel]
    if doomed:
        try:
            inner.delete_files(CHUNK_NAMESPACE, doomed)
        except NotImplementedError:
            return {**out, "swept": False, "evicted": 0,
                    "evicted_bytes": 0, "bytes": sum(usage.values())}
        logger.info("cas namespace sweep: %s evicted %d objects "
                    "(%d bytes) to fit %d-byte budget",
                    namespace, out["evicted"], out["evicted_bytes"],
                    budget_bytes)
    out["bytes"] = total
    return out


class KVBlobStore:
    """CAS tier of the fleet KV memory hierarchy (serving/kv_store.py).

    Third (durable, cross-process) level of the device → host → CAS
    hierarchy: exact K/V block payloads spilled by any replica land
    under ``cas/kv/`` and can warm a restarted or replacement replica
    in another process. The layout is a content-addressed pickle blob
    under ``kv/blobs/`` plus one small JSON index record per chain key
    under ``kv/index/``: every blob read is sha256-verified,
    the pickled payload carries its key for a final cross-check, and
    EVERY failure mode (missing index, torn blob, foreign-blob index,
    unpickling error, injected fault) degrades to a *plain miss*. The
    engine then re-prefills, so the tier can only ever serve exact
    bytes or nothing — which is what keeps greedy decoding
    bit-identical.

    ``kv_store.spill`` / ``kv_store.fetch`` fault points fire here;
    torn spills are injected by truncating
    the staged blob under its full digest's key, so the fetch-side
    digest check convicts.
    """

    def __init__(self, inner: StorageManager, *,
                 budget_bytes: Optional[int] = None,
                 sweep_every: int = 32) -> None:
        self._inner = inner
        self._blobs = BlobService(inner, KV_BLOB_PREFIX)
        self.budget_bytes = budget_bytes
        self.sweep_every = max(1, int(sweep_every))
        self._lock = threading.Lock()
        self._since_sweep = 0
        self.session: Dict[str, int] = {
            "hits": 0, "misses": 0, "stores": 0, "duplicate_stores": 0,
            "errors": 0, "evictions": 0,
            "bytes_stored": 0, "bytes_loaded": 0,
        }

    @staticmethod
    def key_digest(key: Dict[str, str]) -> str:
        """Stable digest of a tier key (params fingerprint + chain
        hash); names the index record."""
        return _sha256_bytes(
            json.dumps(key, sort_keys=True).encode("utf-8"))

    @staticmethod
    def _index_rel(key_digest: str) -> str:
        return f"{KV_INDEX_PREFIX}/{key_digest}.json"

    def _note(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.session[key] += n

    def _read_index(self, key_digest: str) -> Optional[Dict[str, Any]]:
        rel = self._index_rel(key_digest)
        if not self._inner.has_file(CHUNK_NAMESPACE, rel):
            return None
        with tempfile.TemporaryDirectory(prefix="dct-kv-idx-") as tmp:
            try:
                self._inner.download(CHUNK_NAMESPACE, tmp, paths=[rel])
                with open(os.path.join(tmp, rel)) as f:
                    return json.load(f)
            except (FileNotFoundError, KeyError, ValueError, OSError):
                return None

    def store(self, key: Dict[str, str], payload: Dict[str, Any]) -> bool:
        """Spill one block's exact K/V arrays. Returns True when the
        entry is durable — an already-present chain key counts (any
        replica may race to spill a popular prefix; double-spill is an
        idempotent no-op), False when an injected drop swallowed the
        blob (no index is written, so readers see a plain miss)."""
        faults.point("kv_store.spill")
        key = dict(key)
        digest_key = self.key_digest(key)
        existing = self._read_index(digest_key)
        if existing is not None and existing.get("key") == key:
            self._note("duplicate_stores")
            return True
        doc = pickle.dumps({"format": 1, "key": key, "payload": payload},
                           protocol=pickle.HIGHEST_PROTOCOL)
        digest = _sha256_bytes(doc)
        data = doc
        keep = faults.truncate_bytes("kv_store.spill")
        if keep is not None:
            # injected torn spill: truncated bytes land under the full
            # digest's key — the fetch-side digest check convicts
            data = doc[:keep]
        if self._blobs.put(data, digest=digest) is None:
            return False
        index = {"format": 1, "key": key, "blob": digest,
                 "size": len(doc), "created": time.time()}
        rel = self._index_rel(digest_key)
        with tempfile.TemporaryDirectory(prefix="dct-kv-up-") as stage:
            staged = os.path.join(stage, rel)
            os.makedirs(os.path.dirname(staged), exist_ok=True)
            with open(staged, "w") as f:
                json.dump(index, f, indent=1)
            self._inner.upload(stage, CHUNK_NAMESPACE, paths=[rel])
        self._note("stores")
        self._note("bytes_stored", len(doc))
        self._maybe_sweep()
        return True

    def load(self, key: Dict[str, str]) -> Optional[Dict[str, Any]]:
        """Exact K/V payload for a chain key, or None — a plain miss.
        Every failure (missing/torn blob, index pointing at a foreign
        blob, unpickling error) lands here as a miss: the caller
        re-prefills, and wrong K/V is never served."""
        faults.point("kv_store.fetch")
        key = dict(key)
        try:
            entry = self._read_index(self.key_digest(key))
            if entry is None or entry.get("key") != key:
                self._note("misses")
                return None
            doc = pickle.loads(self._blobs.get(str(entry["blob"])))
            if doc.get("key") != key:
                # an index pointing at a foreign blob can only serve
                # WRONG K/V for this prefix — refuse, treat as a miss
                raise ValueError("kv blob key mismatch")
            payload = doc["payload"]
        except Exception as e:  # noqa: BLE001 — any failure is a miss
            logger.warning("kv tier fetch failed (treated as a miss): %s", e)
            self._note("misses")
            self._note("errors")
            return None
        self._note("hits")
        self._note("bytes_loaded", int(entry.get("size", 0)))
        return payload

    def contains(self, key: Dict[str, str]) -> bool:
        """Index-only presence probe (no blob fetch, no counters)."""
        key = dict(key)
        entry = self._read_index(self.key_digest(key))
        return entry is not None and entry.get("key") == key

    def _maybe_sweep(self) -> None:
        if self.budget_bytes is None:
            return
        with self._lock:
            self._since_sweep += 1
            if self._since_sweep < self.sweep_every:
                return
            self._since_sweep = 0
        self.sweep()

    def sweep(self) -> Dict[str, Any]:
        """Apply the byte budget now (LRU-by-mtime over ``cas/kv/``)."""
        if self.budget_bytes is None:
            return {"namespace": "kv", "swept": False,
                    "evicted": 0, "evicted_bytes": 0}
        res = sweep_namespace(self._inner, "kv", self.budget_bytes)
        self._note("evictions", int(res.get("evicted", 0)))
        return res

    def stats(self) -> Dict[str, Any]:
        usage = namespace_usage(self._inner, "kv")
        entries = sum(1 for rel in usage
                      if rel.startswith(KV_INDEX_PREFIX + "/"))
        with self._lock:
            session = dict(self.session)
        looked = session["hits"] + session["misses"]
        return {
            "entries": entries,
            "objects": len(usage),
            "bytes": sum(usage.values()),
            "budget_bytes": self.budget_bytes,
            "hit_rate": (round(session["hits"] / looked, 4)
                         if looked else None),
            "session": session,
        }



class CASStorageManager(StorageManager):
    """Content-addressed wrapper around a concrete storage backend.

    Presents the exact StorageManager interface (logical files in and
    out), so CheckpointContext and the commit protocol are unchanged; the
    chunking is invisible above this layer.
    """

    FETCH_WINDOW = 16  # chunks of one file fetched at once on a restore

    def __init__(self, inner: StorageManager, *,
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 cache: Optional[ChunkCache] = None,
                 pool: Optional[transfer.TransferPool] = None,
                 namespace_budgets: Optional[Dict[str, int]] = None) -> None:
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if isinstance(inner, CASStorageManager):
            raise ValueError("cas storage cannot nest another cas store")
        self._inner = inner
        self._chunk_size = chunk_size
        self._cache = cache
        self._pool = pool
        self._lock = threading.Lock()
        # dedup set: chunks believed present in the backend. Rebuilt from
        # a fresh listing on every save (a chunk another process GC'd
        # must drop out), plus the chunks this process uploaded itself
        # (object-store listings can lag just-written keys).
        self._known_chunks: Set[str] = set()
        self._session_chunks: Set[str] = set()
        # merged chunk manifests memo: (storage_id, manifest rels) ->
        # {rel: {"size", "chunks": [{"sha256", "size"}, ...]}}
        self._chunkmap_memo: Dict[Tuple[str, Tuple[str, ...]],
                                  Dict[str, Any]] = {}
        self._registry: Optional[Any] = None
        self._tracer: Optional[Any] = None
        self.session_stats: Dict[str, int] = {
            "bytes_uploaded": 0, "bytes_deduped": 0, "bytes_downloaded": 0,
            "chunks_uploaded": 0, "chunks_deduped": 0, "chunks_dropped": 0,
            "cache_hits": 0, "cache_misses": 0,
        }
        self._chunks = BlobService(
            inner, CHUNK_PREFIX, cache=cache,
            fault_store="cas.chunk_upload", fault_drop="cas.chunk_drop",
            fault_load="cas.chunk_download", counter=self._count)
        self._kv_store: Optional[KVBlobStore] = None
        # per-namespace byte budgets ("exec"/"kv") enforced by
        # sweep_namespaces(); chunk GC keys on checkpoint references, not
        # bytes, so "chunks" is not budgetable
        self._ns_budgets: Dict[str, int] = dict(namespace_budgets or {})
        bad = set(self._ns_budgets) - {"exec", "kv"}
        if bad:
            raise ValueError(
                f"unknown namespace budget(s): {sorted(bad)} "
                "(budgetable namespaces: exec, kv)")
        self._ns_evictions: Dict[str, int] = {"exec": 0, "kv": 0}

    # -- telemetry ----------------------------------------------------------

    def set_telemetry(self, registry: Optional[Any],
                      tracer: Optional[Any] = None) -> None:
        self._registry = registry
        self._tracer = tracer

    def _span(self, name: str):
        if self._tracer is not None:
            return self._tracer.span(name)
        return contextlib.nullcontext()

    def _count(self, key: str, n: int) -> None:
        with self._lock:
            self.session_stats[key] += n
        if self._registry is not None:
            self._registry.counter(
                f"cas_{key}_total",
                "content-addressed checkpoint store transfer accounting",
            ).inc(n)

    # -- helpers ------------------------------------------------------------

    def _get_pool(self) -> transfer.TransferPool:
        return self._pool if self._pool is not None else transfer.get_pool()

    def _scan_chunks(self, path: str) -> List[Dict[str, Any]]:
        """[{sha256, size, offset}] for one file, in order (an empty file
        has no chunk and is still restorable)."""
        out: List[Dict[str, Any]] = []
        offset = 0
        with open(path, "rb") as f:
            for data in iter(lambda: f.read(self._chunk_size), b""):
                out.append({"sha256": _sha256_bytes(data),
                            "size": len(data), "offset": offset})
                offset += len(data)
        return out

    def _list_backend_chunks(self) -> Set[str]:
        """Digests in the chunk namespace RIGHT NOW (a fresh listing)."""
        return set(self._chunks.list_blobs())

    def _refresh_known_chunks(self) -> Set[str]:
        digests = self._list_backend_chunks()
        with self._lock:
            # rebuilt, not unioned: a chunk another process's GC reclaimed
            # must stop counting as present
            self._known_chunks = digests | self._session_chunks
            return set(self._known_chunks)

    def _chunkmaps(self, storage_id: str,
                   manifest_rels: Iterable[str]) -> Dict[str, Any]:
        key = (storage_id, tuple(sorted(manifest_rels)))
        with self._lock:
            if key in self._chunkmap_memo:
                return self._chunkmap_memo[key]
        merged: Dict[str, Any] = {}
        with tempfile.TemporaryDirectory(prefix="dct-cas-") as tmp:
            self._inner.download(storage_id, tmp, paths=list(key[1]))
            for rel in key[1]:
                try:
                    with open(os.path.join(tmp, rel)) as f:
                        doc = json.load(f)
                except (ValueError, OSError) as e:
                    raise _corrupt(
                        storage_id, f"unreadable chunk manifest {rel!r}: {e}"
                    ) from None
                merged.update(doc.get("files") or {})
        with self._lock:
            self._chunkmap_memo[key] = merged
        return merged

    def _forget(self, storage_id: str) -> None:
        with self._lock:
            for key in [k for k in self._chunkmap_memo
                        if k[0] == storage_id]:
                del self._chunkmap_memo[key]

    def _manifest_rels(self, storage_id: str,
                       listing: Optional[Dict[str, int]] = None) -> List[str]:
        if listing is None:
            listing = self._inner.list_files(storage_id)
        return sorted(r for r in listing if _is_chunk_manifest(r))

    # -- upload -------------------------------------------------------------

    def upload(self, src_dir: str, storage_id: str,
               paths: Optional[List[str]] = None) -> None:
        rels = paths if paths is not None else _walk_relative(src_dir)
        passthrough = [r for r in rels if _is_passthrough(r)]
        chunked = [r for r in rels if not _is_passthrough(r)]
        with self._span("cas_upload"):
            # protocol files go first and verbatim, so a partial upload is
            # still self-identifying to validate_checkpoint_dir
            if passthrough:
                self._inner.upload(src_dir, storage_id, paths=passthrough)
            if not chunked:
                return
            known = self._refresh_known_chunks()
            entries: Dict[str, Any] = {}
            to_send: List[Tuple[str, Dict[str, Any]]] = []
            seen_this_call: Set[str] = set()
            # digest -> (src, chunk) of the chunks skipped as present, so
            # _verify_dedup can re-upload any a concurrent GC reclaimed
            dedup_src: Dict[str, Tuple[str, Dict[str, Any]]] = {}
            for rel in chunked:
                src = os.path.join(src_dir, rel)
                chunks = self._scan_chunks(src)
                entries[rel] = {
                    "size": sum(c["size"] for c in chunks),
                    "chunks": [{"sha256": c["sha256"], "size": c["size"]}
                               for c in chunks],
                }
                for c in chunks:
                    d = c["sha256"]
                    if d in seen_this_call or d in known:
                        self._count("bytes_deduped", c["size"])
                        self._count("chunks_deduped", 1)
                        if d in known:
                            dedup_src.setdefault(d, (src, c))
                        continue
                    seen_this_call.add(d)
                    to_send.append((src, c))
            # the chunk manifest goes BEFORE the chunk data: once it is
            # durable, a concurrent GC's ref-count walk sees every chunk
            # this save references, the deduped ones included
            self._write_chunk_manifest(storage_id, entries)
            if to_send:
                self._upload_chunks(to_send)
                uploaded = {c["sha256"] for _, c in to_send}
                with self._lock:
                    self._known_chunks |= uploaded
                    self._session_chunks |= uploaded
            self._verify_dedup(dedup_src)

    def _verify_dedup(
            self, dedup_src: Dict[str, Tuple[str, Dict[str, Any]]]) -> None:
        """Dedup decisions are provisional until confirmed AFTER the chunk
        manifest is durable: a GC whose walk predates the manifest may
        have reclaimed a chunk this save skipped. Re-check every deduped
        digest against a fresh listing and re-upload the vanished ones."""
        if not dedup_src:
            return
        missing = set(dedup_src) - self._list_backend_chunks()
        if not missing:
            return
        logger.warning(
            "cas: %d deduped chunk(s) vanished from the backend during the "
            "save (concurrent GC); re-uploading", len(missing))
        self._upload_chunks([dedup_src[d] for d in sorted(missing)])
        with self._lock:
            self._known_chunks |= missing
            self._session_chunks |= missing

    def _upload_chunks(self,
                       to_send: List[Tuple[str, Dict[str, Any]]]) -> None:
        def send(src: str, chunk: Dict[str, Any]) -> None:
            with open(src, "rb") as f:
                f.seek(chunk["offset"])
                data = f.read(chunk["size"])
            if self._chunks.put(data, digest=chunk["sha256"]) is None:
                # injected lost object (cas.chunk_drop): the save
                # "succeeds" but the chunk never lands; restore refuses
                self._count("chunks_dropped", 1)
                return
            self._count("bytes_uploaded", chunk["size"])
            self._count("chunks_uploaded", 1)

        self._get_pool().run([(lambda src=src, c=c: send(src, c))
                              for src, c in to_send])

    def _write_chunk_manifest(self, storage_id: str,
                              entries: Dict[str, Any]) -> None:
        rel = f"{CHUNK_MANIFEST_PREFIX}{uuid.uuid4().hex[:10]}.json"
        with tempfile.TemporaryDirectory(prefix="dct-cas-mf-") as tmp:
            with open(os.path.join(tmp, rel), "w") as f:
                json.dump({
                    "format": 1,
                    "storage_id": storage_id,
                    "chunk_size": self._chunk_size,
                    "files": entries,
                }, f, indent=1)
            self._inner.upload(tmp, storage_id, paths=[rel])
        self._forget(storage_id)

    # -- download -----------------------------------------------------------

    def download(self, storage_id: str, dst_dir: str,
                 paths: Optional[List[str]] = None) -> None:
        listing = self._inner.list_files(storage_id)
        manifest_rels = self._manifest_rels(storage_id, listing)
        if not manifest_rels:
            # not CAS-written (a plain checkpoint in the same root)
            self._inner.download(storage_id, dst_dir, paths=paths)
            return
        with self._span("cas_download"):
            chunkmap = self._chunkmaps(storage_id, manifest_rels)
            if paths is not None:
                want = list(paths)
            else:
                want = sorted((set(listing) - set(manifest_rels))
                              | set(chunkmap))
            plain = [r for r in want if r not in chunkmap]
            if plain:
                self._inner.download(storage_id, dst_dir, paths=plain)
            self._get_pool().run([
                (lambda rel=rel: self._assemble_file(
                    storage_id, rel, chunkmap[rel],
                    os.path.join(dst_dir, rel)))
                for rel in want if rel in chunkmap])

    def _assemble_file(self, storage_id: str, rel: str,
                       entry: Dict[str, Any], out: str) -> None:
        """Fetch the file's chunks over the pool, a window of
        ``FETCH_WINDOW`` at a time, and write them in order: a checkpoint
        that is one large file restores in parallel too (the JAX store
        fetches one chunk after another), holding one window in memory."""
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        chunks = entry.get("chunks") or []
        pool = self._get_pool()
        with open(out, "wb") as f:
            for lo in range(0, len(chunks), self.FETCH_WINDOW):
                for data in pool.run([
                        (lambda d=c["sha256"]: self._fetch_chunk(storage_id,
                                                                 d))
                        for c in chunks[lo:lo + self.FETCH_WINDOW]]):
                    f.write(data)
        size = os.path.getsize(out)
        if size != entry.get("size", size):
            raise _corrupt(
                storage_id, f"file {rel!r} assembled to {size} bytes, chunk "
                f"manifest says {entry['size']}")

    def _fetch_chunk(self, storage_id: str, digest: str) -> bytes:
        try:
            return self._chunks.get(digest)
        except BlobIntegrityError as e:
            if e.missing:
                raise _corrupt(
                    storage_id, f"chunk {digest[:12]}… missing from the "
                    "chunk store (lost object or over-eager GC)") from None
            raise _corrupt(
                storage_id, f"chunk {digest[:12]}… content digest mismatch "
                "(torn chunk)") from None

    # -- logical listing / commit -------------------------------------------

    def list_files(self, storage_id: str) -> Dict[str, int]:
        listing = self._inner.list_files(storage_id)
        manifest_rels = self._manifest_rels(storage_id, listing)
        out = {r: s for r, s in listing.items()
               if not _is_chunk_manifest(r)}
        if manifest_rels:
            for rel, entry in self._chunkmaps(storage_id,
                                              manifest_rels).items():
                out[rel] = int(entry.get("size", 0))
        return out

    def commit(self, storage_id: str,
               payload: Optional[Dict[str, Any]] = None) -> None:
        self._inner.commit(storage_id, payload)

    def is_committed(self, storage_id: str) -> bool:
        return self._inner.is_committed(storage_id)

    def list_storage_ids(self) -> List[str]:
        return [sid for sid in self._inner.list_storage_ids()
                if sid != CHUNK_NAMESPACE]

    def storage_age_s(self, storage_id: str) -> Optional[float]:
        return self._inner.storage_age_s(storage_id)

    # -- delete + chunk ref-counting GC --------------------------------------

    def _referenced_digests(self, storage_id: str) -> Set[str]:
        manifest_rels = self._manifest_rels(storage_id)
        if not manifest_rels:
            return set()
        chunkmap = self._chunkmaps(storage_id, manifest_rels)
        return {c["sha256"] for entry in chunkmap.values()
                for c in entry.get("chunks") or []}

    def _survivor_references(self, deleted_id: str) -> Optional[Set[str]]:
        """Union of the chunk digests every surviving checkpoint
        references, or None when the ref-count is unknowable (the backend
        cannot enumerate, or a neighbour's manifests are unreadable) —
        the caller then keeps every chunk."""
        try:
            survivors = self.list_storage_ids()
        except NotImplementedError:
            logger.info("chunk GC skipped: %s cannot enumerate checkpoints",
                        type(self._inner).__name__)
            return None
        out: Set[str] = set()
        for sid in survivors:
            if sid == deleted_id:
                continue
            try:
                out |= self._referenced_digests(sid)
            except Exception as e:
                logger.warning(
                    "chunk GC aborted: cannot read chunk manifests of %s "
                    "(%s); keeping all chunks", sid, e)
                return None
        return out

    def delete(self, storage_id: str) -> None:
        """Delete a checkpoint, then reclaim chunks nothing references.

        The ref-count is recomputed from the surviving checkpoints,
        committed and uncommitted. In-flight saves are protected by three
        rules, no storage-level lock: upload() writes the chunk manifest
        BEFORE any chunk data; this walk runs TWICE and reclaims a chunk
        only when both walks found it unreferenced; and a save whose
        dedup still raced a finished GC re-uploads its vanished deduped
        chunks before it returns (``_verify_dedup``)."""
        try:
            doomed = self._referenced_digests(storage_id)
        except Exception as e:  # unreadable manifests: skip chunk GC (safe)
            logger.warning("chunk GC skipped for %s: %s", storage_id, e)
            doomed = set()
        self._inner.delete(storage_id)
        self._forget(storage_id)
        referenced: Set[str] = set()
        garbage = set(doomed)
        for _ in range(2):
            if not garbage:
                return
            refs = self._survivor_references(storage_id)
            if refs is None:
                return
            referenced |= refs
            garbage = doomed - referenced
        if not garbage:
            return
        try:
            # only ever the chunk namespace: exec/ and kv/ entries live
            # under other BlobService prefixes
            self._chunks.delete(garbage)
        except NotImplementedError:
            logger.info("chunk GC skipped: %s has no per-object delete",
                        type(self._inner).__name__)
            return
        with self._lock:
            self._known_chunks -= garbage
            self._session_chunks -= garbage
        logger.info("chunk GC: removed %d chunks unreferenced after "
                    "deleting %s (%d still referenced)",
                    len(garbage), storage_id, len(referenced & doomed))

    # -- the KV tier and the stats (``checkpoint stats``) --------------------

    def kv_store(self) -> KVBlobStore:
        """The KV spill tier on this manager's backend (``cas/kv/``),
        built lazily, with this manager's ``kv`` budget if one was
        configured."""
        with self._lock:
            if self._kv_store is None:
                self._kv_store = KVBlobStore(
                    self._inner, budget_bytes=self._ns_budgets.get("kv"))
            return self._kv_store

    def sweep_namespaces(self) -> Dict[str, Any]:
        """Enforce every configured namespace byte budget now
        (:func:`sweep_namespace`); eviction totals accumulate into
        ``storage_stats()['namespaces'][ns]['evictions']``."""
        out: Dict[str, Any] = {}
        for ns in sorted(self._ns_budgets):
            res = sweep_namespace(self._inner, ns, self._ns_budgets[ns])
            with self._lock:
                self._ns_evictions[ns] = (self._ns_evictions.get(ns, 0)
                                          + int(res.get("evicted", 0)))
            out[ns] = res
        return out

    def storage_stats(self) -> Dict[str, Any]:
        """Store-wide dedup accounting and the cache hit rate, per blob
        namespace. dedup_ratio = logical chunked bytes across every
        checkpoint's manifests / physical bytes in the chunk namespace;
        above 1, chunk-level dedup is saving space."""
        listing = self._inner.list_files(CHUNK_NAMESPACE)
        physical = {rel: size for rel, size in listing.items()
                    if self._chunks.digest_of_rel(rel) is not None}

        def under(prefix: str) -> List[int]:
            return [size for rel, size in listing.items()
                    if rel.startswith(prefix + "/")]

        exec_blobs, kv_objects = under(EXEC_BLOB_PREFIX), under("kv")
        chunk_bytes = sum(physical.values())
        logical = 0
        checkpoints = 0
        try:
            sids = self.list_storage_ids()
        except NotImplementedError:
            sids = []
        for sid in sids:
            try:
                manifest_rels = self._manifest_rels(sid)
                if not manifest_rels:
                    continue
                chunkmap = self._chunkmaps(sid, manifest_rels)
            except Exception as e:
                logger.warning("stats: skipping unreadable checkpoint %s "
                               "(%s)", sid, e)
                continue
            checkpoints += 1
            logical += sum(int(entry.get("size", 0))
                           for entry in chunkmap.values())
        out: Dict[str, Any] = {
            "chunk_count": len(physical),
            "chunk_bytes": chunk_bytes,
            "cas_checkpoints": checkpoints,
            "logical_bytes": logical,
            "dedup_ratio": (round(logical / chunk_bytes, 4)
                            if chunk_bytes else None),
            "namespaces": {
                "chunks": {"objects": len(physical), "bytes": chunk_bytes},
                "exec": {"objects": len(exec_blobs),
                         "bytes": sum(exec_blobs),
                         "executables": len(under(EXEC_INDEX_PREFIX)),
                         "budget_bytes": self._ns_budgets.get("exec"),
                         "evictions": self._ns_evictions.get("exec", 0)},
                "kv": {"objects": len(kv_objects),
                       "bytes": sum(kv_objects),
                       "entries": len(under(KV_INDEX_PREFIX)),
                       "budget_bytes": self._ns_budgets.get("kv"),
                       "evictions": self._ns_evictions.get("kv", 0)},
            },
            "session": dict(self.session_stats),
        }
        if self._cache is not None:
            out["cache"] = self._cache.stats()
        return out


def build_cas(cfg: Any, inner: StorageManager) -> CASStorageManager:
    """Construct from a ``checkpoint_storage: {type: cas, ...}`` block
    (config/experiment.py) and an already-built inner backend."""
    cache = None
    if cfg.cache_path:
        cache = ChunkCache(cfg.cache_path,
                           max_bytes=int(cfg.cache_size_mb or 256) << 20)
    pool = None
    if cfg.transfer_workers is not None:
        pool = transfer.TransferPool(workers=int(cfg.transfer_workers))
    return CASStorageManager(
        inner, chunk_size=int(cfg.chunk_size_kb or 1024) << 10,
        cache=cache, pool=pool)
