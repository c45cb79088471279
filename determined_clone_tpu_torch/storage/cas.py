"""The KV half of the content-addressed blob store (CAS) — the port's copy
of the blob transport and ``KVBlobStore`` of
``determined_clone_tpu/storage/cas.py``.

The reserved ``cas/`` storage_id holds digest-keyed blobs. The port uses
it for **spilled KV blocks** (``cas/kv/``): :class:`KVBlobStore` is the
durable tier of the fleet KV memory hierarchy (serving/kv_store.py) —
exact K/V block payloads keyed by the prefix cache's chained content
hash, so a restarted or replacement replica warms shared prefixes by
fetching instead of re-prefilling. The layout and the pickled record are
the JAX package's, so one ``cas/kv/`` directory serves both packages
(a payload either side cannot adopt is a plain miss there).

Every blob read goes through :class:`BlobService`: digest-keyed object
paths and sha256 verification on every read. The checkpoint-chunk
client (``CASStorageManager``) and the executable cache wait with the
cloud storage managers (``ROADMAP.md``).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import tempfile
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

from determined_clone_tpu_torch import faults
from determined_clone_tpu_torch.storage.base import StorageManager

logger = logging.getLogger(__name__)

# Reserved storage_id holding the shared blob objects; never a checkpoint.
CHUNK_NAMESPACE = "cas"

# Blob namespaces inside the reserved storage_id. ``kv/...`` entries are
# evicted by the per-namespace budget sweep (:func:`sweep_namespace`).
KV_BLOB_PREFIX = "kv/blobs"
KV_INDEX_PREFIX = "kv/index"


def _sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


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
      and failed reads.

    The JAX service's local chunk cache serves checkpoint restores and
    waits with them.
    """

    def __init__(self, inner: StorageManager, prefix: str, *,
                 fault_store: Optional[str] = None,
                 fault_drop: Optional[str] = None,
                 fault_load: Optional[str] = None) -> None:
        self._inner = inner
        self.prefix = prefix
        self._fault_store = fault_store
        self._fault_drop = fault_drop
        self._fault_load = fault_load

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
        return digest

    def get(self, digest: str) -> bytes:
        """Fetch + digest-verify one blob. Raises
        :class:`BlobIntegrityError` when missing or torn."""
        if self._fault_load is not None:
            faults.point(self._fault_load)
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
        return data

    def delete(self, digests: Iterable[str]) -> None:
        self._inner.delete_files(
            CHUNK_NAMESPACE, [self.rel(d) for d in sorted(digests)])


def namespace_usage(inner: StorageManager, namespace: str) -> Dict[str, int]:
    """rel -> size for every object (blobs AND index files) under one
    blob namespace (``kv``) of the reserved ``cas`` storage_id."""
    head = namespace.rstrip("/") + "/"
    try:
        listing = inner.list_files(CHUNK_NAMESPACE)
    except (FileNotFoundError, KeyError):
        return {}
    return {rel: int(size) for rel, size in listing.items()
            if rel.startswith(head)}


def sweep_namespace(inner: StorageManager, namespace: str,
                    budget_bytes: int) -> Dict[str, Any]:
    """LRU-by-mtime byte-budget sweep for one blob namespace (``kv``
    here; the JAX package sweeps ``exec`` the same way).

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

