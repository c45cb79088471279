"""Fleet-wide KV memory hierarchy: host tier + inventory digests — the
port of ``determined_clone_tpu/serving/kv_store.py``.

Below each replica's :class:`~.kv_cache.PrefixCache` (resident pool
blocks, aliased through block tables) sit two tiers shared by a fleet:

- **host** — :class:`KVBlockStore`, a size-budgeted LRU of exact K/V
  block payloads copied to host RAM when the prefix cache *evicts*
  (demotion instead of dropping);
- **CAS** — :class:`~determined_clone_tpu_torch.storage.cas.KVBlobStore`
  under ``cas/kv/``, for spill past the host budget and cross-process
  durability, so a restarted replica warms by fetching.

Keys are the prefix cache's chained content hashes, scoped by a
**params fingerprint** — cached K/V is a function of (params, tokens),
so a hot-swap or blue-green rollout that changes the weights can never
be served stale blocks: the new fingerprint simply misses. The
fingerprint hashes the same strings, in the same leaf order, as the JAX
package's, so converted parameters give the same hex in both packages.

Every tier stores the *exact* bytes copied from the pool. A payload
array is numpy in the JAX layout ``[L, block, H, hd]`` where numpy holds
the pool's dtype (fp32: one CAS directory serves both packages), and a
CPU tensor otherwise (bf16: numpy has no bf16 without ``ml_dtypes``, and
the bits must never round-trip through fp32). The engine adopts a
payload only if every array has its pool's slot shape and that same
representation (:func:`payload_fits`); anything else is a plain miss.

:class:`PrefixInventory` is the router-facing digest of what a replica
can serve cheaply: top-K exact chain keys plus a small bloom filter.
``LeastLoadedRouter`` hashes a prompt's head blocks and prefers the
replica with the deepest inventory coverage — a *hint* only (bloom
false positives just cost a re-prefill), and never an override of
overload (serving/router.py).
"""
from __future__ import annotations

import hashlib
import logging
import threading
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from determined_clone_tpu_torch.core._serialization import (
    tree_paths_and_leaves,
)
from determined_clone_tpu_torch.serving.kv_cache import PrefixCache

logger = logging.getLogger(__name__)

# Host-tier default: enough for a few hundred toy-model blocks in tests
# and a deliberate, visible knob in production configs.
DEFAULT_HOST_BUDGET_BYTES = 256 << 20

# pool dtypes numpy holds exactly; a payload of any other dtype stays a
# CPU tensor
_NUMPY_DTYPES = {torch.float16: np.dtype(np.float16),
                 torch.float32: np.dtype(np.float32),
                 torch.float64: np.dtype(np.float64)}


def _leaf_strings(leaf: Any) -> Tuple[str, str, bytes]:
    """(shape, dtype, bytes) of one leaf as the JAX package hashes them:
    numpy's ``str(shape)`` and dtype name, and the raw bytes."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        dtype = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            raw = t.view(torch.int16).numpy().tobytes()
        else:
            raw = t.numpy().tobytes()
        return str(tuple(t.shape)), dtype, raw
    arr = np.asarray(leaf)
    return str(arr.shape), str(arr.dtype), arr.tobytes()


def params_fingerprint(params: Any) -> str:
    """sha256 over every leaf's shape, dtype, and bytes — the tier-key
    scope that makes cached K/V unservable across a weight change.
    Leaves in JAX tree order (dict keys sorted); equal to the JAX
    package's fingerprint of the same values."""
    h = hashlib.sha256()
    for _path, leaf in tree_paths_and_leaves(params):
        shape, dtype, raw = _leaf_strings(leaf)
        h.update(shape.encode())
        h.update(dtype.encode())
        h.update(raw)
    return h.hexdigest()


def payload_array(pool_slice: torch.Tensor) -> Any:
    """Exact host copy of one block of a pool (all layers): numpy where
    numpy holds the dtype, else a CPU tensor of the pool's dtype."""
    host = pool_slice.detach().to("cpu", copy=True)
    return host.numpy() if pool_slice.dtype in _NUMPY_DTYPES else host


def payload_fits(arr: Any, pool: torch.Tensor) -> bool:
    """Whether ``arr`` can be written into one block of ``pool``
    ``[L, N, block, H, hd]`` unchanged: the slot's shape, the pool's
    dtype, in the representation :func:`payload_array` gives it."""
    slot = (pool.shape[0], *pool.shape[2:])
    np_dtype = _NUMPY_DTYPES.get(pool.dtype)
    if np_dtype is not None:
        return (isinstance(arr, np.ndarray) and arr.dtype == np_dtype
                and arr.shape == slot)
    return (isinstance(arr, torch.Tensor) and arr.dtype == pool.dtype
            and arr.device.type == "cpu" and tuple(arr.shape) == slot)


def payload_tensor(arr: Any) -> torch.Tensor:
    """The tensor view of a payload array that fits (no copy, unless a
    numpy array is read-only, as one from another framework may be)."""
    if isinstance(arr, np.ndarray):
        return torch.from_numpy(np.require(arr, requirements=["W"]))
    return arr


def prompt_chain_keys(prompt: Sequence[int], block_size: int,
                      max_blocks: int) -> List[str]:
    """Hex chain keys of a prompt's leading full blocks — the affinity
    lookup the router hashes against replica inventories. Uses the
    PrefixCache's own chaining, so router keys and cache keys agree by
    construction."""
    keys: List[str] = []
    prev = b""
    for i in range(min(len(prompt) // block_size, max_blocks)):
        prev = PrefixCache._chain(
            prev, prompt[i * block_size:(i + 1) * block_size])
        keys.append(prev.hex())
    return keys


class PrefixInventory:
    """Compact digest of the chain keys one replica can serve cheaply.

    ``top`` holds up to K exact hex keys (deepest-first — exact
    matches are definite); everything else folds into a ``bits``-bit
    bloom filter with two probes per key. ``covers()`` is therefore
    one-sided: False is definite, True may be a false positive — fine
    for routing, where a wrong hint costs one re-prefill, never a
    wrong answer. Serialized via :meth:`to_dict` into RoutablePort
    stats / the HTTP stats endpoint.
    """

    __slots__ = ("top", "bloom", "bits")

    def __init__(self, top: Iterable[str] = (), bloom: int = 0,
                 bits: int = 256) -> None:
        self.top = frozenset(top)
        self.bloom = int(bloom)
        self.bits = int(bits)

    @staticmethod
    def _probes(key_hex: str, bits: int) -> Tuple[int, int]:
        d = hashlib.sha256(key_hex.encode("ascii")).digest()
        return (int.from_bytes(d[:4], "big") % bits,
                int.from_bytes(d[4:8], "big") % bits)

    @classmethod
    def build(cls, keys: Sequence[str], *, top_k: int = 32,
              bits: int = 256) -> "PrefixInventory":
        """``keys`` in priority order (callers put the deepest /
        hottest chains first); the first ``top_k`` stay exact."""
        bloom = 0
        for k in keys:
            a, b = cls._probes(k, bits)
            bloom |= (1 << a) | (1 << b)
        return cls(top=keys[:top_k], bloom=bloom, bits=bits)

    def covers(self, key_hex: str) -> bool:
        if key_hex in self.top:
            return True
        a, b = self._probes(key_hex, self.bits)
        mask = (1 << a) | (1 << b)
        return (self.bloom & mask) == mask

    def coverage_depth(self, keys: Sequence[str]) -> int:
        """How many *leading* chain keys this inventory covers — the
        affinity score: chained hashes make any gap a hard stop."""
        depth = 0
        for k in keys:
            if not self.covers(k):
                break
            depth += 1
        return depth

    def to_dict(self) -> Dict[str, Any]:
        return {"top": sorted(self.top),
                "bloom": format(self.bloom, "x"),
                "bits": self.bits}

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "PrefixInventory":
        return cls(top=doc.get("top", ()),
                   bloom=int(str(doc.get("bloom", "0")), 16),
                   bits=int(doc.get("bits", 256)))


class KVBlockStore:
    """Host-RAM tier of the KV hierarchy, shared fleet-wide.

    A thread-safe LRU of exact K/V block payloads keyed by
    ``(params fingerprint, chain-key hex)`` with byte accounting
    against a budget. Entries arrive when a replica's prefix cache
    demotes on eviction (or an engine flushes before teardown); they
    leave by LRU pressure — cascading into the optional CAS tier
    (:class:`~determined_clone_tpu_torch.storage.cas.KVBlobStore`) instead
    of vanishing, when one is attached. ``get()`` reads host first,
    then CAS (re-inserting the payload so the next reader stays in
    RAM).

    Payloads are plain dicts of host arrays (``k``/``v``, plus
    ``dk``/``dv`` when the engine runs a draft model) exactly as
    copied from the pools (:func:`payload_array`) — this tier never
    transforms bytes, which is the whole bit-exactness argument.
    """

    def __init__(self, *, budget_bytes: int = DEFAULT_HOST_BUDGET_BYTES,
                 blob_store: Optional[Any] = None) -> None:
        if budget_bytes < 1:
            raise ValueError(
                f"host tier budget_bytes must be >= 1, got {budget_bytes}")
        self.budget_bytes = budget_bytes
        self._blobs = blob_store
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple[str, str], Dict[str, Any]]" = \
            OrderedDict()
        self._sizes: Dict[Tuple[str, str], int] = {}
        self._nbytes = 0
        self.counters: Dict[str, int] = {
            "host_hits": 0, "cas_hits": 0, "misses": 0,
            "puts": 0, "duplicate_puts": 0, "host_evictions": 0,
            "cas_spills": 0, "cas_spill_errors": 0,
        }

    @staticmethod
    def payload_nbytes(payload: Dict[str, Any]) -> int:
        return sum(int(getattr(a, "nbytes", 0)) for a in payload.values())

    @staticmethod
    def _blob_key(fingerprint: str, key_hex: str) -> Dict[str, str]:
        return {"fingerprint": fingerprint, "chain": key_hex}

    def _spill_to_cas_locked(self, ent_key: Tuple[str, str],
                             payload: Dict[str, Any]) -> None:
        # called with the lock held; CAS I/O under the lock is the
        # price of a consistent cascade — eviction batches are small
        if self._blobs is None:
            return
        try:
            self._blobs.store(self._blob_key(*ent_key), payload)
            self.counters["cas_spills"] += 1
        except Exception as e:  # noqa: BLE001 — a lost spill is a miss later
            self.counters["cas_spill_errors"] += 1
            logger.warning("kv host tier: CAS cascade failed for "
                           "%s… (%s)", ent_key[1][:12], e)

    def put(self, fingerprint: str, key_hex: str,
            payload: Dict[str, Any]) -> None:
        """Insert one demoted block. Idempotent per key (a popular
        prefix demoted by several replicas lands once); oversized
        payloads beyond the whole budget are refused up front."""
        size = self.payload_nbytes(payload)
        with self._lock:
            ent = (fingerprint, key_hex)
            if ent in self._entries:
                self._entries.move_to_end(ent)
                self.counters["duplicate_puts"] += 1
                return
            if size > self.budget_bytes:
                # never admit something that would evict everything —
                # hand it straight to the CAS tier instead
                self._spill_to_cas_locked(ent, payload)
                return
            self._entries[ent] = payload
            self._sizes[ent] = size
            self._nbytes += size
            self.counters["puts"] += 1
            while self._nbytes > self.budget_bytes:
                old_key, old_payload = self._entries.popitem(last=False)
                self._nbytes -= self._sizes.pop(old_key)
                self.counters["host_evictions"] += 1
                self._spill_to_cas_locked(old_key, old_payload)

    def get(self, fingerprint: str,
            key_hex: str) -> Optional[Dict[str, Any]]:
        """Exact payload or None (plain miss). Host first, then the
        CAS tier; a CAS hit is re-inserted so repeat readers stay in
        host RAM."""
        ent = (fingerprint, key_hex)
        with self._lock:
            hit = self._entries.get(ent)
            if hit is not None:
                self._entries.move_to_end(ent)
                self.counters["host_hits"] += 1
                return hit
        if self._blobs is not None:
            payload = self._blobs.load(self._blob_key(fingerprint, key_hex))
            if payload is not None:
                with self._lock:
                    self.counters["cas_hits"] += 1
                self.put(fingerprint, key_hex, payload)
                return payload
        with self._lock:
            self.counters["misses"] += 1
        return None

    def contains(self, fingerprint: str, key_hex: str) -> bool:
        with self._lock:
            return (fingerprint, key_hex) in self._entries

    def keys(self, fingerprint: str) -> List[str]:
        """Hex chain keys resident in the host tier for one params
        fingerprint, most-recently-used first (inventory priority)."""
        with self._lock:
            return [k for fp, k in reversed(self._entries)
                    if fp == fingerprint]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            counters = dict(self.counters)
            entries = len(self._entries)
            nbytes = self._nbytes
        looked = (counters["host_hits"] + counters["cas_hits"]
                  + counters["misses"])
        hits = counters["host_hits"] + counters["cas_hits"]
        out: Dict[str, Any] = {
            "entries": entries,
            "bytes": nbytes,
            "budget_bytes": self.budget_bytes,
            "hit_rate": round(hits / looked, 4) if looked else None,
            "cas_attached": self._blobs is not None,
            **counters,
        }
        if self._blobs is not None:
            out["cas"] = self._blobs.stats()
        return out
