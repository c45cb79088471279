"""CheckpointContext — checkpoint save/restore + registry; the port's
single-rank copy of ``determined_clone_tpu/core/_checkpoint.py``.

It writes what the JAX package writes — ``metadata.json``, a
``manifest.json`` of every file's size and sha256, uploaded first, and
the ``COMMIT`` marker, written last — and validates a restore the same
way, so a checkpoint of either package passes the other's validation.
Sharded uploads across ranks come with the parallelism slice, and
``store_path_async`` (the background upload) waits (``ROADMAP.md``);
``wait_async``/``abort_async`` are here, with nothing ever in flight.

The registry (which checkpoints exist, their metadata/resources) is reported
to the master when on-cluster; the LocalRegistry keeps the same record in a
JSONL next to the storage for off-cluster runs — the reference's
"Dummy/off-cluster" pattern, but persistent.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import tempfile
import time
import uuid
from typing import Any, Dict, Iterator, List, Optional

from determined_clone_tpu_torch import faults
from determined_clone_tpu_torch.core._distributed import DistributedContext
from determined_clone_tpu_torch.storage.base import COMMIT_FILE, StorageManager

METADATA_FILE = "metadata.json"
MANIFEST_FILE = "manifest.json"
# protocol files never appear in the manifest's own file table
_INTERNAL_FILES = (MANIFEST_FILE, COMMIT_FILE)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed commit-protocol validation: it was interrupted
    before its COMMIT marker (crash mid-upload) or its content no longer
    matches its manifest (torn write, bit rot). Restoring it would load a
    partial state — callers fall back to the previous committed
    checkpoint."""

    def __init__(self, storage_id: str, reason: str) -> None:
        super().__init__(
            f"checkpoint {storage_id} failed commit validation: {reason}")
        self.storage_id = storage_id
        self.reason = reason


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def _file_entries(base: str, rels: List[str]) -> Dict[str, Dict[str, Any]]:
    """Manifest entries (size + digest) for files under ``base``."""
    return {
        rel: {
            "size": os.path.getsize(os.path.join(base, rel)),
            "sha256": _sha256(os.path.join(base, rel)),
        }
        for rel in rels
    }


def validate_checkpoint_dir(path: str, storage_id: str = "<local>") -> bool:
    """Enforce the commit protocol on a downloaded checkpoint directory.

    Returns True when the manifest fully verified, False for a legacy
    checkpoint (written before the commit protocol: no manifest, no COMMIT
    — nothing to check). Raises :class:`CheckpointCorruptError` for
    anything in between: a manifest without its COMMIT marker (interrupted
    before commit), a missing/short/altered file, or an empty directory.
    """
    mpath = os.path.join(path, MANIFEST_FILE)
    cpath = os.path.join(path, COMMIT_FILE)
    has_manifest, has_commit = os.path.exists(mpath), os.path.exists(cpath)
    if not has_manifest and not has_commit:
        if not _relative_files(path):
            raise CheckpointCorruptError(
                storage_id, "empty checkpoint (crashed before any file "
                "finished uploading)")
        return False
    if not has_commit:
        raise CheckpointCorruptError(
            storage_id, "manifest present but no COMMIT marker — the save "
            "was interrupted before commit")
    if not has_manifest:
        raise CheckpointCorruptError(
            storage_id, "COMMIT marker without manifest.json")
    try:
        with open(mpath) as f:
            doc = json.load(f)
    except ValueError as e:
        raise CheckpointCorruptError(
            storage_id, f"unreadable manifest: {e}") from None
    recorded = doc.get("storage_id")
    if recorded and storage_id != "<local>" and recorded != storage_id:
        raise CheckpointCorruptError(
            storage_id, f"manifest belongs to checkpoint {recorded!r}")
    for rel, want in (doc.get("files") or {}).items():
        p = os.path.join(path, rel)
        if not os.path.exists(p):
            raise CheckpointCorruptError(
                storage_id, f"file {rel!r} in manifest is missing")
        size = os.path.getsize(p)
        if size != want.get("size"):
            raise CheckpointCorruptError(
                storage_id, f"file {rel!r} is {size} bytes, manifest says "
                f"{want.get('size')} (torn write)")
        if want.get("sha256") and _sha256(p) != want["sha256"]:
            raise CheckpointCorruptError(
                storage_id, f"file {rel!r} content digest mismatch")
    return True


def verify_manifest_digests(path: str, storage_id: str = "<local>", *,
                            require_all: bool = False) -> bool:
    """Digest-verify a downloaded directory against its ``manifest.json``.

    The download-path counterpart of :func:`validate_checkpoint_dir`: it
    checks that every file the manifest lists arrived whole (size +
    sha256) — it does NOT require the COMMIT marker, because callers may
    legitimately fetch an uncommitted checkpoint for inspection.

    ``require_all=False`` tolerates manifest-listed files that are absent
    locally (a partial ``paths`` download is not corruption). Callers that
    performed a FULL download must pass ``require_all=True`` so a wholly
    dropped file is convicted, not just a torn one — otherwise a backend
    that silently lost an object would pass verification. Returns False
    silently for a legacy download with no manifest; raises
    :class:`CheckpointCorruptError` on any mismatch.
    """
    mpath = os.path.join(path, MANIFEST_FILE)
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath) as f:
            doc = json.load(f)
    except ValueError as e:
        raise CheckpointCorruptError(
            storage_id, f"unreadable manifest: {e}") from None
    for rel, want in (doc.get("files") or {}).items():
        p = os.path.join(path, rel)
        if not os.path.exists(p):
            if require_all:
                raise CheckpointCorruptError(
                    storage_id, f"file {rel!r} in manifest is missing from "
                    "a full download (lost object)")
            # a partial download (paths subset) is not corruption
            continue
        size = os.path.getsize(p)
        if size != want.get("size"):
            raise CheckpointCorruptError(
                storage_id, f"downloaded file {rel!r} is {size} bytes, "
                f"manifest says {want.get('size')} (torn transfer)")
        if want.get("sha256") and _sha256(p) != want["sha256"]:
            raise CheckpointCorruptError(
                storage_id, f"downloaded file {rel!r} content digest "
                "mismatch")
    return True


class CheckpointRegistry:
    """Record of reported checkpoints. Subclasses: local JSONL or master REST."""

    def report(self, record: Dict[str, Any]) -> None:
        raise NotImplementedError

    def report_deleted(self, storage_id: str) -> None:
        raise NotImplementedError

    def list(self) -> List[Dict[str, Any]]:
        raise NotImplementedError


class LocalCheckpointRegistry(CheckpointRegistry):
    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def report(self, record: Dict[str, Any]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def report_deleted(self, storage_id: str) -> None:
        self.report({"storage_id": storage_id, "deleted": True})

    def list(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return []
        records: Dict[str, Dict[str, Any]] = {}
        with open(self.path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("deleted"):
                    records.pop(rec["storage_id"], None)
                else:
                    records[rec["storage_id"]] = rec
        return list(records.values())


class NullCheckpointRegistry(CheckpointRegistry):
    def report(self, record: Dict[str, Any]) -> None:
        pass

    def report_deleted(self, storage_id: str) -> None:
        pass

    def list(self) -> List[Dict[str, Any]]:
        return []


class CheckpointContext:
    def __init__(self, dist: DistributedContext, storage: StorageManager,
                 registry: Optional[CheckpointRegistry] = None, *,
                 trial_id: Optional[int] = None) -> None:
        self._dist = dist
        self._storage = storage
        self._registry = registry or NullCheckpointRegistry()
        self._trial_id = trial_id

    # -- save ---------------------------------------------------------------

    def upload(self, ckpt_dir: str,
               metadata: Optional[Dict[str, Any]] = None) -> str:
        """Upload a checkpoint directory; returns its new storage_id.

        Commit protocol: ``manifest.json`` (per-file size + digest) is
        uploaded FIRST, in its own storage call, so any partial upload is
        self-identifying; the ``COMMIT`` marker is written after every
        file is in storage, and only then is the checkpoint published to
        the registry — restores refuse anything uncommitted."""
        faults.point("checkpoint.pre_upload")
        storage_id = str(uuid.uuid4())
        self._write_metadata(ckpt_dir, metadata)
        files = [f for f in _relative_files(ckpt_dir)
                 if f not in _INTERNAL_FILES]
        self._write_manifest(ckpt_dir, storage_id,
                             _file_entries(ckpt_dir, files))
        self._storage.upload(ckpt_dir, storage_id, paths=[MANIFEST_FILE])
        if files:
            self._storage.upload(ckpt_dir, storage_id, paths=files)
        faults.point("checkpoint.post_upload")
        faults.point("checkpoint.commit")
        self._storage.commit(storage_id, {
            "trial_id": self._trial_id, "time": time.time()})
        self._registry.report({
            "storage_id": storage_id,
            "trial_id": self._trial_id,
            "metadata": metadata or {},
            "time": time.time(),
            "resources": self._storage.list_files(storage_id),
        })
        return storage_id

    @contextlib.contextmanager
    def store_path(self, metadata: Optional[Dict[str, Any]] = None
                   ) -> Iterator[tuple]:
        """Yield (local_dir, holder); write files into local_dir, and after
        the with-block exits cleanly the upload runs and
        ``holder["storage_id"]`` carries the new checkpoint id."""
        tmp = tempfile.mkdtemp()
        try:
            holder: Dict[str, str] = {}
            yield tmp, holder
            holder["storage_id"] = self.upload(tmp, metadata)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def wait_async(self) -> List[str]:
        """Drain in-flight async uploads: none exist in the port, whose
        saves are all synchronous (``store_path_async`` waits)."""
        return []

    def abort_async(self) -> None:
        """Crash-path drain; nothing is ever in flight in the port."""

    def _write_metadata(self, ckpt_dir: str,
                        metadata: Optional[Dict[str, Any]]) -> None:
        meta = dict(metadata or {})
        meta.setdefault("trial_id", self._trial_id)
        with open(os.path.join(ckpt_dir, METADATA_FILE), "w") as f:
            json.dump(meta, f, indent=1)

    def _write_manifest(self, ckpt_dir: str, storage_id: str,
                        entries: Dict[str, Dict[str, Any]]) -> None:
        faults.point("checkpoint.manifest")
        doc = {
            "format": 1,
            "storage_id": storage_id,
            "trial_id": self._trial_id,
            "files": entries,
        }
        with open(os.path.join(ckpt_dir, MANIFEST_FILE), "w") as f:
            json.dump(doc, f, indent=1)

    # -- restore ------------------------------------------------------------

    def download(self, storage_id: str, ckpt_dir: str, *,
                 verify: bool = True) -> None:
        self._storage.download(storage_id, ckpt_dir)
        if verify:
            # a full download: a manifest-listed file that did not arrive
            # at all is corruption too (require_all)
            verify_manifest_digests(ckpt_dir, storage_id, require_all=True)

    @contextlib.contextmanager
    def restore_path(self, storage_id: str, *,
                     validate: bool = True) -> Iterator[str]:
        with self._storage.restore_path(storage_id) as path:
            if validate:
                validate_checkpoint_dir(path, storage_id)
            yield path

    def committed_checkpoints(self, *, newest_first: bool = True
                              ) -> List[str]:
        """storage_ids of this trial's registry checkpoints. The registry
        only ever holds committed ones (publish happens strictly after the
        COMMIT marker), so these are the restore-fallback candidates."""
        out: List[str] = []
        for rec in self._registry.list():
            if rec.get("deleted"):
                continue
            sid = rec.get("storage_id") or rec.get("uuid")
            if not sid:
                continue
            rec_trial = rec.get("trial_id")
            if (self._trial_id is not None and rec_trial is not None
                    and rec_trial != self._trial_id):
                continue
            out.append(sid)
        return out[::-1] if newest_first else out

    def get_metadata(self, storage_id: str) -> Dict[str, Any]:
        with self.restore_path(storage_id, validate=False) as path:
            mpath = os.path.join(path, METADATA_FILE)
            if os.path.exists(mpath):
                with open(mpath) as f:
                    return json.load(f)
        return {}

    # -- delete -------------------------------------------------------------

    def delete(self, storage_id: str) -> None:
        self._storage.delete(storage_id)
        self._registry.report_deleted(storage_id)


def _relative_files(base: str) -> List[str]:
    out = []
    for root, _, files in os.walk(base):
        for f in files:
            out.append(os.path.relpath(os.path.join(root, f), base))
    return sorted(out)
