"""Checkpoint storage backends — the port's copy of the posix part of
``determined_clone_tpu/storage/base.py``.

A :class:`StorageManager` uploads, downloads and deletes a checkpoint
directory by its storage id, and commits it with the ``COMMIT`` marker.
The port has the ``shared_fs`` and ``directory`` backends; the GCS, S3
and Azure managers and the checkpoint half of the content-addressed
store wait (``ROADMAP.md``; its KV half is storage/cas.py). Uploads fan
their files over the shared transfer pool (storage/transfer.py), as in
the JAX package; each copy retries on its own, so a failed file never
redoes the files before it. The directory layout and the commit
protocol are the JAX package's, so either package reads what the other
wrote.
"""
from __future__ import annotations

import abc
import contextlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Iterator, List, Optional

from determined_clone_tpu_torch import faults
from determined_clone_tpu_torch.config.experiment import (
    CheckpointStorageConfig,
)
from determined_clone_tpu_torch.storage import transfer as transfer_pool
from determined_clone_tpu_torch.utils import retry as retry_util

# Commit marker: its presence is the only thing that makes a checkpoint
# restorable under the commit protocol. Written last, atomically.
COMMIT_FILE = "COMMIT"

STORAGE_IO_POLICY = retry_util.RetryPolicy(
    name="storage_io", max_attempts=4, base_delay_s=0.05, max_delay_s=2.0)


def _transfer(fn: Any, *args: Any) -> Any:
    return retry_util.retry_call(fn, *args, policy=STORAGE_IO_POLICY)


class StorageManager(abc.ABC):
    """Store checkpoint directories keyed by storage_id (uuid)."""

    @abc.abstractmethod
    def upload(self, src_dir: str, storage_id: str,
               paths: Optional[List[str]] = None) -> None:
        """Upload files under src_dir (optionally only ``paths``)."""

    @abc.abstractmethod
    def download(self, storage_id: str, dst_dir: str,
                 paths: Optional[List[str]] = None) -> None:
        ...

    @abc.abstractmethod
    def delete(self, storage_id: str) -> None:
        ...

    @abc.abstractmethod
    def list_files(self, storage_id: str) -> Dict[str, int]:
        """{relative_path: size_bytes} for one checkpoint."""

    @abc.abstractmethod
    def commit(self, storage_id: str,
               payload: Optional[Dict[str, Any]] = None) -> None:
        """Write the COMMIT marker as the checkpoint's final act."""

    def delete_files(self, storage_id: str, paths: List[str]) -> None:
        """Delete individual objects of one storage id (idempotent:
        already-missing paths are not an error). The KV tier's namespace
        sweep (storage/cas.py) reclaims single objects with it."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot delete individual files")

    def has_file(self, storage_id: str, rel: str) -> bool:
        """Whether one object exists, without the download's retries: the
        KV tier (storage/cas.py) asks on every lookup, where an absent
        object is a plain miss and not a transient fault."""
        try:
            return rel in self.list_files(storage_id)
        except (FileNotFoundError, KeyError):
            return False

    def file_mtimes(self, storage_id: str,
                    paths: List[str]) -> Dict[str, float]:
        """Wall-clock mtime per relative path (missing files omitted).
        Optional: the namespace sweep orders by it, and skips the sweep
        when a backend cannot stat."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot stat per-file mtimes")

    @contextlib.contextmanager
    def restore_path(self, storage_id: str, base_tmp: Optional[str] = None
                     ) -> Iterator[str]:
        """Yield a local dir containing the downloaded checkpoint."""
        tmp = tempfile.mkdtemp(dir=base_tmp)
        try:
            self.download(storage_id, tmp)
            yield tmp
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


class SharedFSStorageManager(StorageManager):
    """Checkpoints on a filesystem every host sees (NFS, a fuse mount)."""

    def __init__(self, host_path: str,
                 storage_path: Optional[str] = None) -> None:
        self.base = (os.path.join(host_path, storage_path) if storage_path
                     else host_path)

    def _dir(self, storage_id: str) -> str:
        # never trust a path component: an id cannot escape the base dir
        if not storage_id or "/" in storage_id or storage_id in (".", ".."):
            raise ValueError(f"invalid storage_id {storage_id!r}")
        return os.path.join(self.base, storage_id)

    def upload(self, src_dir: str, storage_id: str,
               paths: Optional[List[str]] = None) -> None:
        dst = self._dir(storage_id)
        os.makedirs(dst, exist_ok=True)
        rels = paths if paths is not None else _walk_relative(src_dir)
        # fan per-file copies over the shared transfer pool; retries stay
        # per-file (_transfer) so already-copied files are never redone
        transfer_pool.get_pool().run([
            (lambda rel=rel: _transfer(
                self._copy_in,
                os.path.join(src_dir, rel), os.path.join(dst, rel)))
            for rel in rels
        ])

    @staticmethod
    def _copy_in(src: str, out: str) -> None:
        faults.point("storage.upload")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        shutil.copy2(src, out)
        keep = faults.truncate_bytes("storage.upload")
        if keep is not None:
            # injected torn write: the copy "succeeded" but the tail is gone
            with open(out, "r+b") as f:
                f.truncate(keep)

    def download(self, storage_id: str, dst_dir: str,
                 paths: Optional[List[str]] = None) -> None:
        src = self._dir(storage_id)
        if not os.path.isdir(src):
            raise FileNotFoundError(
                f"checkpoint {storage_id} not found in {self.base}")
        for rel in paths if paths is not None else _walk_relative(src):
            _transfer(self._copy_out, os.path.join(src, rel),
                      os.path.join(dst_dir, rel))

    @staticmethod
    def _copy_out(src: str, out: str) -> None:
        faults.point("storage.download")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        shutil.copy2(src, out)

    def commit(self, storage_id: str,
               payload: Optional[Dict[str, Any]] = None) -> None:
        # fsync + rename: the marker exists complete or not at all
        faults.point("storage.commit")
        d = self._dir(storage_id)
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, ".COMMIT.tmp")
        with open(tmp, "w") as f:
            json.dump(payload or {}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(d, COMMIT_FILE))

    def delete(self, storage_id: str) -> None:
        shutil.rmtree(self._dir(storage_id), ignore_errors=True)

    def delete_files(self, storage_id: str, paths: List[str]) -> None:
        d = self._dir(storage_id)
        for rel in paths:
            try:
                os.remove(os.path.join(d, rel))
            except FileNotFoundError:
                pass  # idempotent: a concurrent sweep already removed it
        # prune now-empty fan-out dirs
        for root, _, _ in os.walk(d, topdown=False):
            if root != d and not os.listdir(root):
                with contextlib.suppress(OSError):
                    os.rmdir(root)

    def has_file(self, storage_id: str, rel: str) -> bool:
        return os.path.isfile(os.path.join(self._dir(storage_id), rel))

    def file_mtimes(self, storage_id: str,
                    paths: List[str]) -> Dict[str, float]:
        d = self._dir(storage_id)
        out: Dict[str, float] = {}
        for rel in paths:
            try:
                out[rel] = os.path.getmtime(os.path.join(d, rel))
            except OSError:
                pass  # vanished mid-sweep: simply absent
        return out

    def list_files(self, storage_id: str) -> Dict[str, int]:
        d = self._dir(storage_id)
        if not os.path.isdir(d):
            return {}
        return {rel: os.path.getsize(os.path.join(d, rel))
                for rel in _walk_relative(d)}


class DirectoryStorageManager(SharedFSStorageManager):
    """Plain local-directory storage (the ``directory`` type)."""

    def __init__(self, container_path: str) -> None:
        super().__init__(container_path)


def _walk_relative(base: str) -> List[str]:
    out = []
    for root, _, files in os.walk(base):
        for f in files:
            out.append(os.path.relpath(os.path.join(root, f), base))
    return sorted(out)


def build(cfg: CheckpointStorageConfig) -> StorageManager:
    """Factory from the checkpoint_storage config block."""
    if cfg.type == "shared_fs":
        return SharedFSStorageManager(cfg.host_path, cfg.storage_path)
    if cfg.type == "directory":
        return DirectoryStorageManager(cfg.container_path)
    raise ValueError(f"unknown storage type {cfg.type!r}")
