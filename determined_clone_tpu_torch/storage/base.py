"""Checkpoint storage backends — the port's copy of
``determined_clone_tpu/storage/base.py``.

A :class:`StorageManager` uploads, downloads and deletes a checkpoint
directory by its storage id, and commits it with the ``COMMIT`` marker.
The backends are ``shared_fs``, ``directory``, ``gcs``, ``s3`` and
``azure``; ``type: cas`` wraps any of them in the content-addressed
store (storage/cas.py). The cloud managers take an injected client (the
tests use in-memory fakes); without one they import their SDK lazily
and raise naming it when it is missing. Uploads fan
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
import time
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

    def commit(self, storage_id: str,
               payload: Optional[Dict[str, Any]] = None) -> None:
        """Write the COMMIT marker as the checkpoint's final act.

        Backends with an atomic rename (shared_fs) override this; the
        default uploads the marker as one more object, which an object
        store writes atomically per key."""
        faults.point("storage.commit")
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, COMMIT_FILE), "w") as f:
                json.dump(payload or {}, f)
            self.upload(tmp, storage_id, paths=[COMMIT_FILE])

    def is_committed(self, storage_id: str) -> bool:
        return COMMIT_FILE in self.list_files(storage_id)

    def list_storage_ids(self) -> List[str]:
        """Every checkpoint id this manager can see (for the GC task's
        uncommitted sweep, ``exec/gc_checkpoints.py``); only backends
        that can enumerate cheaply implement it."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot enumerate checkpoints")

    def storage_age_s(self, storage_id: str) -> Optional[float]:
        """Seconds since the checkpoint's newest write, or None if unknown
        (the GC never sweeps an uncommitted checkpoint of unknown age)."""
        return None

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
    def store_path(self, storage_id: str, base_tmp: Optional[str] = None
                   ) -> Iterator[str]:
        """Yield a local dir; upload its contents on clean exit."""
        tmp = tempfile.mkdtemp(dir=base_tmp)
        try:
            yield tmp
            self.upload(tmp, storage_id)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

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

    def list_storage_ids(self) -> List[str]:
        if not os.path.isdir(self.base):
            return []
        return sorted(d for d in os.listdir(self.base)
                      if os.path.isdir(os.path.join(self.base, d)))

    def storage_age_s(self, storage_id: str) -> Optional[float]:
        d = self._dir(storage_id)
        if not os.path.isdir(d):
            return None
        mtimes = [os.path.getmtime(os.path.join(d, rel))
                  for rel in _walk_relative(d)]
        newest = max(mtimes) if mtimes else os.path.getmtime(d)
        return time.time() - newest  # file mtimes are wall-clock


class DirectoryStorageManager(SharedFSStorageManager):
    """Plain local-directory storage (the ``directory`` type)."""

    def __init__(self, container_path: str) -> None:
        super().__init__(container_path)


def _object_key(prefix: str, storage_id: str, rel: str) -> str:
    return "/".join(p for p in (prefix, storage_id, rel) if p)


def _list_prefix(prefix: str, storage_id: str) -> str:
    # trailing slash: without it, 'ck-1' would match 'ck-12/...' too
    return _object_key(prefix, storage_id, "") + "/"


class GCSStorageManager(StorageManager):
    """GCS backend. The client is injectable (tests use an in-memory fake);
    by default it needs google-cloud-storage and application-default
    credentials."""

    def __init__(self, bucket: str, prefix: Optional[str] = None,
                 client: Optional[object] = None) -> None:
        if client is None:  # pragma: no cover - needs the real client lib
            try:
                from google.cloud import storage as gcs  # type: ignore

                client = gcs.Client()
            except Exception as e:
                raise RuntimeError(
                    "checkpoint_storage type 'gcs' needs google-cloud-storage "
                    "and application-default credentials; a shared_fs "
                    "gcsfuse mount is the zero-config alternative") from e
        self.client = client
        self.bucket = self.client.bucket(bucket)
        self.prefix = (prefix or "").strip("/")

    def _key(self, storage_id: str, rel: str) -> str:
        return _object_key(self.prefix, storage_id, rel)

    def upload(self, src_dir, storage_id, paths=None):
        for rel in paths if paths is not None else _walk_relative(src_dir):
            _transfer(self._upload_one, src_dir, storage_id, rel)

    def _upload_one(self, src_dir, storage_id, rel):
        faults.point("storage.upload")
        self.bucket.blob(self._key(storage_id, rel)).upload_from_filename(
            os.path.join(src_dir, rel))

    def _blobs(self, storage_id):
        return self.client.list_blobs(
            self.bucket, prefix=_list_prefix(self.prefix, storage_id))

    def download(self, storage_id, dst_dir, paths=None):
        for blob in self._blobs(storage_id):
            rel = blob.name.split(f"{storage_id}/", 1)[1]
            if paths is not None and rel not in paths:
                continue
            out = os.path.join(dst_dir, rel)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            _transfer(self._download_one, blob, out)

    @staticmethod
    def _download_one(blob, out):
        faults.point("storage.download")
        blob.download_to_filename(out)

    def delete(self, storage_id):
        for blob in self._blobs(storage_id):
            blob.delete()

    def delete_files(self, storage_id, paths):
        for rel in paths:
            try:
                self.bucket.blob(self._key(storage_id, rel)).delete()
            except Exception:
                pass  # already-missing blob: delete_files is idempotent

    def list_files(self, storage_id):
        return {blob.name.split(f"{storage_id}/", 1)[1]: blob.size
                for blob in self._blobs(storage_id)}


class S3StorageManager(StorageManager):
    """S3 backend. The client is injectable (tests use an in-memory fake);
    by default it needs boto3."""

    def __init__(self, bucket: str, prefix: Optional[str] = None,
                 client: Optional[object] = None) -> None:
        if client is None:  # pragma: no cover - needs the real client lib
            try:
                import boto3  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "checkpoint_storage type 's3' requires boto3 "
                    "(not installed)") from e
            client = boto3.client("s3")
        self.s3 = client
        self.bucket_name = bucket
        self.prefix = (prefix or "").strip("/")

    def _key(self, storage_id: str, rel: str) -> str:
        return _object_key(self.prefix, storage_id, rel)

    def _list_all(self, prefix: str):
        # list_objects_v2 pages at 1000 keys; sharded checkpoints can
        # exceed that, so follow continuation tokens
        token = None
        while True:
            kwargs = {"Bucket": self.bucket_name, "Prefix": prefix}
            if token:
                kwargs["ContinuationToken"] = token
            resp = self.s3.list_objects_v2(**kwargs)
            yield from resp.get("Contents", [])
            if not resp.get("IsTruncated"):
                return
            token = resp.get("NextContinuationToken")

    def _objects(self, storage_id):
        return self._list_all(_list_prefix(self.prefix, storage_id))

    def upload(self, src_dir, storage_id, paths=None):
        for rel in paths if paths is not None else _walk_relative(src_dir):
            _transfer(self._upload_one, src_dir, storage_id, rel)

    def _upload_one(self, src_dir, storage_id, rel):
        faults.point("storage.upload")
        self.s3.upload_file(os.path.join(src_dir, rel), self.bucket_name,
                            self._key(storage_id, rel))

    def download(self, storage_id, dst_dir, paths=None):
        for item in self._objects(storage_id):
            rel = item["Key"].split(f"{storage_id}/", 1)[1]
            if paths is not None and rel not in paths:
                continue
            out = os.path.join(dst_dir, rel)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            _transfer(self._download_one, item["Key"], out)

    def _download_one(self, key, out):
        faults.point("storage.download")
        self.s3.download_file(self.bucket_name, key, out)

    def delete(self, storage_id):
        for item in list(self._objects(storage_id)):
            self.s3.delete_object(Bucket=self.bucket_name, Key=item["Key"])

    def delete_files(self, storage_id, paths):
        # delete_object is idempotent by API contract (no error on missing)
        for rel in paths:
            self.s3.delete_object(Bucket=self.bucket_name,
                                  Key=self._key(storage_id, rel))

    def list_files(self, storage_id):
        return {item["Key"].split(f"{storage_id}/", 1)[1]: item["Size"]
                for item in self._objects(storage_id)}


class AzureStorageManager(StorageManager):
    """Azure Blob Storage backend over azure-storage-blob. The container
    client is injectable (tests use an in-memory fake)."""

    def __init__(self, container: str,
                 connection_string: Optional[str] = None,
                 prefix: Optional[str] = None,
                 container_client: Optional[object] = None) -> None:
        if container_client is None:  # pragma: no cover - needs client lib
            try:
                from azure.storage.blob import (  # type: ignore
                    BlobServiceClient,
                )
            except ImportError as e:
                raise RuntimeError(
                    "checkpoint_storage type 'azure' requires "
                    "azure-storage-blob (not installed)") from e
            if not connection_string:
                raise RuntimeError(
                    "checkpoint_storage type 'azure' requires a "
                    "connection_string")
            service = BlobServiceClient.from_connection_string(
                connection_string)
            container_client = service.get_container_client(container)
        self.container = container_client
        self.prefix = (prefix or "").strip("/")

    def _key(self, storage_id: str, rel: str) -> str:
        return _object_key(self.prefix, storage_id, rel)

    def _blobs(self, storage_id):
        return self.container.list_blobs(
            name_starts_with=_list_prefix(self.prefix, storage_id))

    def upload(self, src_dir, storage_id, paths=None):
        for rel in paths if paths is not None else _walk_relative(src_dir):
            _transfer(self._upload_one, src_dir, storage_id, rel)

    def _upload_one(self, src_dir, storage_id, rel):
        faults.point("storage.upload")
        with open(os.path.join(src_dir, rel), "rb") as f:
            self.container.upload_blob(self._key(storage_id, rel), f,
                                       overwrite=True)

    def download(self, storage_id, dst_dir, paths=None):
        for blob in self._blobs(storage_id):
            rel = blob.name.split(f"{storage_id}/", 1)[1]
            if paths is not None and rel not in paths:
                continue
            out = os.path.join(dst_dir, rel)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            _transfer(self._download_one, blob.name, out)

    def _download_one(self, name, out):
        faults.point("storage.download")
        with open(out, "wb") as f:
            f.write(self.container.download_blob(name).readall())

    def delete(self, storage_id):
        for blob in list(self._blobs(storage_id)):
            self.container.delete_blob(blob.name)

    def delete_files(self, storage_id, paths):
        for rel in paths:
            try:
                self.container.delete_blob(self._key(storage_id, rel))
            except Exception:
                pass  # already-missing blob: delete_files is idempotent

    def list_files(self, storage_id):
        return {blob.name.split(f"{storage_id}/", 1)[1]: blob.size
                for blob in self._blobs(storage_id)}


def _walk_relative(base: str) -> List[str]:
    out = []
    for root, _, files in os.walk(base):
        for f in files:
            out.append(os.path.relpath(os.path.join(root, f), base))
    return sorted(out)


def build(cfg: CheckpointStorageConfig) -> StorageManager:
    """Factory from the checkpoint_storage config union."""
    if cfg.type == "cas":
        # lazy import: cas.py imports from this module
        from determined_clone_tpu_torch.storage import cas as cas_mod

        if cfg.inner is None:
            raise ValueError("checkpoint_storage type 'cas' needs an "
                             "'inner' backend block")
        return cas_mod.build_cas(cfg, build(cfg.inner))
    if cfg.type == "shared_fs":
        return SharedFSStorageManager(cfg.host_path, cfg.storage_path)
    if cfg.type == "directory":
        return DirectoryStorageManager(cfg.container_path)
    if cfg.type == "gcs":
        return GCSStorageManager(cfg.bucket, cfg.prefix)
    if cfg.type == "s3":
        return S3StorageManager(cfg.bucket, cfg.prefix)
    if cfg.type == "azure":
        return AzureStorageManager(cfg.container, cfg.connection_string,
                                   cfg.prefix)
    raise ValueError(f"unknown storage type {cfg.type!r}")
