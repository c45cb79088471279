"""Checkpoint storage backends (shared_fs and directory)."""
from determined_clone_tpu_torch.storage.base import (
    COMMIT_FILE,
    DirectoryStorageManager,
    SharedFSStorageManager,
    StorageManager,
    build,
)

__all__ = [
    "COMMIT_FILE",
    "DirectoryStorageManager",
    "SharedFSStorageManager",
    "StorageManager",
    "build",
]
