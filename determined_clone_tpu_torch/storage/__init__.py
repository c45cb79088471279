"""Checkpoint storage backends: shared_fs, directory, the GCS, S3 and
Azure managers, and the content-addressed store (storage/cas.py)."""
from determined_clone_tpu_torch.storage.base import (
    COMMIT_FILE,
    AzureStorageManager,
    DirectoryStorageManager,
    GCSStorageManager,
    S3StorageManager,
    SharedFSStorageManager,
    StorageManager,
    build,
)
from determined_clone_tpu_torch.storage.cas import (
    BlobIntegrityError,
    BlobService,
    CASStorageManager,
    ChunkCache,
)
from determined_clone_tpu_torch.storage.transfer import (
    TransferPool,
    get_pool,
    reset_pool,
)

__all__ = [
    "COMMIT_FILE",
    "AzureStorageManager",
    "BlobIntegrityError",
    "BlobService",
    "CASStorageManager",
    "ChunkCache",
    "DirectoryStorageManager",
    "GCSStorageManager",
    "S3StorageManager",
    "SharedFSStorageManager",
    "StorageManager",
    "TransferPool",
    "build",
    "get_pool",
    "reset_pool",
]
