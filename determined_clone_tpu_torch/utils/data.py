"""Data utilities: in-memory datasets, batch iterators and device feeders
— the port of ``determined_clone_tpu/utils/data.py``.

Batches are numpy pytrees (dicts, tuples, lists of arrays) on the host;
the trainer places whole global batches on the device. Shuffles are
seeded by (seed, epoch), so the same config yields the same batch order
in both packages, and a restored run skips what it has trained by
arithmetic (:meth:`BatchIterator.skip_batches`).

Device feeding overlaps the host's input work with the device's compute.
:class:`DevicePrefetcher` pulls batches and places them on a background
thread into a bounded queue; :class:`SyncDeviceFeeder` does the same
inline (depth 0). On CUDA, :class:`CudaStager` places a batch the way the
prefetcher needs: the producer copies it into pinned host memory and on
to the card with ``non_blocking=True`` on a side stream, recording an
event; the consumer's stream waits for that event before it uses the
batch, and each tensor is marked as used by the consumer's stream
(``record_stream``) so the allocator does not hand its memory to another
copy while the step may still read it. Without the wait the step could
read a batch the copy has not finished writing, silently.
"""
from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
import time
from typing import Any, Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from determined_clone_tpu_torch import faults
from determined_clone_tpu_torch.device import DeviceLike, resolve_device

_PROTO_SEED = 1234  # class prototypes are fixed across splits


def synthetic_mnist(n: int = 8192, seed: int = 0, image: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """A learnable 10-class stand-in for MNIST: each class is a fixed random
    prototype in 784-d (shared across train/val splits), samples are
    prototype + gaussian noise. ``seed`` only varies the samples."""
    protos = np.random.RandomState(_PROTO_SEED).randn(10, 784).astype(np.float32)
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int32)
    x = protos[labels] + 0.9 * rng.randn(n, 784).astype(np.float32)
    if image:
        x = x.reshape(n, 28, 28, 1)
    return x, labels


def load_mnist_idx(data_dir: str, split: str = "train", image: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Load MNIST from IDX files (raw or .gz) if present."""
    prefix = "train" if split == "train" else "t10k"
    imgs = _read_idx(os.path.join(data_dir, f"{prefix}-images-idx3-ubyte"))
    labels = _read_idx(os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte"))
    x = imgs.astype(np.float32) / 255.0
    y = labels.astype(np.int32)
    if image:
        x = x.reshape(-1, 28, 28, 1)
    else:
        x = x.reshape(-1, 784)
    return x, y


def _read_idx(path: str) -> np.ndarray:
    opener = open
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path, opener = path + ".gz", gzip.open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


# scikit-learn's bundled copy of the UCI optdigits scans (BSD-3-Clause;
# README.md): one row per scan, 64 pixel values 0-16 then the label
_DIGITS_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "digits.csv.gz")


def digits_dataset(split: str = "train", image: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Real handwritten digits without a download: the 1,797 8×8 scans of
    scikit-learn's digits set, read from the copy kept beside this module
    as ``load_digits`` reads it, upsampled to the 28×28 MNIST geometry
    (×4 nearest-neighbour, centre crop), with a held-out test split —
    the same arrays as the JAX package's ``digits_dataset``."""
    with gzip.open(_DIGITS_CSV, "rt", encoding="utf-8") as f:
        data = np.loadtxt(f, delimiter=",")
    x = data[:, :-1].reshape(-1, 8, 8).astype(np.float32) / 16.0
    y = data[:, -1].astype(int).astype(np.int32)
    x = np.repeat(np.repeat(x, 4, axis=1), 4, axis=2)[:, 2:30, 2:30]
    idx = np.random.RandomState(_PROTO_SEED).permutation(len(x))
    n_train = int(0.8 * len(x))
    sel = idx[:n_train] if split == "train" else idx[n_train:]
    x, y = x[sel], y[sel]
    if image:
        x = x[..., None]
    else:
        x = x.reshape(len(x), -1)
    return np.ascontiguousarray(x), np.ascontiguousarray(y)


def mnist_dataset(data_dir: Optional[str] = None, split: str = "train",
                  image: bool = False, synthetic_n: int = 8192,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Real MNIST if ``data_dir`` has IDX files, else the synthetic
    stand-in (as the JAX package's ``mnist_dataset``)."""
    if data_dir:
        try:
            return load_mnist_idx(data_dir, split, image)
        except FileNotFoundError:
            pass
    return synthetic_mnist(
        synthetic_n if split == "train" else max(1024, synthetic_n // 8),
        seed=seed if split == "train" else seed + 1,
        image=image,
    )


class BatchIterator:
    """Deterministic shuffled batches of (x, y) with an index-skip fast path.

    The shuffle order is fixed up front from (seed, epoch), so skipping n
    already-consumed batches (checkpoint-restore replay) is pure arithmetic
    on the cursor — no gather, no copy — via :meth:`skip_batches`. The
    Trainer probes for that method when fast-forwarding a restored run.
    """

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int, *,
                 seed: int = 0, epoch: int = 0, shuffle: bool = True,
                 drop_remainder: bool = True) -> None:
        self._x, self._y = x, y
        self._batch_size = batch_size
        n = len(x)
        idx = np.arange(n)
        if shuffle:
            np.random.RandomState(
                (seed * 1_000_003 + epoch) % (2**31)).shuffle(idx)
        self._idx = idx
        self._end = n - (n % batch_size) if drop_remainder else n
        self._pos = 0

    def __iter__(self) -> "BatchIterator":
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._pos >= self._end:
            raise StopIteration
        sel = self._idx[self._pos:self._pos + self._batch_size]
        self._pos += self._batch_size
        return self._x[sel], self._y[sel]

    def __len__(self) -> int:
        """Batches remaining (partial final batch counts when kept)."""
        left = max(self._end - self._pos, 0)
        return -(-left // self._batch_size)

    def skip_batches(self, n: int) -> int:
        """Advance past up to ``n`` batches without materializing them;
        returns how many were actually skipped (< n once exhausted)."""
        k = min(max(n, 0), len(self))
        self._pos += k * self._batch_size
        return k


def batch_iterator(x: np.ndarray, y: np.ndarray, batch_size: int, *,
                   seed: int = 0, epoch: int = 0, shuffle: bool = True,
                   drop_remainder: bool = True) -> BatchIterator:
    """Deterministic shuffled batches of (x, y)."""
    return BatchIterator(x, y, batch_size, seed=seed, epoch=epoch,
                         shuffle=shuffle, drop_remainder=drop_remainder)


# ---------------------------------------------------------------------------
# Batches onto the device
# ---------------------------------------------------------------------------

def map_batch(fn: Callable[[Any], Any], batch: Any) -> Any:
    """``fn`` applied to every array of a batch (dicts, tuples, lists)."""
    if isinstance(batch, dict):
        return {k: map_batch(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(map_batch(fn, v) for v in batch)
    return fn(batch)


def batch_leaves(batch: Any) -> List[Any]:
    """The arrays of a batch, in order."""
    if isinstance(batch, dict):
        return [x for v in batch.values() for x in batch_leaves(v)]
    if isinstance(batch, (tuple, list)):
        return [x for v in batch for x in batch_leaves(v)]
    return [batch]


def batch_to_device(batch: Any, device: DeviceLike = "cuda") -> Any:
    """A host batch as tensors on ``device``, copied on the calling
    thread's current stream (a copy on the CPU too, never a view of the
    trial's arrays)."""
    dev = resolve_device(device)
    return map_batch(lambda a: torch.tensor(np.asarray(a), device=dev), batch)


class CudaStager:
    """Places host batches on a CUDA device for :class:`DevicePrefetcher`:
    :meth:`put` runs on the producer thread, :meth:`ready` on the
    consumer's, as the prefetcher's ``put`` and ``ready``."""

    def __init__(self, device: DeviceLike = "cuda") -> None:
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CudaStager needs a CUDA device, got "
                             f"{self.device}")
        self.stream = torch.cuda.Stream(device=self.device)

    def _copy(self, a: Any) -> torch.Tensor:
        pinned = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
        return pinned.to(self.device, non_blocking=True)

    def put(self, batch: Any) -> Tuple[Any, torch.cuda.Event]:
        """Start the batch's copy on the side stream; returns it with the
        event that marks the copy's end."""
        with torch.cuda.stream(self.stream):
            staged = map_batch(self._copy, batch)
            done = torch.cuda.Event()
            done.record(self.stream)
        return staged, done

    def ready(self, item: Tuple[Any, torch.cuda.Event]) -> Any:
        """Make the consumer's current stream wait for the copy, and keep
        the tensors' memory from reuse until that stream's work on them
        is done."""
        staged, done = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        for t in batch_leaves(staged):
            t.record_stream(stream)
        return staged


# ---------------------------------------------------------------------------
# Device feeding: async prefetch so host input overlaps device compute
# ---------------------------------------------------------------------------

_ITEM, _DONE, _ERROR = "item", "done", "error"


def _identity(x: Any) -> Any:
    return x


class DevicePrefetcher:
    """Background-thread device feeder with a bounded queue.

    A producer thread pulls host batches from ``iterator``, applies
    ``put`` (placing the batch on the device) and parks up to ``depth``
    placed batches in a queue; the consumer's ``next()`` applies ``ready``
    to each (for a stream wait) and only blocks when the device outruns
    the host.

    Shutdown is cooperative and deadlock-free in both directions:

    - the producer never blocks forever on a full queue (it offers with a
      timeout and re-checks the stop flag), so a consumer that dies
      mid-chunk cannot strand the thread;
    - ``close()`` signals stop, drains the queue to unwedge the producer,
      and joins it — preemption/exception paths leak nothing.

    Exceptions raised by the host iterator or by ``put`` are forwarded to
    the consumer and re-raised from ``next()``.
    """

    def __init__(self, iterator: Iterable[Any],
                 put: Optional[Callable[[Any], Any]] = None, *,
                 depth: int = 2, name: str = "device-prefetch",
                 ready: Optional[Callable[[Any], Any]] = None) -> None:
        self._it = iter(iterator)
        self._put = put if put is not None else _identity
        self._ready = ready if ready is not None else _identity
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._finished = False           # consumer saw done/error
        self._closed = False
        # host_time is the producer's true input cost (pull + put) even
        # when hidden by overlap; queue_wait is the consumer-visible stall
        self._host_time_s = 0.0
        self._host_time_taken = 0.0
        self._queue_wait_s = 0.0
        self._thread = threading.Thread(target=self._producer, daemon=True,
                                        name=name)
        self._thread.start()

    # -- producer -----------------------------------------------------------

    def _offer(self, msg: Tuple[str, Any]) -> bool:
        """Bounded put that never outlives a dead consumer."""
        while not self._stop.is_set():
            try:
                self._queue.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                # injected errors ride the normal forwarding path: the
                # consumer re-raises at its next __next__
                faults.point("data.produce")
                batch = self._put(next(self._it))
            except StopIteration:
                self._offer((_DONE, None))
                return
            except BaseException as exc:  # noqa: BLE001 - forwarded
                self._offer((_ERROR, exc))
                return
            self._host_time_s += time.perf_counter() - t0
            if not self._offer((_ITEM, batch)):
                return

    # -- consumer -----------------------------------------------------------

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Any:
        if self._finished or self._closed:
            raise StopIteration
        t0 = time.perf_counter()
        tag, payload = self._queue.get()
        self._queue_wait_s += time.perf_counter() - t0
        if tag == _ITEM:
            return self._ready(payload)
        self._finished = True
        if tag == _ERROR:
            raise payload
        raise StopIteration

    # -- accounting ---------------------------------------------------------

    def take_queue_wait(self) -> float:
        """Consumer stall time since the last call (the overlap residue)."""
        out, self._queue_wait_s = self._queue_wait_s, 0.0
        return out

    def take_host_time(self) -> float:
        """Producer-side input time since the last call (may be hidden)."""
        cur = self._host_time_s  # float read is atomic under the GIL
        out = cur - self._host_time_taken
        self._host_time_taken = cur
        return out

    # -- lifecycle ----------------------------------------------------------

    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer and join it. Idempotent; safe mid-stream."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        # drain so a producer blocked in _offer's put() wakes immediately
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=timeout)

    @property
    def thread_alive(self) -> bool:
        return self._thread.is_alive()


class SyncDeviceFeeder:
    """Synchronous twin of :class:`DevicePrefetcher` (depth 0): pulls and
    ``put``s inline on the consumer thread, so the trainer's hot loop has
    the same shape with prefetch on or off."""

    def __init__(self, iterator: Iterable[Any],
                 put: Optional[Callable[[Any], Any]] = None) -> None:
        self._it = iter(iterator)
        self._put = put if put is not None else _identity
        self._host_time_s = 0.0
        self._taken = {"wait": 0.0, "host": 0.0}

    def __iter__(self) -> "SyncDeviceFeeder":
        return self

    def __next__(self) -> Any:
        t0 = time.perf_counter()
        faults.point("data.produce")  # parity with the prefetching producer
        batch = self._put(next(self._it))
        self._host_time_s += time.perf_counter() - t0
        return batch

    def _take(self, key: str) -> float:
        out = self._host_time_s - self._taken[key]
        self._taken[key] = self._host_time_s
        return out

    def take_queue_wait(self) -> float:
        """Synchronous path: the whole input time is consumer-visible."""
        return self._take("wait")

    def take_host_time(self) -> float:
        return self._take("host")

    def close(self, timeout: float = 0.0) -> None:
        pass


def make_device_feeder(iterator: Iterable[Any],
                       put: Optional[Callable[[Any], Any]] = None, *,
                       depth: int = 2, name: str = "device-prefetch",
                       ready: Optional[Callable[[Any], Any]] = None):
    """``depth >= 1`` → async :class:`DevicePrefetcher`; ``depth == 0`` →
    :class:`SyncDeviceFeeder`, whose inline ``put`` needs no ``ready``."""
    if depth and depth > 0:
        return DevicePrefetcher(iterator, put, depth=depth, name=name,
                                ready=ready)
    return SyncDeviceFeeder(iterator, put)
