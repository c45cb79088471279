"""Per-device memory telemetry on ``torch.cuda`` — the port of
``determined_clone_tpu/telemetry/device.py``, with its records, gauges and
peak watermark.

A rank of the port drives one card (``exec/launch.py`` starts a process
per card), so the local devices are the current CUDA device, keyed
``gpu:{index}`` as JAX keys ``platform:id``. Its record maps the JAX
keys onto the caching allocator's statistics:

- ``bytes_in_use``: ``torch.cuda.memory_stats()["allocated_bytes.all.current"]``;
- ``peak_bytes_in_use``: ``["allocated_bytes.all.peak"]`` — torch's peak
  counts from the last ``torch.cuda.reset_peak_memory_stats()``, not from
  the start of the process as the XLA client's does;
- ``bytes_limit``: the total of ``torch.cuda.mem_get_info()``.

Where this process has not initialised CUDA (a trial on the CPU), the
record is the JAX CPU fallback's: the process RSS from
``/proc/self/status``, once, labelled ``device="host"``. JAX also gives
each virtual CPU device a ``live_buffers`` record from
``jax.live_arrays()``; torch keeps no registry of live CPU tensors, so
the port has no such record, and :func:`live_buffer_bytes_by_device` is
empty off the card.

:class:`DeviceMemoryMonitor` adds the per-chunk peak watermark: the
highest summed ``bytes_in_use`` any sample saw since the last
``take_peak()``.

torch is imported inside the samplers, so this module loads in
processes that never touch a device.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

# process-wide peak watermark over summed bytes_in_use: EVERY snapshot
# raises it, so the trainer's per-chunk take sees spikes other samplers
# saw between boundaries
_WATERMARK_LOCK = threading.Lock()
_WATERMARK = 0.0


def _raise_watermark(total: float) -> None:
    global _WATERMARK
    with _WATERMARK_LOCK:
        if total > _WATERMARK:
            _WATERMARK = total


def take_peak_bytes() -> float:
    """Process-wide peak of summed device bytes_in_use since the last
    take; resets. One taker (the trainer) at a time is the contract."""
    global _WATERMARK
    with _WATERMARK_LOCK:
        peak, _WATERMARK = _WATERMARK, 0.0
    return peak


def host_rss_bytes() -> Optional[int]:
    """Resident set size of this process, or None off-Linux."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024  # kB -> bytes
    except (OSError, ValueError, IndexError):
        pass
    return None


def _cuda_device() -> Optional[int]:
    """This process's CUDA device, or None when it has not initialised
    CUDA (so the samplers never create a context)."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_device()


def live_buffer_bytes_by_device() -> Dict[str, float]:
    """Bytes the caching allocator holds for live tensors on this
    process's card (``torch.cuda.memory_allocated``); empty when the
    process has not initialised CUDA."""
    import torch

    index = _cuda_device()
    if index is None:
        return {}
    return {f"gpu:{index}": float(torch.cuda.memory_allocated(index))}


def device_memory_snapshot() -> List[Dict[str, Any]]:
    """One record per local device: ``{"device", "platform",
    "bytes_in_use", "bytes_limit", "peak_bytes_in_use", "source"}``,
    ``source`` ``"memory_stats"`` on the card; off the card one
    ``"rss"`` record for the host."""
    import torch

    index = _cuda_device()
    records: List[Dict[str, Any]] = []
    if index is not None:
        stats = torch.cuda.memory_stats(index)
        _, total = torch.cuda.mem_get_info(index)
        records.append({
            "device": f"gpu:{index}",
            "platform": "gpu",
            "bytes_in_use": float(stats.get("allocated_bytes.all.current",
                                            0)),
            "bytes_limit": float(total),
            "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak",
                                                 0)),
            "source": "memory_stats",
        })
    else:
        rss = host_rss_bytes()
        if rss is not None:
            records.append({
                "device": "host",
                "platform": "cpu",
                "bytes_in_use": float(rss),
                "bytes_limit": 0.0,
                "peak_bytes_in_use": float(rss),
                "source": "rss",
            })
    if records:
        _raise_watermark(sum(r["bytes_in_use"] for r in records))
    return records


def device_memory_stats() -> Dict[str, float]:
    """Flat cross-device sums in the profiler's historical sample shape
    (``device_bytes_in_use``, ``device_bytes_limit``, ``device_count``,
    ``device_peak_bytes_in_use``)."""
    records = device_memory_snapshot()
    if not records:
        return {}
    out = {
        "device_bytes_in_use": sum(r["bytes_in_use"] for r in records),
        "device_bytes_limit": sum(r["bytes_limit"] for r in records),
        "device_count": float(
            len([r for r in records if r["device"] != "host"])),
    }
    peak = sum(r["peak_bytes_in_use"] for r in records)
    if peak:
        out["device_peak_bytes_in_use"] = peak
    return out


class DeviceMemoryMonitor:
    """Feeds per-device gauges and keeps a resettable peak watermark.

    ``sample()`` may be called from several threads; the watermark
    update is guarded. ``take_peak()`` returns the high-water mark of
    summed ``bytes_in_use`` since the last take — the trainer publishes
    it as ``device_memory_peak_bytes`` per chunk. On the card it lies
    between ``torch.cuda.memory_allocated()`` at the boundary and
    ``torch.cuda.max_memory_allocated()``.
    """

    def __init__(self, registry: Optional[Any] = None) -> None:
        self._registry = registry
        self._lock = threading.Lock()
        self._peak = 0.0

    def sample(self) -> Dict[str, float]:
        records = device_memory_snapshot()
        total_in_use = sum(r["bytes_in_use"] for r in records)
        with self._lock:
            self._peak = max(self._peak, total_in_use)
        reg = self._registry
        if reg is not None and records:
            for r in records:
                labels = {"device": r["device"], "source": r["source"]}
                reg.gauge("device_memory_bytes_in_use",
                          "device memory in use (RSS on CPU fallback)",
                          labels=labels).set(r["bytes_in_use"])
                if r["bytes_limit"]:
                    reg.gauge("device_memory_bytes_limit",
                              "device memory capacity",
                              labels=labels).set(r["bytes_limit"])
        return device_memory_stats()

    def take_peak(self) -> float:
        """Max summed bytes_in_use since the previous take; resets.
        Covers the process-wide watermark too, so samples taken by other
        actors raise this monitor's peak between its own samples."""
        with self._lock:
            peak, self._peak = self._peak, 0.0
        return max(peak, take_peak_bytes())


def _first_tensor(tree: Any) -> Optional[Any]:
    import torch

    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        children = (getattr(tree, f.name) for f in dataclasses.fields(tree))
    else:
        return None
    for child in children:
        found = _first_tensor(child)
        if found is not None:
            return found
    return None


def block_until_ready(tree: Any) -> Any:
    """Wait until the device has finished the work that produced
    ``tree`` — the counterpart of ``jax.block_until_ready``: a wait on
    the current stream of the device its first tensor lies on (the
    port's step runs on one stream). CPU tensors are ready when
    returned. Returns ``tree``."""
    t = _first_tensor(tree)
    if t is not None and t.device.type == "cuda":
        import torch

        torch.cuda.current_stream(t.device).synchronize()
    return tree
