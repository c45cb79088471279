"""Mesh observability: per-device lanes and cross-device straggler
detection — the port of ``determined_clone_tpu/telemetry/mesh.py``.

The JAX module's ``per_device_completion_seconds`` blocks on each shard
of a sharded output from the one process that drives every device. A
rank of the port drives one card, so what stands in is:

- :class:`RankStepTimer` — each rank times its own step, with CUDA
  events on the card and ``perf_counter`` (to the step's completion) on
  the CPU;
- :func:`rank_step_seconds` — the durations gathered once per window
  with ``DistributedContext.allgather`` (never inside a timed step),
  keyed ``gpu:{rank}`` (``cpu:{rank}`` for gloo ranks).

:func:`device_lane_records` turns those durations into span records
with a ``device`` key, one Chrome process lane per device, and
:class:`MeshStragglerDetector` compares each window's slowest device
with the window's device median, flagging at most one device per window
in ``mesh_straggler_events_total{device=...}``. Both, with the versioned
MULTICHIP artifact schema (:func:`validate_multichip`,
:func:`format_multichip`), are the JAX package's.
"""
from __future__ import annotations

import collections
import statistics
import time
from typing import Any, Deque, Dict, List, Optional

from determined_clone_tpu_torch.telemetry.compile import MAD_SIGMA_SCALE

# Versioned structured MULTICHIP artifact: bump on any breaking key
# change and teach validate_multichip both shapes.
MULTICHIP_SCHEMA_VERSION = 1


class RankStepTimer:
    """Times this rank's steps on ``device``: a CUDA event pair around
    each step on the card (read after the step has completed), the host
    clock to the step's completion on the CPU."""

    def __init__(self, device: Any) -> None:
        import torch

        self._cuda = torch.device(device).type == "cuda"
        self._t0 = 0.0
        self._events: List[Any] = []
        self.seconds: List[float] = []

    def start(self) -> None:
        if self._cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.append(ev)
        else:
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        """Mark the step's end; on the CPU the step has completed."""
        if self._cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.append(ev)
        else:
            self.seconds.append(time.perf_counter() - self._t0)

    def take(self) -> List[float]:
        """Every step's seconds since the last take; on the card this
        waits for the last step's end event."""
        if self._cuda:
            pairs = zip(self._events[0::2], self._events[1::2])
            for start, end in pairs:
                end.synchronize()
                self.seconds.append(start.elapsed_time(end) / 1e3)
            self._events = []
        out, self.seconds = self.seconds, []
        return out


def rank_step_seconds(dist: Any, seconds: List[float],
                      platform: str) -> List[Dict[str, float]]:
    """One dict per step window, ``{f"{platform}:{rank}": seconds}`` over
    every rank: each rank's own ``seconds`` (one per step), gathered in
    one ``dist.allgather`` (a ``DistributedContext``)."""
    per_rank = dist.allgather([float(s) for s in seconds])
    n = min(len(s) for s in per_rank)
    return [{f"{platform}:{r}": float(s[i]) for r, s in enumerate(per_rank)}
            for i in range(n)]


def device_lane_records(durations: Dict[str, float], *,
                        start_s: float, wall_epoch: Optional[float] = None,
                        step_index: int = 0,
                        name: str = "device_step") -> List[Dict[str, Any]]:
    """Span records (Tracer/event shape) for one dispatch, one per device.

    Each record carries ``device`` + a ``device:<id>`` process label, so
    ``stitch_chrome_trace`` gives every device its own lane; ``tid``/
    ``tname`` pin a single "steps" thread inside it."""
    records = []
    for dev, dur in sorted(durations.items()):
        rec: Dict[str, Any] = {
            "group": "span",
            "name": name,
            "ts_us": start_s * 1e6,
            "dur_us": max(0.0, float(dur)) * 1e6,
            "tid": 1,
            "tname": "steps",
            "device": dev,
            "process": f"device:{dev}",
            "args": {"device": dev, "step_index": step_index},
        }
        if wall_epoch is not None:
            rec["wall_epoch"] = float(wall_epoch)
        records.append(rec)
    return records


class MeshStragglerDetector:
    """Cross-device slowest-vs-median straggler detection per dispatch.

    ``observe`` takes one dispatch window's per-device durations. The
    baseline is the *median device* of the same window — cross-sectional,
    not temporal — so a step that is slow for everyone (data stall,
    checkpoint pause) flags nobody, while one device exceeding
    ``median + threshold * max(1.4826 * MAD, rel_floor * median)`` flags
    exactly that device (only the slowest; its followers are waiting on
    the same collective, not independently slow). Flagged events
    increment ``mesh_straggler_events_total{device=...}`` and land in a
    bounded event ring for the flight recorder / cluster summary.
    """

    def __init__(self, registry: Optional[Any] = None, *,
                 tracer: Optional[Any] = None,
                 threshold: float = 4.0, rel_floor: float = 0.25,
                 min_devices: int = 2, max_events: int = 256) -> None:
        self._registry = registry
        self._tracer = tracer
        self.threshold = float(threshold)
        self.rel_floor = float(rel_floor)
        self.min_devices = int(min_devices)
        self.events: Deque[Dict[str, Any]] = collections.deque(
            maxlen=int(max_events))
        self.windows = 0
        self.stragglers = 0
        self.by_device: Dict[str, int] = {}

    def observe(self, durations: Dict[str, float]) -> Optional[str]:
        """Feed one dispatch window; returns the flagged device or None."""
        self.windows += 1
        if len(durations) < self.min_devices:
            return None
        values = [float(v) for v in durations.values()]
        med = statistics.median(values)
        mad = statistics.median(abs(v - med) for v in values)
        sigma = max(MAD_SIGMA_SCALE * mad, self.rel_floor * med)
        limit = med + self.threshold * sigma
        slowest_dev = max(durations, key=lambda d: durations[d])
        slowest = float(durations[slowest_dev])
        if self._registry is not None:
            for dev, dur in durations.items():
                self._registry.gauge(
                    "mesh_device_step_seconds",
                    "per-device completion time of the last dispatch",
                    labels={"device": dev}).set(float(dur))
        if slowest <= limit:
            return None
        self.stragglers += 1
        self.by_device[slowest_dev] = self.by_device.get(slowest_dev, 0) + 1
        if self._registry is not None:
            self._registry.counter(
                "mesh_straggler_events_total",
                "dispatch windows where one device straggled past the "
                "cross-device median/MAD limit",
                labels={"device": slowest_dev}).inc()
        event = {
            "device": slowest_dev,
            "duration_s": round(slowest, 6),
            "median_s": round(med, 6),
            "mad_s": round(mad, 6),
            "limit_s": round(limit, 6),
            "window_index": self.windows,
        }
        self.events.append(event)
        if self._tracer is not None:
            self._tracer.instant("mesh_straggler", **event)
        return slowest_dev

    def summary(self) -> Dict[str, Any]:
        return {
            "windows": self.windows,
            "stragglers": self.stragglers,
            "by_device": dict(sorted(self.by_device.items())),
            "recent_events": list(self.events)[-8:],
        }


def validate_multichip(obj: Any) -> List[str]:
    """Structural check of a MULTICHIP artifact / bench multichip run
    (schema_version 1). Returns problems; empty when valid."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        return ["multichip artifact must be a JSON object"]
    ver = obj.get("schema_version")
    if ver != MULTICHIP_SCHEMA_VERSION:
        errors.append(f"schema_version must be {MULTICHIP_SCHEMA_VERSION}, "
                      f"got {ver!r}")
    n = obj.get("n_devices")
    if not isinstance(n, int) or n < 1:
        errors.append(f"n_devices must be a positive int, got {n!r}")
    meshes = obj.get("meshes")
    if not isinstance(meshes, dict) or not meshes:
        errors.append("meshes must be a non-empty object keyed by axis")
        meshes = {}
    for axis, run in meshes.items():
        where = f"meshes[{axis!r}]"
        if not isinstance(run, dict):
            errors.append(f"{where}: not an object")
            continue
        shape = run.get("mesh_shape")
        if not isinstance(shape, dict) or not all(
                isinstance(v, int) for v in shape.values()):
            errors.append(f"{where}: mesh_shape must map axes to int sizes")
        for key in ("scaling_efficiency", "throughput_samples_per_sec",
                    "mfu_measured", "mfu_analytic"):
            v = run.get(key)
            if v is not None and not isinstance(v, (int, float)):
                errors.append(f"{where}: {key} must be numeric or null")
        coll = run.get("collectives")
        if coll is not None and not isinstance(coll, dict):
            errors.append(f"{where}: collectives must be an object")
    peaks = obj.get("per_device_peak_bytes")
    if peaks is not None:
        if not isinstance(peaks, dict) or not all(
                isinstance(v, (int, float)) for v in peaks.values()):
            errors.append(
                "per_device_peak_bytes must map device -> bytes")
    return errors


def format_multichip(artifact: Dict[str, Any]) -> str:
    """Human rendering of one MULTICHIP artifact."""
    lines: List[str] = []
    n = artifact.get("n_devices")
    lines.append(f"multichip scaling: {n} x {artifact.get('platform', '?')} "
                 f"devices (schema v{artifact.get('schema_version')})")
    base = artifact.get("baseline") or {}
    thr1 = base.get("throughput_samples_per_sec")
    if isinstance(thr1, (int, float)):
        lines.append(f"  baseline (1 device): {thr1:.2f} samples/s, "
                     f"mfu {_pct(base.get('mfu_measured'))} measured / "
                     f"{_pct(base.get('mfu_analytic'))} analytic")
    for axis, run in sorted((artifact.get("meshes") or {}).items()):
        if not isinstance(run, dict):
            continue
        eff = run.get("scaling_efficiency")
        eff_s = f"{eff:.1%}" if isinstance(eff, (int, float)) else "n/a"
        thr = run.get("throughput_samples_per_sec")
        thr_s = f"{thr:.2f}" if isinstance(thr, (int, float)) else "n/a"
        lines.append(
            f"  {axis}: shape {run.get('mesh_shape')}, efficiency {eff_s}, "
            f"{thr_s} samples/s, mfu {_pct(run.get('mfu_measured'))} "
            f"measured / {_pct(run.get('mfu_analytic'))} analytic")
        coll = run.get("collectives") or {}
        ops = coll.get("ops") or {}
        if ops:
            parts = []
            for kind, axes in sorted(ops.items()):
                for ax, stats in sorted(axes.items()):
                    parts.append(f"{kind}[{ax}]={stats.get('count')}")
            lines.append(f"      collectives: {' '.join(parts)} "
                         f"(fingerprint {coll.get('fingerprint', '?')[:12]})")
        frac = run.get("comm_compute_fraction")
        if isinstance(frac, (int, float)):
            lines.append(f"      comm/compute fraction: {frac:.1%}")
        strag = run.get("straggler") or {}
        if strag.get("stragglers"):
            lines.append(f"      stragglers: {strag['stragglers']} over "
                         f"{strag.get('windows')} windows "
                         f"{strag.get('by_device')}")
    peaks = artifact.get("per_device_peak_bytes") or {}
    if peaks:
        worst = max(peaks, key=lambda d: peaks[d])
        lines.append(f"  per-device peak bytes: {len(peaks)} devices, "
                     f"max {peaks[worst]:.0f} on {worst}")
    return "\n".join(lines)


def _pct(v: Any) -> str:
    return f"{v:.2%}" if isinstance(v, (int, float)) else "n/a"


__all__ = [
    "MULTICHIP_SCHEMA_VERSION",
    "MeshStragglerDetector",
    "device_lane_records",
    "format_multichip",
    "rank_step_seconds",
    "RankStepTimer",
    "validate_multichip",
]
