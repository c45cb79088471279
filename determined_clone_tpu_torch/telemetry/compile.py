"""Compile capture, measured MFU and step-time anomalies — the port of the
framework-free half of ``determined_clone_tpu/telemetry/xla.py``.

The JAX module opens the compiled XLA program: ``aot_compile`` replaces
a jitted step's implicit first-call compile with an explicit
``lower()``/``compile()``, fingerprints the lowered StableHLO and reads
``cost_analysis()`` and ``memory_analysis()``; ``AotDispatcher`` keys
executables by shape for the persistent executable cache. An eager
PyTorch step has no lowered program, no executable and no cost model,
so ``aot_compile``, ``AotDispatcher`` and ``fingerprint_stablehlo`` have
nothing to read here and are not ported. What stands in:

- **the compile** is a step program's first call: the lazy ``nvcc``
  build of ``ops/_build.py``, cuBLAS and cuDNN handle setup, and the
  caching allocator's growth all land there. :func:`capture_compile`
  wraps a step so that its first call is measured, to the device's
  completion, into a :class:`CompileRecord`; later calls go straight
  through;
- **the fingerprint** is a sha256 over the step's identity — the
  program name, what the caller passes as ``identity`` (the model's
  configuration, the dtypes) and the kernel sources ``ops/_build.py``
  has compiled by the end of that first call;
- **the FLOPs** are one step's, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` around that first call
  (forward, remat recompute and backward), the stand-in for
  ``cost_analysis()``. A kernel launched through ctypes is invisible to
  the mode, so its wrapper adds its own count with :func:`add_flops`
  (the flash forward: its causal products, per launch);
- **the collectives** of a meshed step are recorded by
  ``telemetry/collectives.py`` during the same first call.

:class:`MfuComparator` and :class:`StepTimeAnomalyDetector` are the JAX
package's, unchanged.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import logging
import statistics
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional

logger = logging.getLogger(__name__)

# Measured-vs-analytic MFU divergence: warn past this ratio, at most once
# per WARN_PERIOD (per comparator) so a long run can't spam the log.
MFU_DIVERGENCE_RATIO = 1.2
MFU_WARN_PERIOD_SEC = 300.0

# 1.4826 * MAD estimates the standard deviation for normal data; the
# detector's threshold is expressed in these robust sigmas.
MAD_SIGMA_SCALE = 1.4826


@dataclasses.dataclass
class CompileRecord:
    """What one step program's first call observed. The fields are the
    JAX record's; ``lower_seconds`` is 0.0 (nothing is lowered),
    ``compile_seconds`` the whole first call, ``flops`` the FLOP
    counter's, and the fields the port cannot measure (bytes accessed,
    the executable's memory analysis, the executable cache) stay None or
    False."""

    program: str
    fingerprint: str          # sha256 hex of the step's identity
    lower_seconds: float
    compile_seconds: float
    flops: Optional[float] = None
    bytes_accessed: Optional[float] = None
    argument_bytes: Optional[float] = None
    output_bytes: Optional[float] = None
    temp_bytes: Optional[float] = None
    # telemetry/collectives.py's summary of the first call; None off a mesh
    collectives: Optional[Any] = None
    comm_fraction: Optional[float] = None
    cache_hit: bool = False
    cache_load_seconds: Optional[float] = None
    compile_time_saved_s: Optional[float] = None

    def as_dict(self) -> Dict[str, Any]:
        out = {k: v for k, v in dataclasses.asdict(self).items()
               if v is not None and k != "collectives"}
        if self.collectives is not None:
            out["collectives"] = self.collectives.as_dict()
        return out


# -- FLOPs of kernels the FLOP counter cannot see ----------------------------

_FLOPS_LOCK = threading.Lock()
_EXTRA_FLOPS: Optional[List[float]] = None   # set while a capture counts


def add_flops(n: float) -> None:
    """Add ``n`` FLOPs to the capture in progress, if any: for kernels
    called outside ATen (ctypes), which the FLOP counter cannot see.
    Global, not per thread: CUDA backward passes run on autograd's own
    threads."""
    if _EXTRA_FLOPS is not None:
        with _FLOPS_LOCK:
            if _EXTRA_FLOPS is not None:
                _EXTRA_FLOPS[0] += float(n)


def fingerprint_step(program: str, identity: Any) -> str:
    """sha256 over the step's identity: ``program``, ``identity`` as
    sorted JSON (``str`` for what JSON cannot hold) and the source of
    every kernel ``ops/_build.py`` has compiled in this process."""
    from determined_clone_tpu_torch.ops import _build

    h = hashlib.sha256()
    h.update(json.dumps({"program": program, "identity": identity},
                        sort_keys=True, default=str).encode("utf-8"))
    for name in _build.built():
        h.update(name.encode("utf-8"))
        h.update((_build.CSRC / _build.KERNELS[name][0]).read_bytes())
    return h.hexdigest()


class FirstCallCapture:
    """A step whose first call is its compile, captured (see the module
    docstring); ``record`` is None until that call has returned."""

    def __init__(self, fn: Callable[..., Any], *, program: str,
                 identity: Any, registry: Optional[Any],
                 mesh: Optional[Any], platform: str) -> None:
        self._fn = fn
        self.program = program
        self._identity = identity
        self._registry = registry
        self._mesh = mesh
        self._platform = platform
        self.record: Optional[CompileRecord] = None
        self.__name__ = f"capture_{program}"

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        if self.record is not None:
            return self._fn(*args, **kwargs)
        return self._capture(args, kwargs)

    def _capture(self, args: tuple, kwargs: dict) -> Any:
        global _EXTRA_FLOPS
        import contextlib

        from torch.utils.flop_counter import FlopCounterMode

        from determined_clone_tpu_torch.telemetry import collectives
        from determined_clone_tpu_torch.telemetry.device import (
            block_until_ready,
        )

        extra = [0.0]
        recording = (collectives.recording(self._mesh)
                     if self._mesh is not None else contextlib.nullcontext())
        t0 = time.perf_counter()
        with _FLOPS_LOCK:
            _EXTRA_FLOPS = extra
        try:
            with FlopCounterMode(display=False) as counter, \
                    recording as summary:
                out = self._fn(*args, **kwargs)
                block_until_ready(out)
        finally:
            with _FLOPS_LOCK:
                _EXTRA_FLOPS = None
        dt = time.perf_counter() - t0
        record = CompileRecord(
            program=self.program,
            fingerprint=fingerprint_step(self.program, self._identity),
            lower_seconds=0.0, compile_seconds=dt,
            flops=float(counter.get_total_flops()) + extra[0],
            collectives=summary)
        if summary is not None:
            from determined_clone_tpu_torch.telemetry import flops as fl

            bw, _ = fl.interconnect_bandwidth_estimate(self._platform)
            peak, _ = fl.peak_flops_estimate(self._platform)
            # both sides per rank: the FLOP counter sees this rank's
            # program and the recorder this rank's payloads
            record.comm_fraction = collectives.comm_compute_fraction(
                summary, record.flops, interconnect_bytes_per_s=bw,
                peak_flops_per_s=peak)
            if self._registry is not None:
                collectives.export_collectives(
                    summary, self._registry, program=self.program,
                    fingerprint=record.fingerprint[:16],
                    comm_fraction=record.comm_fraction)
        export_compile_record(record, registry=self._registry)
        self.record = record
        return out


def capture_compile(fn: Callable[..., Any], *, program: str = "train_step",
                    identity: Any = None, registry: Optional[Any] = None,
                    mesh: Optional[Any] = None,
                    platform: str = "cpu") -> FirstCallCapture:
    """Wrap ``fn`` so that its first call is captured into a
    :class:`CompileRecord` (``.record`` afterwards), its gauges landed in
    ``registry``. The capture waits for the call's output on the device
    (``telemetry.device.block_until_ready``), so the record's seconds
    cover the device work. With ``mesh`` (a DeviceMesh) the
    collectives of that call are recorded, exported as
    ``xla_collective_*`` gauges and turned into a comm/compute fraction
    against ``platform``'s interconnect and peak (``gpu`` or ``cpu``)."""
    return FirstCallCapture(fn, program=program, identity=identity,
                            registry=registry, mesh=mesh, platform=platform)


def export_compile_record(record: CompileRecord, *,
                          registry: Optional[Any] = None,
                          tracer: Optional[Any] = None,
                          start: Optional[float] = None) -> None:
    """Land one compile capture in the metric registry, keyed by
    ``{program, fingerprint}`` labels as in the JAX package.

    A capture made by :func:`capture_compile` is a dispatch's first call,
    which ``Telemetry.wrap_jit`` counts in ``xla_compiles_total`` and
    spans as ``xla_compile``; so only the gauges land here. With
    ``tracer`` — a capture made outside any dispatch, as the JAX
    package's AOT compile is — the compile is also counted and recorded
    as an ``explicit`` ``xla_compile`` span, which the goodput ledger
    books as compile time."""
    if registry is not None:
        labels = {"program": record.program,
                  "fingerprint": record.fingerprint[:16]}
        if tracer is not None:
            registry.counter(
                "xla_compiles_total",
                "jitted-program compilations observed (first calls + "
                "retraces)").inc()
        registry.gauge(
            "xla_compile_seconds",
            "explicit lower+compile wall time per program",
            labels=labels).set(record.lower_seconds + record.compile_seconds)
        if record.flops is not None:
            registry.gauge(
                "xla_program_flops",
                "per-execution FLOPs from compiled.cost_analysis()",
                labels=labels).set(record.flops)
        if record.bytes_accessed is not None:
            registry.gauge(
                "xla_program_bytes_accessed",
                "per-execution bytes accessed from cost_analysis()",
                labels=labels).set(record.bytes_accessed)
        if record.temp_bytes is not None:
            registry.gauge(
                "xla_program_temp_bytes",
                "executable scratch memory from memory_analysis()",
                labels=labels).set(record.temp_bytes)
    if tracer is not None:
        tracer.record_span(
            "xla_compile",
            start if start is not None else time.perf_counter(),
            record.lower_seconds + record.compile_seconds,
            program=record.program, fingerprint=record.fingerprint[:16],
            explicit=True, cache_hit=record.cache_hit)


class MfuComparator:
    """Measured MFU (the FLOP counter's count) next to the analytic gauge.

    The analytic number says what the *architecture* costs; the measured
    number what the *step program* ran. They legitimately differ
    (rematerialization recomputes the forward pass, the flash backward
    recomputes attention), so the warn threshold is 20%. The warning is
    rate-limited; gauges update every chunk regardless.
    """

    def __init__(self, registry: Any, *, peak_flops_total: float,
                 warn_period_s: float = MFU_WARN_PERIOD_SEC) -> None:
        self._registry = registry
        self._peak = float(peak_flops_total)
        self._warn_period = warn_period_s
        self._last_warn = -warn_period_s  # first divergence warns
        self._warned = 0

    def report(self, *, measured_flops_per_batch: float,
               batches_per_second: float,
               analytic_mfu: Optional[float] = None) -> float:
        """Update the measured gauges; compare against the analytic MFU.

        Returns the measured MFU. Call at the chunk boundary (never per
        step).
        """
        fps = measured_flops_per_batch * batches_per_second
        measured = fps / self._peak if self._peak > 0 else 0.0
        reg = self._registry
        reg.gauge("measured_flops_per_sec",
                  "throughput x per-program FLOPs from cost_analysis()"
                  ).set(fps)
        reg.gauge("mfu_measured",
                  "MFU from the compiled program's measured FLOPs "
                  "(vs the analytic `mfu` gauge)").set(measured)
        if analytic_mfu and measured > 0:
            ratio = max(measured / analytic_mfu, analytic_mfu / measured)
            if ratio > MFU_DIVERGENCE_RATIO:
                now = time.monotonic()
                if now - self._last_warn >= self._warn_period:
                    self._last_warn = now
                    self._warned += 1
                    logger.warning(
                        "measured MFU %.4f vs analytic MFU %.4f diverge "
                        "%.0f%% (>20%%): the analytic FLOPs formula and the "
                        "step program disagree — check flops.py against "
                        "the model", measured, analytic_mfu,
                        (ratio - 1.0) * 100.0)
                reg.counter(
                    "mfu_divergence_total",
                    "chunks where measured and analytic MFU diverged >20%"
                ).inc()
        return measured


class StepTimeAnomalyDetector:
    """Rolling median/MAD detector over dispatch durations.

    A step is anomalous when it exceeds
    ``median + threshold * max(1.4826 * MAD, rel_floor * median)`` —
    the floor keeps a near-constant baseline (MAD ≈ 0) from flagging
    scheduler jitter as stragglers. Only the slow side fires.

    The window holds *pre-anomaly* history: an anomalous duration is NOT
    fed back into the window, so one straggler can't raise the baseline
    and mask the next one. Warmup (``min_samples``) covers the first,
    cache-warming steps.
    """

    def __init__(self, registry: Optional[Any] = None, *,
                 tracer: Optional[Any] = None,
                 window: int = 64, threshold: float = 5.0,
                 min_samples: int = 16, rel_floor: float = 0.05,
                 max_events: int = 256) -> None:
        self._registry = registry
        self._tracer = tracer
        self.window: Deque[float] = collections.deque(maxlen=int(window))
        self.threshold = float(threshold)
        self.min_samples = int(min_samples)
        self.rel_floor = float(rel_floor)
        self.events: Deque[Dict[str, Any]] = collections.deque(
            maxlen=int(max_events))
        self.anomalies = 0
        self._seen = 0
        self._counter = (registry.counter(
            "step_time_anomalies_total",
            "train dispatches flagged by the rolling median/MAD detector")
            if registry is not None else None)

    def observe(self, duration_s: float) -> bool:
        """Feed one dispatch duration; True when flagged anomalous."""
        duration_s = float(duration_s)
        self._seen += 1
        if len(self.window) < self.min_samples:
            self.window.append(duration_s)
            return False
        med = statistics.median(self.window)
        mad = statistics.median(abs(x - med) for x in self.window)
        sigma = max(MAD_SIGMA_SCALE * mad, self.rel_floor * med)
        limit = med + self.threshold * sigma
        if duration_s <= limit:
            self.window.append(duration_s)
            return False
        self.anomalies += 1
        if self._counter is not None:
            self._counter.inc()
        event = {
            "duration_s": round(duration_s, 6),
            "median_s": round(med, 6),
            "mad_s": round(mad, 6),
            "limit_s": round(limit, 6),
            "step_index": self._seen,
        }
        self.events.append(event)
        if self._tracer is not None:
            self._tracer.instant("step_time_anomaly", **event)
        return True

    def summary(self) -> Dict[str, Any]:
        return {
            "anomalies": self.anomalies,
            "window_len": len(self.window),
            "recent_events": list(self.events)[-8:],
        }


__all__ = [
    "CompileRecord",
    "FirstCallCapture",
    "MfuComparator",
    "StepTimeAnomalyDetector",
    "add_flops",
    "capture_compile",
    "export_compile_record",
    "fingerprint_step",
]
