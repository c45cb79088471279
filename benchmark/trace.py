"""The profiled sub-window of a ``--trace 1`` run and its reduction.

``Profiled`` starts ``torch.profiler`` at one host sync and stops it at
another; ``Summary`` keeps, from the profiler's raw events, every device
operation (kernels, copies, sets) with its interval and correlation id,
the host's operator ranges and the runtime's launch calls. From those it
gives the device's busy time (the union of the device intervals), the
operations that took most time, the longest idle gaps labelled by the
innermost host range that covers them, and the kernels launched from
inside a named host range (an autograd node, say).
"""
from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

_LAUNCH_WORDS = ("LaunchKernel", "cudaLaunch", "cuLaunch", "MemcpyAsync",
                 "MemsetAsync", "GraphLaunch")


class Summary:
    def __init__(self, events, window_s: float) -> None:
        from torch.autograd import DeviceType

        self.window_s = float(window_s)
        self.device: List[Tuple[str, int, int, int]] = []
        self.host: List[Tuple[str, int, int, int]] = []
        self.launch: List[Tuple[int, int, int]] = []   # (tid, start, corr)
        for e in events:
            start, dur = int(e.start_ns()), int(e.duration_ns())
            if e.device_type() == DeviceType.CUDA:
                self.device.append((e.name(), start, start + dur,
                                    int(e.correlation_id())))
                continue
            name = e.name()
            tid = int(e.start_thread_id())
            if any(w in name for w in _LAUNCH_WORDS):
                self.launch.append((tid, start, int(e.correlation_id())))
            else:
                self.host.append((name, start, start + dur, tid))
        self.launch.sort()
        self.device.sort(key=lambda d: d[1])
        self._union = self._merge([(s, e) for _, s, e, _ in self.device])

    @staticmethod
    def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
        out: List[List[int]] = []
        for s, e in sorted(iv):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._union) / 1e9

    def kernels(self, pred: Callable[[str], bool]
                ) -> List[Tuple[str, int, int, int]]:
        return [d for d in self.device if pred(d[0])]

    def launched_under(self, pred: Callable[[str], bool]
                       ) -> List[Tuple[str, int, int, int]]:
        """Device operations whose launch lies inside a host range whose
        name satisfies ``pred``, on the range's own thread."""
        corr = set()
        keys = [(t, s) for t, s, _ in self.launch]
        for name, s, e, tid in self.host:
            if not pred(name):
                continue
            i = bisect.bisect_left(keys, (tid, s))
            while i < len(keys) and keys[i][0] == tid and keys[i][1] <= e:
                corr.add(self.launch[i][2])
                i += 1
        return [d for d in self.device if d[3] in corr]

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for name, s, e, _ in self.device:
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, t0: int, t1: int, n: int = 10) -> List[List]:
        """The ``n`` longest stretches of ``[t0, t1]`` with nothing on the
        device, each named by the innermost host range over its middle."""
        gaps: List[Tuple[int, int]] = []
        prev = t0
        for s, e in self._union:
            if s > prev:
                gaps.append((prev, min(s, t1)))
            prev = max(prev, e)
        if t1 > prev:
            gaps.append((prev, t1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) // 2
            inner = [(he - hs, name) for name, hs, he, _ in self.host
                     if hs <= mid <= he]
            label = min(inner)[1] if inner else "host: outside any range"
            out.append([label[:160], (e - s) / 1e9])
        return out


class Profiled:
    """``start()`` at one host sync, ``stop()`` at a later one. ``warm()``,
    in set-up, starts and stops the profiler once around a small copy, so
    that the tracer's own start-up (CUPTI's) is not paid inside the
    profiled window."""

    def __init__(self) -> None:
        self._prof = None
        self._t0 = 0.0
        self.summary: Optional[Summary] = None
        self.breakdown: Optional[Dict] = None

    def warm(self) -> None:
        self.start()
        if torch.cuda.is_available():
            torch.ones(1, device="cuda").add_(1)
        self.stop()
        self.summary = self.breakdown = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        self.summary = Summary(events, window_s)
        self._prof = None
        s = self.summary
        if s.device:
            t0 = min(d[1] for d in s.device)
            t0 = min([t0] + [h[1] for h in s.host])
            t1 = t0 + int(window_s * 1e9)
            self.breakdown = {"device_ops": s.top_ops(),
                              "idle_gaps": s.idle_gaps(t0, t1)}
