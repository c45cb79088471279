"""Timing on the card, shared by ``chip_smoke.py`` and the kernel tools.

Two clocks, because they answer different questions: :func:`device_ms`
is the device's time per call (calls captured in a CUDA graph and
replayed, so no host time falls between launches), :func:`call_ms` the
time per call issued back to back from the host, which is the host's
time wherever the host is slower than the kernel.
"""
from __future__ import annotations

import time


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms per call of ``fn`` issued back to back from the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """ms of device time per call of ``fn``: ``iters`` calls captured in a
    CUDA graph, the graph replayed ``replays`` times between two events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capturing stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def warm_clocks(seconds: float = 2.0) -> None:
    """Keep the card busy for ``seconds`` so that the first timed call does
    not run at idle clocks."""
    import torch

    x = torch.randn(4096, 4096, device="cuda")
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        x @ x
    torch.cuda.synchronize()
