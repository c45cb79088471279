"""Metric accumulation without host syncs — the port of
``determined_clone_tpu/training/metrics.py``.

Metrics stay on the device as running sums; they cross to the host only
at a reporting boundary, all in one transfer.
"""
from __future__ import annotations

from typing import Dict, List

import torch


class MetricAccumulator:
    """Running mean of per-batch scalar metrics, device-side."""

    def __init__(self) -> None:
        self._sums: Dict[str, torch.Tensor] = {}
        self._counts: Dict[str, int] = {}

    def add(self, metrics: Dict[str, torch.Tensor], count: int = 1) -> None:
        """Accumulate per-batch scalar tensors (all on one device).
        ``count`` is how many batches the values already sum over — a
        fused k-step dispatch hands in summed metrics with ``count=k``, so
        the reported mean stays a true per-batch mean."""
        for k, v in metrics.items():
            if k in self._sums:
                self._sums[k] = self._sums[k] + v
                self._counts[k] += count
            else:
                self._sums[k] = v
                self._counts[k] = count

    def result(self) -> Dict[str, float]:
        """Host sync point: returns the means and resets. The sums cross
        to the host in ONE transfer (stacked, then ``.cpu()``), not one
        per metric."""
        names = list(self._sums)
        out: Dict[str, float] = {}
        if names:
            host = torch.stack([self._sums[k].detach().double()
                                for k in names]).cpu().tolist()
            out = {k: s / self._counts[k] for k, s in zip(names, host)}
        self._sums.clear()
        self._counts.clear()
        return out

    def __len__(self) -> int:
        return len(self._sums)


def mean_over_batches(per_batch: List[Dict[str, torch.Tensor]]
                      ) -> Dict[str, float]:
    acc = MetricAccumulator()
    for m in per_batch:
        acc.add(m)
    return acc.result()
