"""Collective accounting of a meshed step — the port of
``determined_clone_tpu/telemetry/collectives.py``.

The JAX module parses the compiled, post-SPMD HLO text, where the
partitioner inserted the collectives. The port places its collectives by
hand (``parallel/spmd.py``), so there is no HLO to parse: the text
parser (``parse_hlo_collectives``, ``parse_replica_groups`` and the
iota-group and permute-pair parsers) has nothing to read here and is not
ported. What stands in is a **recorder** at the port's own choke points
— ``spmd._all_gather``, ``spmd._all_reduce`` and ``spmd._p2p`` (the
group-opening all-reduce included), Ulysses' ``all_to_all_single``
(``ops/attention.py``) and the global gradient norm's all-reduce
(``training/optim.py``). While :func:`recording` is open, each of them
calls :func:`note` with its kind (``all-reduce``, ``all-gather``,
``all-to-all``, ``collective-permute``), its process group and its
payload, and the group is named by the mesh axes it spans: ``dp``, or
``dp+fsdp`` for a group of both, as JAX labels a grouped reduce.

Bytes follow the JAX rule: a collective is sized by its *result*, the
per-participant payload — for an all-gather the gathered tensor, for an
all-reduce the reduced one (the port reduces in fp32), for a
point-to-point transfer the tensors moved. So one layout gives one comm
fraction in either package. The trainer records only the first call of
a step program (``telemetry/compile.py``), as JAX reads one compiled
program; later steps pay one ``None`` check per collective.

:class:`CollectiveSummary`, :func:`comm_compute_fraction` and
:func:`export_collectives` are the JAX package's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import threading
from typing import Any, Dict, Iterator, Mapping, Optional

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")


def mesh_axis_sizes(mesh: Any) -> Dict[str, int]:
    """``{axis: size}`` of a DeviceMesh (or pass a mapping through)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {str(a): int(mesh.size(i))
            for i, a in enumerate(mesh.mesh_dim_names)}


@dataclasses.dataclass
class CollectiveSummary:
    """Counts and byte volumes of a step program's collectives, keyed
    ``{kind: {axis: {"count": n, "bytes": b}}}``."""

    ops: Dict[str, Dict[str, Dict[str, float]]] = dataclasses.field(
        default_factory=dict)
    n_partitions: int = 1

    def add(self, kind: str, axis: str, op_bytes: float) -> None:
        slot = self.ops.setdefault(kind, {}).setdefault(
            axis, {"count": 0, "bytes": 0.0})
        slot["count"] += 1
        slot["bytes"] += float(op_bytes)

    @property
    def total_ops(self) -> int:
        return int(sum(s["count"] for by_axis in self.ops.values()
                       for s in by_axis.values()))

    @property
    def total_bytes(self) -> float:
        return float(sum(s["bytes"] for by_axis in self.ops.values()
                         for s in by_axis.values()))

    def count(self, kind: str, axis: Optional[str] = None) -> int:
        by_axis = self.ops.get(kind, {})
        if axis is not None:
            return int(by_axis.get(axis, {}).get("count", 0))
        return int(sum(s["count"] for s in by_axis.values()))

    def bytes(self, kind: str, axis: Optional[str] = None) -> float:
        by_axis = self.ops.get(kind, {})
        if axis is not None:
            return float(by_axis.get(axis, {}).get("bytes", 0.0))
        return float(sum(s["bytes"] for s in by_axis.values()))

    def fingerprint(self) -> str:
        """sha256 over the sorted (kind, axis, count, bytes) structure —
        stable across runs with the same communication pattern."""
        rows = sorted(
            (kind, axis, int(s["count"]), int(s["bytes"]))
            for kind, by_axis in self.ops.items()
            for axis, s in by_axis.items())
        blob = json.dumps(rows, separators=(",", ":"))
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()

    def as_dict(self) -> Dict[str, Any]:
        return {
            "n_partitions": self.n_partitions,
            "total_ops": self.total_ops,
            "total_bytes": self.total_bytes,
            "fingerprint": self.fingerprint()[:16],
            "ops": {k: {a: dict(s) for a, s in by_axis.items()}
                    for k, by_axis in self.ops.items()},
        }


class _Recorder:
    """The summary being recorded and the axis label of each process
    group of the mesh: an axis's own group by its name, the world by its
    axes of size > 1 joined with ``+`` (in the mesh's order)."""

    def __init__(self, mesh: Any) -> None:
        sizes = mesh_axis_sizes(mesh)
        n = 1
        for s in sizes.values():
            n *= max(1, s)
        self.summary = CollectiveSummary(n_partitions=n)
        self.lock = threading.Lock()
        self._labels: Dict[Any, str] = {}
        self._groups = []   # referenced, so that no id is reused
        for axis, size in sizes.items():
            if size > 1:
                group = mesh.get_group(axis)
                self._groups.append(group)
                self._labels[_key(group)] = axis
        self.world = "+".join(a for a, s in sizes.items() if s > 1) or \
            "other"

    def label(self, group: Any) -> str:
        found = self._labels.get(_key(group))
        if found is not None:
            return found
        import torch.distributed as dist

        if group is None or group is dist.group.WORLD:
            return self.world
        return "other"


def _key(group: Any) -> Any:
    """A process group's name (one group object or another of the same
    group), else the object's identity."""
    return getattr(group, "group_name", None) or id(group)


_ACTIVE: Optional[_Recorder] = None


def note(kind: str, group: Any, nbytes: float) -> None:
    """One collective of ``kind`` on ``group`` (None: the world) whose
    result is ``nbytes`` per participant, recorded while
    :func:`recording` is open; otherwise nothing."""
    rec = _ACTIVE
    if rec is not None:
        label = rec.label(group)
        with rec.lock:
            rec.summary.add(kind, label, nbytes)


@contextlib.contextmanager
def recording(mesh: Any) -> Iterator[CollectiveSummary]:
    """Record every :func:`note` until the block exits, into the
    summary it yields; ``mesh`` is the DeviceMesh whose groups name the
    axes. Global, not per thread: CUDA backward passes run on autograd's
    own threads."""
    global _ACTIVE
    rec = _Recorder(mesh)
    prev, _ACTIVE = _ACTIVE, rec
    try:
        yield rec.summary
    finally:
        _ACTIVE = prev


def comm_compute_fraction(
        summary: CollectiveSummary, flops: Optional[float], *,
        interconnect_bytes_per_s: float,
        peak_flops_per_s: float) -> Optional[float]:
    """Analytic comm-vs-compute fraction of one program execution:
    ``comm_s / (comm_s + compute_s)``. None when the program's FLOPs are
    unknown — a fraction with a made-up numerator would be worse than
    no fraction."""
    if flops is None or flops <= 0:
        return None
    if interconnect_bytes_per_s <= 0 or peak_flops_per_s <= 0:
        return None
    comm_s = summary.total_bytes / interconnect_bytes_per_s
    compute_s = flops / peak_flops_per_s
    if comm_s + compute_s <= 0:
        return 0.0
    return comm_s / (comm_s + compute_s)


def export_collectives(summary: CollectiveSummary, registry: Any, *,
                       program: str, fingerprint: str = "",
                       comm_fraction: Optional[float] = None) -> None:
    """Land a summary in the metric registry under the JAX package's
    names: one labelled gauge child per (kind, axis) — gauges, because
    they describe the step program's structure (latest capture wins),
    not an accumulating event stream."""
    if registry is None:
        return
    for kind, by_axis in summary.ops.items():
        for axis, s in by_axis.items():
            labels = {"kind": kind, "axis": axis, "program": program}
            registry.gauge(
                "xla_collective_ops_total",
                "collective ops in the compiled program, by kind and "
                "mesh axis", labels=labels).set(s["count"])
            registry.gauge(
                "xla_collective_bytes",
                "per-shard payload bytes of the compiled program's "
                "collectives, by kind and mesh axis",
                labels=labels).set(s["bytes"])
    if comm_fraction is not None:
        registry.gauge(
            "xla_comm_compute_fraction",
            "analytic comm/(comm+compute) time fraction per program",
            labels={"program": program,
                    "fingerprint": (fingerprint or "")[:16]},
        ).set(comm_fraction)


__all__ = [
    "COLLECTIVE_KINDS",
    "CollectiveSummary",
    "comm_compute_fraction",
    "export_collectives",
    "mesh_axis_sizes",
    "note",
    "recording",
]
