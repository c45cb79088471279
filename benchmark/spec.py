"""Finding a cell's pieces by the names in ``BENCHMARK.json``.

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``benchmark/traffic/<traffic>.json``, whose
  ``generator`` and ``driver`` name the code that reads it;
- a per-layer metric: ``benchmark/metrics/<metric>.py``, a reader with
  ``read(run) -> float | None``;
- a cell's limits: ``benchmark/limits/<workload>.json``.

Adding any of them is adding files and entries; nothing here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent


def load_bench(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: Dict, workload: str) -> Dict:
    return _named(bench["workloads"], workload, "workload")


def config(bench: Dict, name: str, root: Path = ROOT) -> Dict:
    with open(root / _named(bench["configs"], name, "config")["file"]) as f:
        return json.load(f)


def mix(traffic: str, root: Path = ROOT) -> Dict:
    with open(root / "benchmark" / "traffic" / f"{traffic}.json") as f:
        return json.load(f)


def limits(workload: str, root: Path = ROOT) -> Dict[str, float]:
    with open(root / "benchmark" / "limits" / f"{workload}.json") as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(bench: Dict, workload: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if applies(m, workload)]


def per_layer(bench: Dict, workload: str) -> List[Dict]:
    return [m for m in bench["per_layer"] if applies(m, workload)]


def reader(metric: str, root: Path = ROOT
           ) -> Callable[[Any], Optional[float]]:
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")
