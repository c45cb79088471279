"""Run one cell of the port's benchmark once and print one result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's configuration, traffic mix,
metrics and limits are found by name (``benchmark/spec.py``); the mix
names the driver, which runs the port's entry point, opens the measured
window once set-up is done and closes it after ``--seconds``, then
checks what the timed path produced against the plain reference. With
``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read after a profiled sub-window.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its
limit (also the last lines of standard error). A run exits non-zero and
prints no result when there is no CUDA card or fewer than the cell asks
for, or when JAX or the JAX package is loaded once the window has closed.
A run still going after ``WATCHDOG_S`` seconds prints every thread's
stack to standard error and exits 1.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import torch  # noqa: E402

from benchmark import spec  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "determined_clone_tpu")
WATCHDOG_S = 345


class Run:
    """What a driver and the metric readers see of one run."""

    def __init__(self, *, root: Path, bench: Dict, workload: str, seed: int,
                 seconds: float, trace: bool, device: torch.device,
                 t0: float = T0) -> None:
        self.root = root
        self.bench = bench
        self.workload = workload
        self.cell = spec.cell(bench, workload)
        self.cfg = spec.config(bench, self.cell["config"], root)
        self.mix = spec.mix(self.cell["traffic"], root)
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.chips = int(self.cell["chips"])
        self.kind = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
        self.t0 = t0
        self.setup_s: Optional[float] = None
        self.result: Dict[str, Any] = {}

    def mark_setup_done(self, t: float) -> None:
        self.setup_s = t - self.t0

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    @property
    def stats(self) -> Dict[str, Any]:
        return self.result.get("stats", {})

    @property
    def summary(self):
        prof = self.result.get("profiled")
        return prof.summary if prof is not None else None


def loaded_banned() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _num(v: float) -> Optional[float]:
    return float(v) if v is not None and math.isfinite(v) else None


def execute(run: Run) -> Dict[str, Any]:
    """Drive the cell and assemble its result line (a dict)."""
    driver = spec.driver(run.mix["driver"])
    res = run.result = driver.run(run)
    limits = spec.limits(run.workload, run.root)
    checks = {}
    for name, limit in limits.items():
        value = res["checks"][name]
        checks[name] = {"value": _num(value), "limit": limit}
    correct = (res["attempted"] > 0 and res["failed"] == 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    metrics: Dict[str, Dict] = {}
    if not run.trace:
        values = dict(res["e2e"], setup_s=run.setup_s)
        for m in spec.end_to_end(run.bench, run.workload):
            metrics[m["name"]] = {"value": _num(values[m["name"]]),
                                  "unit": m["unit"]}
    else:
        for m in spec.per_layer(run.bench, run.workload):
            value = spec.reader(m["name"], run.root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": _num(value), "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": run.kind, "count": run.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line: Dict[str, Any] = {"correct": bool(correct),
                            "attempted": int(res["attempted"]),
                            "failed": int(res["failed"]),
                            "metrics": metrics, "device": device}
    if run.trace and run.summary is not None:
        device["busy_s"] = run.summary.busy_s
        device["window_s"] = run.summary.window_s
        if res["profiled"].breakdown is not None:
            line["breakdown"] = res["profiled"].breakdown
    line["checks"] = checks
    return line


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.load_bench()
    chips = int(spec.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(WATCHDOG_S - (time.perf_counter() - T0),
                                      exit=True)
    run = Run(root=spec.ROOT, bench=bench, workload=args.workload,
              seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=torch.device("cuda", 0))
    line = execute(run)
    faulthandler.cancel_dump_traceback_later()
    found = loaded_banned()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    stats = {k: v for k, v in run.stats.items() if not isinstance(v, list)}
    print(f"card: {_power_limit()}; stats: {json.dumps(stats)}",
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
