"""Measured multichip scaling — the port of
``determined_clone_tpu/parallel/scaling_bench.py``::

    python -m determined_clone_tpu_torch.parallel.scaling_bench \\
        --devices N [--device cpu] [--json]

For each parallelism axis (dp / fsdp / tp) it builds a mesh with every
rank on that axis, captures the train step's first call
(``telemetry/compile.py``: seconds, fingerprint, FLOPs counted by
``FlopCounterMode``, and the collectives ``telemetry/collectives.py``
records), times a few steps, and reports:

- **scaling efficiency** per axis: ``thr_N / (N * thr_1)`` against a
  one-rank baseline. dp/fsdp scale weakly (global batch = per-rank batch
  x N), tp strongly (fixed batch), so ideal scaling is 1.0 in both;
- **measured vs analytic MFU**: the counted FLOPs of each rank's
  program vs the ``flops.py`` formula, over the same measured step rate,
  against the card's peak (``peak_flops_provenance`` says which);
- **collective structure**: op and byte counts per (kind, axis), the
  structure fingerprint and the comm/compute fraction;
- **per-rank bytes** and a cross-rank straggler summary: each rank times
  its own steps (``telemetry/mesh.py``) and the durations are gathered
  once after the timed loop.

The JAX bench runs a process per mesh size on a simulated CPU mesh; the
port runs ranks through ``exec/launch.py`` — NCCL on cards, gloo with
``--device cpu``. The command above first runs the one-rank baseline,
then the N-rank run, whose rank 0 prints one MULTICHIP artifact
(``telemetry.mesh.validate_multichip`` is the contract).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

DEFAULT_AXES = ("dp", "fsdp", "tp")
PER_DEVICE_BATCH = 4
SEQ_LEN = 64


def _bench_config(gpt_mod: Any) -> Any:
    """Tiny-but-shardable GPT: n_heads/d_ff divisible by every axis size
    this lane runs (tp up to 16), big enough to emit real collectives.
    The JAX bench's widths; head dim 64/16 = 4 is outside the flash
    kernel's head dims, so attention is plain ``mha`` (as JAX's ``auto``
    is on its CPU mesh)."""
    return gpt_mod.GPTConfig(
        vocab_size=256, n_layers=2, d_model=64, n_heads=16, d_ff=256,
        max_seq_len=SEQ_LEN, remat=True, attention_impl="mha",
    )


def _platform(device: str) -> str:
    return "gpu" if device == "cuda" else "cpu"


def _measure_mesh(mesh: Any, batch_size: int, *, steps: int, warmup: int,
                  device: str, dist: Any,
                  registry: Optional[Any] = None) -> Dict[str, Any]:
    """Place, capture and time the train step on one mesh (every rank
    calls it). Returns throughput, per-step seconds, the captured
    program's fingerprint, collectives and comm fraction, measured and
    analytic MFU, per-rank bytes and the straggler summary."""
    import torch

    from determined_clone_tpu_torch.models import gpt
    from determined_clone_tpu_torch.parallel.sharding import (
        NamedSharding,
        to_dtensor,
    )
    from determined_clone_tpu_torch.parallel.spmd import local_tensor
    from determined_clone_tpu_torch.telemetry import flops as flops_mod
    from determined_clone_tpu_torch.telemetry.collectives import (
        mesh_axis_sizes,
    )
    from determined_clone_tpu_torch.telemetry.compile import capture_compile
    from determined_clone_tpu_torch.telemetry.device import (
        block_until_ready,
        live_buffer_bytes_by_device,
    )
    from determined_clone_tpu_torch.telemetry.mesh import (
        MeshStragglerDetector,
        RankStepTimer,
        rank_step_seconds,
    )
    from determined_clone_tpu_torch.training import optim
    from determined_clone_tpu_torch.training.train_step import (
        create_train_state,
        make_train_step,
        shard_state,
        state_shardings,
    )

    cfg = _bench_config(gpt)
    platform = _platform(device)
    params = gpt.init(torch.Generator(device=device).manual_seed(0), cfg,
                      device=device)
    tx = optim.adamw(1e-3, weight_decay=0.01)
    state = create_train_state(params, tx, 1)
    state = shard_state(state, state_shardings(state, mesh,
                                               gpt.GPT_SHARDING_RULES))
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, SEQ_LEN),
                           device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(2))
    tokens = to_dtensor(tokens, NamedSharding(mesh, gpt.TOKENS_SPEC))

    def loss_fn(p, batch, seed):
        return gpt.loss_fn(p, cfg, batch[:, :-1], batch[:, 1:]), {}

    sizes = mesh_axis_sizes(mesh)
    step = capture_compile(
        make_train_step(loss_fn, tx), program="scaling_bench",
        identity={"config": vars(cfg), "mesh": sizes, "batch": batch_size},
        registry=registry, mesh=mesh, platform=platform)

    # the first call is the capture (the compile); it counts as warmup
    for _ in range(max(1, warmup)):
        state, metrics = step(state, tokens)
        block_until_ready(metrics)
    record = step.record
    timer = RankStepTimer(device)
    t_start = time.perf_counter()
    step_seconds: List[float] = []
    for _ in range(max(1, steps)):
        t0 = time.perf_counter()
        timer.start()
        state, metrics = step(state, tokens)
        timer.stop()
        block_until_ready(metrics)
        step_seconds.append(time.perf_counter() - t0)
    elapsed = time.perf_counter() - t_start

    detector = MeshStragglerDetector(registry)
    for window in rank_step_seconds(dist, timer.take(), platform):
        detector.observe(window)

    n = dist.size
    sps = len(step_seconds) / elapsed if elapsed > 0 else 0.0
    peak, peak_label = flops_mod.peak_flops_estimate(platform)
    analytic = flops_mod.gpt_train_step_flops(cfg, batch_size, SEQ_LEN - 1)
    mfu_analytic = flops_mod.mfu(analytic.total * sps, peak, n)
    mfu_measured = None
    if record.flops:
        # the counted FLOPs are one rank's program: the whole step is n
        # of them, over n cards of peak
        mfu_measured = flops_mod.mfu(record.flops * n * sps, peak, n)
    # each rank's residency, gathered: on the card the allocator's live
    # bytes; on the CPU (no allocator statistics) the bytes of the rank's
    # blocks of the train state and the batch
    if device == "cuda":
        mine = sum(live_buffer_bytes_by_device().values())
    else:
        from determined_clone_tpu_torch.core._serialization import (
            tree_paths_and_leaves,
        )

        mine = sum(local_tensor(t).nbytes for _, t in
                   tree_paths_and_leaves((state, tokens))
                   if isinstance(t, torch.Tensor))
    live = {f"{platform}:{r}": float(b)
            for r, b in enumerate(dist.allgather(float(mine)))}
    out: Dict[str, Any] = {
        "mesh_shape": {k: v for k, v in sizes.items()},
        "per_device_live_bytes": dict(sorted(live.items())),
        "batch_size": int(batch_size),
        "steps_timed": len(step_seconds),
        "step_seconds_mean": elapsed / max(1, len(step_seconds)),
        "throughput_samples_per_sec": batch_size * sps,
        "mfu_analytic": mfu_analytic,
        "mfu_measured": mfu_measured,
        "peak_flops_provenance": peak_label,
        "straggler": detector.summary(),
        "program_fingerprint": record.fingerprint[:16],
        "compile_seconds": record.lower_seconds + record.compile_seconds,
        "collectives": record.collectives.as_dict(),
    }
    if record.comm_fraction is not None:
        out["comm_compute_fraction"] = record.comm_fraction
    return out


def run_scaling_bench(n_devices: int, *,
                      axes: Sequence[str] = DEFAULT_AXES,
                      steps: int = 3, warmup: int = 1,
                      registry: Optional[Any] = None,
                      baseline: Optional[Dict[str, Any]] = None,
                      device: str = "cuda",
                      dist: Optional[Any] = None) -> Dict[str, Any]:
    """Measure per-axis scaling in a world of ``n_devices`` ranks (every
    rank calls this; ``dist`` is the rank's ``DistributedContext``).
    ``baseline`` is the one-rank run's :func:`measure_baseline`; without
    one, a world of one rank measures it here. Returns one MULTICHIP
    schema_version-1 artifact."""
    from determined_clone_tpu_torch.core._distributed import (
        DistributedContext,
    )
    from determined_clone_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from determined_clone_tpu_torch.telemetry.mesh import (
        MULTICHIP_SCHEMA_VERSION,
    )

    dist = dist or DistributedContext.from_torch()
    if dist.size != n_devices:
        raise RuntimeError(f"need {n_devices} ranks, the world has "
                           f"{dist.size}; start them with exec/launch.py "
                           f"--nprocs {n_devices}")
    if baseline is None:
        baseline = measure_baseline(steps=steps, warmup=warmup,
                                    device=device, dist=dist)
    thr1 = baseline["throughput_samples_per_sec"]

    peaks: Dict[str, float] = {}
    meshes: Dict[str, Dict[str, Any]] = {}
    for axis in axes:
        # MeshSpec defaults dp to the -1 wildcard; pin it so the measured
        # axis is the only one absorbing the ranks
        mesh = make_mesh(MeshSpec.from_dict({"dp": 1, axis: n_devices}),
                         device_type=device)
        # dp/fsdp scale weakly (batch grows with the mesh); tp strongly
        batch = (PER_DEVICE_BATCH * n_devices if axis in ("dp", "fsdp")
                 else PER_DEVICE_BATCH)
        run = _measure_mesh(mesh, batch, steps=steps, warmup=warmup,
                            device=device, dist=dist, registry=registry)
        thr_n = run["throughput_samples_per_sec"]
        run["scaling_efficiency"] = (
            thr_n / (n_devices * thr1) if thr1 > 0 else None)
        meshes[axis] = run
        for dev, b in run.get("per_device_live_bytes", {}).items():
            peaks[dev] = max(peaks.get(dev, 0.0), b)

    out = {
        "schema_version": MULTICHIP_SCHEMA_VERSION,
        "n_devices": int(n_devices),
        "platform": _platform(device),
        "baseline": baseline,
        "meshes": meshes,
        "per_device_peak_bytes": dict(sorted(peaks.items())),
    }
    if device == "cuda":
        import torch

        out["device_name"] = torch.cuda.get_device_name()
    return out


def measure_baseline(*, steps: int = 3, warmup: int = 1,
                     device: str = "cuda",
                     dist: Optional[Any] = None) -> Dict[str, Any]:
    """The one-rank baseline: the train step alone, on a mesh of one rank
    (in a world of one rank)."""
    from determined_clone_tpu_torch.core._distributed import (
        DistributedContext,
    )
    from determined_clone_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    dist = dist or DistributedContext.from_torch()
    if dist.size != 1:
        raise RuntimeError(f"the baseline runs in a world of one rank, not "
                           f"{dist.size}")
    mesh = make_mesh(MeshSpec(), device_type=device)
    return _measure_mesh(mesh, PER_DEVICE_BATCH, steps=steps, warmup=warmup,
                         device=device, dist=dist)


def _rank(args: Any) -> int:
    """One rank of a stage: ``baseline`` writes its run to ``--out``;
    ``mesh`` reads it from ``--baseline`` and rank 0 prints the
    artifact."""
    import torch

    from determined_clone_tpu_torch.exec import launch

    if args.device == "cpu":
        torch.set_num_threads(1)
    dist = launch.init_from_env(args.device)
    try:
        kw = dict(steps=args.steps, warmup=args.warmup, device=args.device,
                  dist=dist)
        if args.stage == "baseline":
            with open(args.out, "w") as f:
                json.dump(measure_baseline(**kw), f)
            return 0
        with open(args.baseline) as f:
            baseline = json.load(f)
        result = run_scaling_bench(
            args.devices, baseline=baseline,
            axes=[a.strip() for a in args.axes.split(",") if a.strip()],
            **kw)
        if dist.rank == 0:
            print(json.dumps(result) if args.json else
                  json.dumps(result, indent=2, sort_keys=True), flush=True)
        return 0
    finally:
        launch.shutdown()


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    from determined_clone_tpu_torch.exec import launch

    parser = argparse.ArgumentParser(
        description="measured multichip scaling lane (one rank per card)")
    parser.add_argument("--devices", type=int, default=8)
    parser.add_argument("--axes", default=",".join(DEFAULT_AXES),
                        help="comma-separated mesh axes to measure")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--warmup", type=int, default=1)
    parser.add_argument("--json", action="store_true",
                        help="emit the artifact as one JSON line")
    parser.add_argument("--device", choices=sorted(launch.BACKENDS),
                        default="cuda")
    parser.add_argument("--timeout", type=float,
                        default=launch.DEFAULT_TIMEOUT_S)
    # a rank's stage, as the command above starts it
    parser.add_argument("--stage", choices=("baseline", "mesh"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--out", help=argparse.SUPPRESS)
    parser.add_argument("--baseline", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.stage is not None:
        return _rank(args)

    cmd = [sys.executable, "-m", "determined_clone_tpu_torch.parallel."
           "scaling_bench", "--devices", str(args.devices), "--axes",
           args.axes, "--steps", str(args.steps), "--warmup",
           str(args.warmup), "--device", args.device]
    if args.json:
        cmd.append("--json")
    with tempfile.TemporaryDirectory(prefix="dct-scaling-") as tmp:
        path = os.path.join(tmp, "baseline.json")
        rc = launch.spawn(cmd + ["--stage", "baseline", "--out", path], 1,
                          device=args.device, timeout_s=args.timeout)
        if rc != 0:
            return rc
        return launch.spawn(cmd + ["--stage", "mesh", "--baseline", path],
                            args.devices, device=args.device,
                            timeout_s=args.timeout)


if __name__ == "__main__":
    raise SystemExit(main())
