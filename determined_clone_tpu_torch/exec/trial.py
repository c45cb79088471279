"""In-task trial entrypoint — what the port's agent execs for a trial leg;
the port of ``determined_clone_tpu/exec/trial.py``.

≈ the reference's in-container chain (entrypoint.sh → prep_container →
determined.exec.harness, SURVEY.md §3.1-3.2), collapsed: ClusterInfo from
the ``DCT_*`` environment (≈ _info.py:23), the master rendezvous
(≈ prep_container.py:203), a ``torch.distributed`` world for a gang of
more than one rank, master-backed Core API contexts, then
``Trainer(trial).fit`` on the user's ``TorchTrial`` class or a Core API
function ``fn(core_context, cluster_info)``.

Where the JAX harness calls ``jax.distributed.initialize``, member 0 of
the rendezvous carries ``host:store_port:ctrl_port``: every rank joins
``torch.distributed`` on that store (NCCL on the card, gloo on the CPU)
and the object collectives of ``core.DistributedContext`` run over the
chief's TCP transport on ``ctrl_port``. A task of ``DCT_SLOTS`` > 1 runs
one process per card through ``exec/launch.py`` (global rank = agent rank
× slots + local rank); the task's own process does the rendezvous, and
its ranks read the answer from ``DCT_RENDEZVOUS``.

The device is ``DCT_DEVICE`` (the card, ``cuda``, unless it names
``cpu``): without CUDA the leg raises unless the CPU was asked for.

Usage (by the agent):
``python -m determined_clone_tpu_torch.exec.trial module:Class``
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import signal
import socket
import sys
import threading
import time
from typing import Any, Dict, Optional

from determined_clone_tpu_torch import faults

# a SIGTERM that lands before core.init (the agent sends one beside the
# preempt flag) must not kill the leg before it can checkpoint: it is held
# here and handed to the preempt context once there is one
_EARLY_SIGTERM = threading.Event()


@dataclasses.dataclass
class ClusterInfo:
    """What a Core API function entrypoint ``fn(core_context,
    cluster_info)`` receives (≈ det.get_cluster_info(),
    harness/determined/_info.py:23-137)."""

    master_host: str
    master_port: int
    allocation_id: str
    trial_id: int
    experiment_id: int
    rank: int
    world_size: int
    slots: int
    n_slices: int
    hparams: Dict[str, Any]
    target_units: int
    latest_checkpoint: Optional[str]
    experiment_config: Dict[str, Any]

    @staticmethod
    def from_env() -> "ClusterInfo":
        def need(name: str) -> str:
            v = os.environ.get(name)
            if v is None:
                raise RuntimeError(f"missing required env var {name}")
            return v

        return ClusterInfo(
            master_host=os.environ.get("DCT_MASTER_HOST", "127.0.0.1"),
            master_port=int(os.environ.get("DCT_MASTER_PORT", "8080")),
            allocation_id=need("DCT_ALLOCATION_ID"),
            trial_id=int(need("DCT_TRIAL_ID")),
            experiment_id=int(os.environ.get("DCT_EXPERIMENT_ID", "0")),
            rank=int(os.environ.get("DCT_RANK", "0")),
            world_size=int(os.environ.get("DCT_WORLD_SIZE", "1")),
            slots=int(os.environ.get("DCT_SLOTS", "1")),
            n_slices=int(os.environ.get("DCT_N_SLICES", "1")),
            hparams=json.loads(os.environ.get("DCT_HPARAMS", "{}")),
            target_units=int(os.environ.get("DCT_TARGET_UNITS", "0")),
            latest_checkpoint=os.environ.get("DCT_LATEST_CHECKPOINT") or None,
            experiment_config=json.loads(
                os.environ.get("DCT_EXPERIMENT_CONFIG", "{}")),
        )


def resolve_entrypoint(entrypoint: str):
    """'pkg.module:Attr' → a TorchTrial subclass or a Core API function
    ``fn(core_context, cluster_info)``. The model-def directory (cwd) is on
    sys.path, like the reference's context-dir download + import."""
    if ":" not in entrypoint:
        raise RuntimeError(
            f"entrypoint {entrypoint!r} must look like 'module:TrialClass' "
            f"or 'module:core_api_function'"
        )
    module_name, class_name = entrypoint.split(":", 1)
    if "" == module_name:
        raise RuntimeError("entrypoint module is empty")
    sys.path.insert(0, os.getcwd())
    module = importlib.import_module(module_name)
    return getattr(module, class_name)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("0.0.0.0", 0))
        return s.getsockname()[1]


def do_rendezvous(session, info: ClusterInfo, addr: str) -> dict:
    """Register our address; poll until the whole gang is present
    (≈ task/rendezvous.go:94-187). Returns the full rendezvous payload:
    rank-ordered ``members`` (member[0] carries the torch store and
    control-plane ports) plus, for multislice gangs, ``n_slices`` and the
    per-rank ``slice_ids`` the scheduler assigned."""
    deadline = time.monotonic() + 300
    while True:
        faults.point("trial.rendezvous")
        resp = session.post(
            f"/api/v1/allocations/{info.allocation_id}/rendezvous",
            {"rank": info.rank, "address": addr},
            retryable=True,  # idempotent re-registration
        )
        if resp.get("ready"):
            return resp
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"rendezvous timed out: {len(resp.get('members', []))}/"
                f"{resp.get('world_size')} members present"
            )
        time.sleep(0.5)


def build_multislice_mesh(info: ClusterInfo, rdv: dict, device_type: str):
    """The hybrid per-slice × cross-slice mesh for a master-scheduled
    slice-group gang, over the ranks of the torch world (one agent per
    slice, its cards the slice's ranks).

    The rendezvous payload is the source of truth for the slice layout
    (scheduler.cc's n_slices branch put one whole slice on each agent;
    routes.cc's rendezvous response carries the per-rank slice_ids). The
    mesh hparam splits into {"ici": {per-slice axes}, "dcn": {cross-slice
    axes}}; dcn defaults to pure data parallelism over the slices.
    """
    import math

    from determined_clone_tpu_torch.parallel.mesh import (
        MeshSpec,
        make_multislice_mesh,
    )

    n_slices = int(rdv.get("n_slices", info.n_slices))
    slice_ids = list(rdv.get("slice_ids") or [])
    if slice_ids:
        # make_multislice_mesh assumes slice-major rank order: each
        # slice's ranks must be one contiguous ascending run of equal size
        if slice_ids != sorted(slice_ids):
            raise RuntimeError(
                f"rendezvous slice_ids are not slice-major: {slice_ids}")
        counts = [slice_ids.count(s) for s in range(n_slices)]
        if len(set(counts)) > 1:
            raise RuntimeError(f"uneven slice groups: {counts}")

    mesh_hp = info.hparams.get("mesh") or {}
    unknown = set(mesh_hp) - {"ici", "dcn"}
    if unknown:
        # a flat single-slice spec ({"dp": 8, "tp": 2}) here would be
        # silently dropped — reject loudly instead
        raise RuntimeError(
            f"multislice experiments take mesh: {{ici: ..., dcn: ...}}; "
            f"got flat axes {sorted(unknown)}")
    ici = MeshSpec.from_dict(mesh_hp.get("ici") or {})
    dcn = MeshSpec.from_dict(mesh_hp.get("dcn") or {"dp": n_slices})
    dcn_total = math.prod(dcn.axis_sizes())
    if dcn_total != n_slices:
        raise RuntimeError(
            f"mesh.dcn axes {dcn.to_dict()} multiply to {dcn_total} but the "
            f"allocation has {n_slices} slices — per-slice axes would span "
            f"the slice boundary")
    return make_multislice_mesh(ici, dcn, device_type=device_type)


def _spawned_at() -> Optional[float]:
    """Wall-clock time this process was spawned (``/proc/self/stat``'s
    start time), or None off Linux."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - age
    except (OSError, ValueError, IndexError):
        return None


def _ignore_late_sigterm() -> None:
    """The leg is over: a preemption that arrives now (the master preempts
    a finished trial's allocation) has nothing to stop. Ignored, it cannot
    kill the interpreter's finalization, which restores the default action
    of a Python-level handler."""
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, signal.SIG_IGN)


def _world(info: ClusterInfo, rdv: dict, device: str, chief_transport):
    """Join the gang's ``torch.distributed`` world and build the
    ``DistributedContext``: one rank per card, global rank = agent rank ×
    slots + local rank (``exec/launch.py``'s environment when the task
    spawned its ranks, the agent's rank otherwise)."""
    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.core._distributed import _ChiefTransport
    from determined_clone_tpu_torch.exec import launch

    slots = max(1, info.slots)
    world = max(1, info.world_size) * slots
    if world == 1:
        return core.DistributedContext.single()
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    rank = info.rank * slots + local_rank
    chief_host, store_port, ctrl_port = rdv["members"][0].rsplit(":", 2)
    if rank == 0 and chief_transport is None:
        # listening before the world forms: the workers connect as soon
        # as init_rank returns on their side
        chief_transport = _ChiefTransport(int(ctrl_port), world)
    launch.init_rank(rank, world, device=device, local_rank=local_rank,
                     master_addr=chief_host, master_port=int(store_port))
    cross = dict(local_rank=local_rank, local_size=slots)
    if rank == 0:
        return core.DistributedContext(
            rank=0, size=world, cross_rank=0, cross_size=world // slots,
            transport=chief_transport, **cross)
    return core.DistributedContext.from_tcp(chief_host, int(ctrl_port), rank,
                                            world, **cross)


def _launch_ranks(argv, info: ClusterInfo, session, device: str) -> int:
    """A task of ``DCT_SLOTS`` > 1: rendezvous for this agent, then one
    rank per card through ``exec/launch.py``, each running this module
    with the rendezvous in ``DCT_RENDEZVOUS``."""
    from determined_clone_tpu_torch.exec import launch

    slots = info.slots
    host = socket.gethostname()
    if info.rank == 0:
        addr = f"{host}:{_free_port()}:{_free_port()}"
    else:
        addr = f"{host}:0:0"
    rdv = do_rendezvous(session, info, addr)
    chief_host, store_port, _ = rdv["members"][0].rsplit(":", 2)
    env = {**os.environ, "DCT_RENDEZVOUS": json.dumps(rdv)}
    print(f"[trial] launching {slots} ranks ({info.rank * slots}.."
          f"{info.rank * slots + slots - 1} of "
          f"{max(1, info.world_size) * slots})", flush=True)
    code = launch.spawn([sys.executable, "-m",
                         "determined_clone_tpu_torch.exec.trial", *argv],
                        slots, device=device, env=env, node_rank=info.rank,
                        world_size=max(1, info.world_size) * slots,
                        master_addr=chief_host, master_port=int(store_port),
                        timeout_s=float("inf"))
    _ignore_late_sigterm()
    return code


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m determined_clone_tpu_torch.exec.trial "
              "module:Class", file=sys.stderr)
        return 2
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM,
                      lambda signum, frame: _EARLY_SIGTERM.set())

    spawned_at = _spawned_at()
    if spawned_at is not None:
        print(f"[trial] process spawned at {spawned_at:.3f} (pid "
              f"{os.getpid()}, CUDA_VISIBLE_DEVICES="
              f"{os.environ.get('CUDA_VISIBLE_DEVICES', '(unset)')})",
              flush=True)

    from determined_clone_tpu_torch.api.client import MasterSession
    from determined_clone_tpu_torch.device import resolve_device

    # Chaos runs ship their plan through the environment; a no-op when
    # DCT_FAULT_PLAN is unset.
    faults.install_from_env()

    info = ClusterInfo.from_env()
    faults.point("trial.startup")
    device = os.environ.get("DCT_DEVICE", "cuda")
    resolve_device(device)  # no card and no `cpu`: raise, never fall back
    session = MasterSession(info.master_host, info.master_port)
    if info.slots > 1 and "DCT_RENDEZVOUS" not in os.environ:
        return _launch_ranks(argv, info, session, device)

    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.config.experiment import ExperimentConfig
    from determined_clone_tpu_torch.config.length import Length, Unit
    from determined_clone_tpu_torch.core._master_backed import (
        MasterCheckpointRegistry,
        MasterMetricsBackend,
        MasterPreemptionSource,
        MasterSearcherSource,
    )
    from determined_clone_tpu_torch.exec import launch
    from determined_clone_tpu_torch.training import (
        Trainer,
        TorchTrial,
        TrialContext,
    )

    config = ExperimentConfig.from_dict(info.experiment_config)
    trial_cls = resolve_entrypoint(argv[0])

    # Ports are chosen ephemerally and advertised via rendezvous so that
    # concurrent gangs sharing a host never collide. member[0] format:
    # "host:store_port:ctrl_port".
    chief_transport = None
    if "DCT_RENDEZVOUS" in os.environ:
        rdv = json.loads(os.environ["DCT_RENDEZVOUS"])
    else:
        if info.world_size > 1 and info.rank == 0:
            from determined_clone_tpu_torch.core._distributed import (
                _ChiefTransport,
            )

            chief_transport = _ChiefTransport(0, info.world_size)
            addr = (f"{socket.gethostname()}:{_free_port()}:"
                    f"{chief_transport.port}")
        else:
            addr = f"{socket.gethostname()}:0:0"
        rdv = do_rendezvous(session, info, addr)
    dist = _world(info, rdv, device, chief_transport)
    print(f"[trial] harness ready at {time.time():.3f} (imports, "
          f"rendezvous and the world joined)", flush=True)

    # searcher targets arrive in max_length units; wrap for the trainer
    unit = (config.searcher.max_length.unit
            if config.searcher.max_length is not None else Unit.BATCHES)

    class UnitWrappingSource(MasterSearcherSource):
        def operations(self, is_chief):
            for op in super().operations(is_chief):
                op.length = Length(unit, int(op.length))
                yield op

    exit_code = 0
    try:
        with core.init(
            config=config,
            distributed=dist,
            metrics_backend=MasterMetricsBackend(session, info.trial_id),
            preemption_source=MasterPreemptionSource(session,
                                                     info.allocation_id),
            searcher_source=UnitWrappingSource(session, info.trial_id),
            checkpoint_registry=MasterCheckpointRegistry(session,
                                                         info.trial_id),
            trial_id=info.trial_id,
        ) as cctx:
            # SIGTERM -> graceful preemption (≈ exec/launch.py:18-27's
            # SLURM SIGTERM semantics): the agent sends a SIGTERM beside
            # the preempt flag; both end in one checkpoint-and-exit at the
            # next chunk boundary, never a death mid-step
            signal.signal(signal.SIGTERM,
                          lambda signum, frame: cctx.preempt.signal())
            if _EARLY_SIGTERM.is_set():
                cctx.preempt.signal()

            # observability: telemetry (opt-in via `observability` config,
            # already built by core.init), profiler (opt-in via
            # `profiling` config) + tensorboard event shipping (chief
            # only, needs a storage backend). The telemetry registry feeds
            # the profiler's drop counters; spans/metrics ship over the
            # profiler channel.
            from determined_clone_tpu_torch import profiler as profiler_mod

            tel = cctx.telemetry
            if tel is not None and not tel.trace_path:
                tel.trace_path = os.path.abspath(
                    f"trace-trial-{info.trial_id}.json")
            if tel is not None:
                # trace stitching: the lane name makes this process a
                # distinct row in the stitched trace
                tel.set_identity(process_name=f"trial-{info.trial_id}")
            prof = profiler_mod.from_config(
                session, info.trial_id, info.experiment_config,
                registry=tel.registry if tel is not None else None)
            cctx.profiler = prof if prof.enabled else None
            prof.start()

            tbm = None
            storage_raw = info.experiment_config.get("checkpoint_storage")
            if dist.is_chief and storage_raw:
                from determined_clone_tpu_torch.tensorboard import (
                    TensorboardManager,
                )

                try:
                    tbm = TensorboardManager.from_config(
                        storage_raw, info.experiment_id, info.trial_id,
                        os.path.abspath(f"tb-events-trial-{info.trial_id}"),
                        rank=info.rank,
                    ).start()
                except Exception as e:  # noqa: BLE001 - best-effort
                    print(f"[trial] tensorboard disabled: {e}", flush=True)
            cctx.tensorboard = tbm

            # trial construction INSIDE the try: a raising user __init__
            # must still stop the profiler/tb threads and report the
            # failure cleanly
            try:
                if isinstance(trial_cls, type):
                    # a class that does NOT subclass TorchTrial is a config
                    # error, not a Core API script — constructing it would
                    # "complete" without training a step
                    if not issubclass(trial_cls, TorchTrial):
                        raise RuntimeError(
                            f"entrypoint class {trial_cls.__name__!r} must "
                            f"subclass TorchTrial (or be a plain function "
                            f"for the Core API)")
                    # multislice gang: the hybrid mesh from the rendezvous
                    # slice assignments (Core API entrypoints drive their
                    # own layout, so only the Trainer path pays for this)
                    kwargs = {}
                    if info.n_slices > 1:
                        kwargs["mesh"] = build_multislice_mesh(
                            info, rdv, resolve_device(device).type)
                    tctx = TrialContext(config=config, hparams=info.hparams,
                                        core=cctx, device=device, **kwargs)
                    trial = trial_cls(tctx)
                    result = Trainer(trial).fit(
                        latest_checkpoint=info.latest_checkpoint)
                elif not callable(trial_cls):
                    raise RuntimeError(
                        f"entrypoint {trial_cls!r} is neither a TorchTrial "
                        f"subclass nor a callable")
                else:
                    # Core API script entrypoint: a plain function driving
                    # the Context itself (searcher ops, metrics,
                    # checkpoints), called with the live Context and
                    # ClusterInfo
                    result = trial_cls(cctx, info)
                print(f"[trial] leg finished: {result}", flush=True)
            except Exception as e:  # noqa: BLE001 - report, then fail
                print(f"[trial] FAILED: {type(e).__name__}: {e}", flush=True)
                exit_code = 1
            finally:
                if tel is not None:
                    # final metric snapshot rides the profiler buffer that
                    # prof.stop() flushes
                    tel.publish(cctx.profiler)
                    try:
                        path = tel.export_chrome_trace()
                        print(f"[trial] telemetry trace written: {path}",
                              flush=True)
                    except OSError as e:
                        print(f"[trial] trace export failed: {e}",
                              flush=True)
                prof.stop()
                if tbm is not None:
                    tbm.close()
    finally:
        _ignore_late_sigterm()
        launch.shutdown()
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
