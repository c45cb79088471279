"""One process per slot: the port's launcher for a meshed trial.

The JAX package drives every local device from one process
(``training/trial.py``); PyTorch wants a process per card, as the
reference platform's ``determined.launch.torch_distributed`` (a torchrun
wrapper) starts them. So::

    python -m determined_clone_tpu_torch.exec.launch --nprocs 8 \\
        [--device cpu] [--timeout S] -- python3 my_trial.py ...

starts the command ``--nprocs`` times on this host with ``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
a free ``MASTER_PORT``, ``DCT_DEVICE`` and ``OMP_NUM_THREADS=1`` set. Each
rank calls :func:`init_from_env`, which selects its card
(``torch.cuda.set_device(local_rank)``), joins the process group (NCCL
for ``cuda``, gloo for ``cpu``: explicitly, never one in place of the
other) and returns the rank's ``DistributedContext``. When a rank exits
non-zero the launcher kills the others and exits with that rank's code;
at ``--timeout`` it kills them all and exits 124.

:func:`init_rank` joins a world of given rank and size in this process
(``world_size=1`` in-process is how ``chip_smoke.py`` runs the mesh path
on its one card). The master rendezvous of the JAX package's
``exec/trial.py`` waits for the port's control-plane hooks.
"""
from __future__ import annotations

import argparse
import datetime
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from determined_clone_tpu_torch.core._distributed import DistributedContext

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
DEFAULT_TIMEOUT_S = 600.0


def free_port() -> int:
    """A TCP port on localhost that nothing listens on right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _backend(device: str) -> str:
    if device not in BACKENDS:
        raise ValueError(f"device must be one of {sorted(BACKENDS)}, got "
                         f"{device!r}")
    return BACKENDS[device]


def init_rank(rank: int, world_size: int, *, device: str = "cuda",
              local_rank: Optional[int] = None, master_addr: str = "127.0.0.1",
              master_port: Optional[int] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> DistributedContext:
    """Join the world as ``rank`` of ``world_size``: select the card
    ``local_rank`` (default ``rank``) when ``device`` is ``cuda``, then
    ``init_process_group`` over NCCL (``cuda``) or gloo (``cpu``)."""
    import torch
    import torch.distributed as dist

    backend = _backend(device)
    local_rank = rank if local_rank is None else local_rank
    kwargs = {}
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; launch with "
                               "--device cpu to run on the CPU")
        torch.cuda.set_device(local_rank)
        kwargs["device_id"] = torch.device("cuda", local_rank)
    port = master_port if master_port is not None else free_port()
    dist.init_process_group(
        backend, init_method=f"tcp://{master_addr}:{port}", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return DistributedContext.from_torch()


def init_from_env(device: Optional[str] = None, *,
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> DistributedContext:
    """:func:`init_rank` from the environment the launcher sets;
    ``device`` defaults to ``DCT_DEVICE`` (else ``cuda``)."""
    env = os.environ
    return init_rank(
        int(env["RANK"]), int(env["WORLD_SIZE"]),
        device=device or env.get("DCT_DEVICE", "cuda"),
        local_rank=int(env.get("LOCAL_RANK", env["RANK"])),
        master_addr=env.get("MASTER_ADDR", "127.0.0.1"),
        master_port=int(env["MASTER_PORT"]), timeout_s=timeout_s)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def rank_env(rank: int, nprocs: int, port: int, device: str,
             base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = dict(os.environ if base is None else base)
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nprocs),
               LOCAL_WORLD_SIZE=str(nprocs), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), DCT_DEVICE=device, OMP_NUM_THREADS="1")
    return env


def _kill(procs: List[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def spawn(cmd: Sequence[str], nprocs: int, *, device: str = "cuda",
          timeout_s: float = DEFAULT_TIMEOUT_S,
          env: Optional[Dict[str, str]] = None) -> int:
    """Run ``cmd`` as ``nprocs`` ranks and wait for them: 0 when every
    rank exits 0; the first non-zero code seen (the others killed); 124
    when ``timeout_s`` passes first (all killed). Each rank leads its own
    process group, so a kill takes its children too."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    _backend(device)
    port = free_port()
    procs = [subprocess.Popen(list(cmd), env=rank_env(r, nprocs, port, device,
                                                     env),
                              start_new_session=True)
             for r in range(nprocs)]
    deadline = time.monotonic() + timeout_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            if time.monotonic() > deadline:
                return 124
            time.sleep(0.05)
    finally:
        _kill(procs)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m determined_clone_tpu_torch.exec.launch",
        description="Run a command as one rank per slot on this host.")
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--device", choices=sorted(BACKENDS), default="cuda")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S)
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("no command to launch")
    return spawn(cmd, args.nprocs, device=args.device,
                 timeout_s=args.timeout)


if __name__ == "__main__":
    sys.exit(main())
