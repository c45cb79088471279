"""Measure callable for autotuning the GPT flagship model — the port of
``determined_clone_tpu/autotune/gpt_bench.py``.

The dsat "model profile info" trial analogue: builds the port's mesh and
sharded train step for one candidate and times a few real steps. Where
the JAX measure takes a subset of ``jax.devices()``, the port's runs on
the ranks of the ``torch.distributed`` world the caller joined
(``exec/launch.py``: ``init_rank`` in one process, ``--nprocs N`` for
N); every rank calls it with the same candidate, and a candidate whose
mesh is not the whole world is infeasible (it raises). The time is the
slowest rank's, so every rank returns the same rate and ``autotune``
takes the same decisions on each.
"""
from __future__ import annotations

from typing import Dict


def make_gpt_measure(cfg=None, *, seq_len: int = 64, warmup: int = 1,
                     steps: int = 3, device: str = "cuda"):
    """Returns ``measure(mesh_axes, remat, per_device_batch) -> samples/sec``
    over the world's ranks; ``cfg`` defaults to the JAX bench's small GPT
    (vocab 256, 2 layers, d 64, 4 heads, d_ff 128)."""
    from determined_clone_tpu_torch.device import resolve_device
    from determined_clone_tpu_torch.models import gpt

    device = resolve_device(device)
    if cfg is None:
        cfg = gpt.GPTConfig(vocab_size=256, n_layers=2, d_model=64,
                            n_heads=4, d_ff=128, max_seq_len=seq_len)

    def measure(mesh_axes: Dict[str, int], remat: bool,
                per_device_batch: int) -> float:
        import dataclasses
        import math
        import time

        import torch
        import torch.distributed as dist

        from determined_clone_tpu_torch.parallel import MeshSpec, make_mesh
        from determined_clone_tpu_torch.parallel.sharding import (
            NamedSharding,
            to_dtensor,
        )
        from determined_clone_tpu_torch.training import optim
        from determined_clone_tpu_torch.training.train_step import (
            create_train_state,
            make_train_step,
            shard_state,
            state_shardings,
        )

        if not dist.is_initialized():
            raise RuntimeError(
                "make_gpt_measure runs on a torch.distributed world: join "
                "one first (exec/launch.py init_rank, or --nprocs N)")
        n_devices = math.prod(mesh_axes.values())
        if n_devices != dist.get_world_size():
            raise ValueError(
                f"mesh {mesh_axes} needs {n_devices} ranks; the world has "
                f"{dist.get_world_size()}")
        run_cfg = dataclasses.replace(cfg, remat=remat)
        # dp is always re-derived (MeshSpec dp=-1 absorbs the remainder)
        spec_kwargs = {k: v for k, v in mesh_axes.items()
                       if k != "dp" and v > 1}
        mesh = make_mesh(MeshSpec(dp=-1, **spec_kwargs))

        params = gpt.init(torch.Generator(device=device).manual_seed(0),
                          run_cfg, device=device)
        tx = optim.adamw(1e-3)
        state = create_train_state(params, tx, 1)
        state = shard_state(state, state_shardings(state, mesh,
                                                   gpt.GPT_SHARDING_RULES))
        global_batch = per_device_batch * n_devices
        tokens = torch.randint(
            0, run_cfg.vocab_size, (global_batch, seq_len + 1),
            device=device,
            generator=torch.Generator(device=device).manual_seed(2))
        tokens = to_dtensor(tokens, NamedSharding(mesh, gpt.TOKENS_SPEC))

        def loss_fn(p, b, seed):
            return gpt.loss_fn(p, run_cfg, b[:, :-1], b[:, 1:]), {}

        step = make_train_step(loss_fn, tx)
        # at least one warmup step, so first-call costs stay out of the
        # timed region (and `metrics` exists for the sync below)
        for _ in range(max(1, warmup)):
            state, metrics = step(state, tokens)
        loss = float(metrics["loss"])  # the sync
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step(state, tokens)
        loss = float(metrics["loss"])
        dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                          device=device)
        dist.all_reduce(dt, op=dist.ReduceOp.MAX)  # the slowest rank's
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite loss {loss} for {mesh_axes}")
        return global_batch * steps / float(dt)

    return measure
