"""Hold the mesh path against the one-rank program on every rank::

    python -m determined_clone_tpu_torch.exec.launch --nprocs 4 -- \\
        python3 -m determined_clone_tpu_torch.parallel.check

(``--device cpu`` on both for gloo ranks on the CPU.) Each rank joins
the world (NCCL on the cards), draws the same GPT weights and batches
from a seed, and takes three steps of ``clip_by_global_norm(0.5)`` and
AdamW twice: over a mesh, with state and batch placed by
``GPT_SHARDING_RULES``, and alone without a mesh. Cases: the dense GPT
on ``{fsdp: 2, tp: 2}`` and the MoE GPT (cf 0.5: tokens dropped) on
``{dp: 2, ep: 2}`` with 4 ranks; ``{fsdp: 2}`` and ``{ep: 2}`` with 2.
Compute is fp32 with TF32 off. Losses and gradient norms must agree
within 1e-5 relative and parameters within 1e-4 (Adam's sign-noise
bound at lr 1e-4, as in the CPU parity tests); then each rank saves its
blocks of the meshed state (``save_pytree``, one shard per rank), and
the state loaded back into the placements must equal it bit for bit.
Last, the GPT trial (``examples/gpt_fsdp.py``) through ``core.init`` →
``Trainer.fit`` on the first case's mesh: 4 batches with sharded
checkpoints in a directory every rank sees, restored from the one at 4
to 8 batches; its reports within 1e-5 of the same trial alone on one
card. Prints one JSON line per case from rank 0 and exits non-zero on
any mismatch.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from determined_clone_tpu_torch.core._serialization import (
    load_pytree,
    save_pytree,
)
from determined_clone_tpu_torch.exec import launch
from determined_clone_tpu_torch.models import gpt
from determined_clone_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from determined_clone_tpu_torch.parallel.sharding import (
    NamedSharding,
    batch_spec,
    to_dtensor,
)
from determined_clone_tpu_torch.parallel.spmd import local_tensor
from determined_clone_tpu_torch.training import optim
from determined_clone_tpu_torch.training.train_step import (
    create_train_state,
    make_train_step,
    shard_state,
    state_shardings,
)

# no leaf above 2^17 elements: on leaves of millions of fp32 elements
# torch's CPU norm kernels lose precision to about the 1e-5 tolerance
WIDTHS = dict(vocab_size=1024, n_layers=2, d_model=128, n_heads=4,
              d_ff=512, max_seq_len=256, remat=True)
CASES = {4: [("dense", {"fsdp": 2, "tp": 2}), ("moe", {"dp": 2, "ep": 2})],
         2: [("dense", {"fsdp": 2}), ("moe", {"ep": 2})]}
B, T, STEPS, LR = 8, 128, 3, 1e-4
_ALONE = object()  # the trial context's own mesh rule


def _steps(cfg, device, mesh=None):
    """(losses, grad norms, state) of STEPS steps from seeded weights."""
    gen = torch.Generator(device=device).manual_seed(0)
    params = gpt.init(gen, cfg, device=device)
    tx = optim.chain(optim.clip_by_global_norm(0.5),
                     optim.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1))
    state = create_train_state(params, tx, 1)
    if mesh is not None:
        state = shard_state(state, state_shardings(state, mesh,
                                                   gpt.GPT_SHARDING_RULES))

    def loss(p, b, seed):
        return gpt.loss_fn(p, cfg, b[:, :-1], b[:, 1:]), {}

    step = make_train_step(loss, tx)
    tokens = torch.randint(0, cfg.vocab_size, (STEPS, B, T + 1),
                           device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(1))
    losses, norms = [], []
    for b in tokens:
        if mesh is not None:
            b = to_dtensor(b, NamedSharding(mesh, batch_spec(1)))
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, state


def run_case(model, sizes, device, rank) -> dict:
    cfg = gpt.GPTConfig(**WIDTHS, compute_dtype=torch.float32,
                        moe_experts=4 if model == "moe" else 0,
                        moe_capacity_factor=0.5)
    mesh = make_mesh(MeshSpec.from_dict({"dp": 1, **sizes}),
                     device_type=device)
    t0 = time.monotonic()
    m_loss, m_norm, state = _steps(cfg, device, mesh)
    mesh_s = time.monotonic() - t0
    o_loss, o_norm, alone = _steps(cfg, device)
    rel = max(max(abs(a / b - 1) for a, b in zip(m_loss, o_loss)),
              max(abs(a / b - 1) for a, b in zip(m_norm, o_norm)))
    with torch.no_grad():
        full = [p.full_tensor() for p in optim.leaves(state.params)]
    param_err = max((a - b.detach()).abs().max().item() for a, b in
                    zip(full, optim.leaves(alone.params)))
    # one shard per rank into a directory of rank 0's (one host), read
    # back into the placements
    box = [tempfile.mkdtemp(prefix="dct-check-") if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    save_pytree(box[0], state, host_id=rank)
    dist.barrier()
    loaded = load_pytree(box[0], state)
    dist.barrier()
    if rank == 0:
        shutil.rmtree(box[0], ignore_errors=True)
    adam = state.opt_state[1][0]
    adam_l = loaded.opt_state[1][0]
    same = all(torch.equal(local_tensor(a), local_tensor(b)) for a, b in zip(
        optim.leaves(state.params) + optim.leaves(adam.mu),
        optim.leaves(loaded.params) + optim.leaves(adam_l.mu)))
    ok = rel <= 1e-5 and param_err <= 1e-4 and same
    return {"model": model, "mesh": sizes, "ok": ok,
            "loss_mesh": m_loss, "loss_alone": o_loss,
            "grad_norm_mesh": m_norm, "grad_norm_alone": o_norm,
            "max_rel": rel, "max_param_err": param_err,
            "checkpoint_round_trip": same, "mesh_s": mesh_s}


def _fit(cfg_dict, hparams, device, storage, distributed=None,
         mesh=_ALONE, latest=None):
    """``core.init`` → ``Trainer(GPTTrial).fit()`` (reports, registry)."""
    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.config import ExperimentConfig
    from determined_clone_tpu_torch.examples.gpt_fsdp import GPTTrial
    from determined_clone_tpu_torch.training import Trainer, TrialContext

    class Trial(GPTTrial):
        def __init__(self, context):
            super().__init__(context)
            self.cfg = dataclasses.replace(self.cfg,
                                           compute_dtype=torch.float32)

    cfg = ExperimentConfig.from_dict(cfg_dict)
    kw = {} if mesh is _ALONE else {"mesh": mesh}
    with core.init(config=cfg, distributed=distributed, storage_path=storage,
                   trial_id=1) as ctx:
        trial = Trial(TrialContext(config=cfg, hparams=hparams, core=ctx,
                                   device=device, **kw))
        Trainer(trial).fit(latest_checkpoint=latest)
        records = [(r["group"], r["steps_completed"], r["metrics"]["loss"])
                   for r in ctx.train._backend.records]
        ckpts = ctx.checkpoint.committed_checkpoints()
    return records, ckpts


def run_trial(sizes, device, ctx) -> dict:
    """The GPT trial through ``Trainer.fit`` on the mesh: 4 batches with a
    sharded checkpoint, then restored from it to 8; against the same
    trial alone on this rank's card (no mesh, one rank). Reports are the
    chief's; every rank checks its own alone run against them."""
    hp = {"global_batch_size": B, "vocab_size": WIDTHS["vocab_size"],
          "n_layers": WIDTHS["n_layers"], "d_model": WIDTHS["d_model"],
          "n_heads": WIDTHS["n_heads"], "d_ff": WIDTHS["d_ff"],
          "seq_len": T, "remat": True, "lr": LR, "n_train_tokens": 20000,
          "mesh": sizes}

    def config(batches):
        return {"searcher": {"name": "single", "metric": "loss",
                             "max_length": {"batches": batches}},
                "scheduling_unit": 2,
                "min_validation_period": {"batches": 2},
                "min_checkpoint_period": {"batches": 4},
                "checkpoint_policy": "all",
                "resources": {"slots_per_trial": ctx.size}}

    box = [tempfile.mkdtemp(prefix="dct-check-") if ctx.rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    shared, alone_dir = box[0], tempfile.mkdtemp(prefix="dct-check-alone-")
    t0 = time.monotonic()
    first, ckpts = _fit(config(4), hp, device, shared, distributed=ctx)
    second, _ = _fit(config(8), hp, device, shared, distributed=ctx,
                     latest=ckpts[0] if ckpts else None)
    mesh_s = time.monotonic() - t0
    one = config(8)
    one["resources"] = {"slots_per_trial": 1}
    alone, _ = _fit(one, {**hp, "mesh": {}}, device, alone_dir, mesh=None)
    dist.barrier()
    if ctx.rank == 0:
        shutil.rmtree(shared, ignore_errors=True)
    shutil.rmtree(alone_dir, ignore_errors=True)
    meshed = dict(((g, s), x) for g, s, x in first + second)
    want = dict(((g, s), x) for g, s, x in alone)
    rel = (max(abs(meshed[k] / want[k] - 1) for k in want)
           if ctx.rank == 0 and set(meshed) == set(want) else None)
    ok = ctx.rank != 0 or (rel is not None and rel <= 1e-5)
    return {"model": "trial", "mesh": sizes, "ok": ok,
            "reports": sorted(meshed.items()), "max_rel": rel,
            "restored_from": bool(ckpts), "mesh_s": mesh_s}


def main() -> int:
    device = os.environ.get("DCT_DEVICE", "cuda")
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    ctx = launch.init_from_env(device)
    try:
        if ctx.size not in CASES:
            raise SystemExit(f"run with --nprocs 2 or 4, not {ctx.size}")
        results = [run_case(m, s, device, ctx.rank)
                   for m, s in CASES[ctx.size]]
        results.append(run_trial(CASES[ctx.size][0][1], device, ctx))
    finally:
        launch.shutdown()
    if ctx.rank == 0:
        for r in results:
            print(json.dumps(r), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
