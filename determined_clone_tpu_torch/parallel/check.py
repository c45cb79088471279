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
Then the GPT trial (``examples/gpt_fsdp.py``) through ``core.init`` →
``Trainer.fit`` on the first case's mesh: 4 batches with sharded
checkpoints in a directory every rank sees, restored from the one at 4
to 8 batches; its reports within 1e-5 of the same trial alone on one
card.

With 4 ranks, the second half of the slice follows, each case held
against the same work alone on one card with the same bounds, its
meshed ms/step printed (on the cards ``GPTConfig()`` at full width; on
the CPU the small widths below):

- the GPipe pipeline (``GPT_PP_SHARDING_RULES``): ``{pp: 2, dp: 2}`` at
  B=8 with M=4 microbatches, and ``{pp: 4}`` at B=16 (so that M=16
  divides it) with M = 4, 8 and 16, each beside
  ``pipeline_bubble_fraction`` and with the flash kernel's launches per
  rank, (L/P) layers x M ticks x 2 a step; the ``{pp: 2, dp: 2}`` state saved one
  shard per rank and restored into ``{pp: 4}``'s placements, bit for
  bit; the MoE GPT (cf 1.25) on ``{pp: 2, ep: 2}`` in one microbatch
  (each stage's products in the one card's shapes);
- the GPT over ``sp`` on ``{sp: 2, fsdp: 2}`` and ``{sp: 4}`` (ring
  attention; the one-card run attends with ``mha``); ring and Ulysses
  attention at sp 4 against ``mha`` on the whole sequence, outputs and
  gradients within 2e-4 (B=4, T=1024, H=12, D=64 on the cards);
- BASELINE #2 (``examples/mnist/distributed.yaml``, cut 8 → 4 ranks,
  ``{dp: 4}``, 64 images per rank) and BASELINE #3
  (``examples/resnet50/distributed.yaml``, cut 8 → 4, ``{dp: 2, fsdp:
  2}``, 32 images per rank at 224², fp32) through ``Trainer.fit`` at
  lr 1e-4 (the bounds' learning rate), their reports within 1e-5 (mnist)
  and 1e-3 (ResNet: its convolutions sum in other orders at 32 images
  than at 128) of the trial alone at the same global batch;
- BERT-base (``bert_finetune``'s widths, seq 128, B=8, fp32) under
  ``BERT_SHARDING_RULES`` on ``{fsdp: 2, tp: 2}``: three steps of the
  classification loss.

Prints one JSON line per case from rank 0 and exits non-zero on any
mismatch.
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
# the second half's widths on the CPU (gloo), where full width is too big
CPU_WIDTHS = dict(WIDTHS, n_layers=4)


def _tx():
    return optim.chain(optim.clip_by_global_norm(0.5),
                       optim.adamw(LR, b1=0.9, b2=0.95, weight_decay=0.1))


def _steps(cfg, device, mesh=None, rules=gpt.GPT_SHARDING_RULES, batch=B,
           seq=T):
    """(losses, grad norms, state, ms per step after the first, the
    flash kernel's launches) of STEPS steps from seeded weights."""
    from determined_clone_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    params = gpt.init(gen, cfg, device=device)
    tx = _tx()
    state = create_train_state(params, tx, 1)
    if mesh is not None:
        state = shard_state(state, state_shardings(state, mesh, rules))

    def loss(p, b, seed):
        return gpt.loss_fn(p, cfg, b[:, :-1], b[:, 1:]), {}

    step = make_train_step(loss, tx)
    tokens = torch.randint(0, cfg.vocab_size, (STEPS, batch, seq + 1),
                           device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(1))
    losses, norms = [], []
    flash_attention.launches = 0
    for i, b in enumerate(tokens):
        if i == 1:
            _sync(device)
            t0 = time.monotonic()
        if mesh is not None:
            b = to_dtensor(b, NamedSharding(mesh, batch_spec(1)))
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    step_ms = (time.monotonic() - t0) * 1e3 / (STEPS - 1)
    return losses, norms, state, step_ms, flash_attention.launches


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def run_case(model, sizes, device, rank) -> dict:
    cfg = gpt.GPTConfig(**WIDTHS, compute_dtype=torch.float32,
                        moe_experts=4 if model == "moe" else 0,
                        moe_capacity_factor=0.5)
    mesh = make_mesh(MeshSpec.from_dict({"dp": 1, **sizes}),
                     device_type=device)
    t0 = time.monotonic()
    m_loss, m_norm, state, _, _ = _steps(cfg, device, mesh)
    mesh_s = time.monotonic() - t0
    o_loss, o_norm, alone, _, _ = _steps(cfg, device)
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


# -- the second half: pp, sp, the families ----------------------------------


def _mesh(sizes, device):
    return make_mesh(MeshSpec.from_dict({"dp": 1, **sizes}),
                     device_type=device)


def _max_rel(a, b):
    return max(abs(x / y - 1) for x, y in zip(a, b))


def _param_err(meshed, alone) -> float:
    """The largest difference between each rank's blocks of the meshed
    params and the same blocks of the one-card params, over every rank."""
    from determined_clone_tpu_torch.parallel.sharding import local_block

    err = torch.zeros((), dtype=torch.float64)
    for m, a in zip(optim.leaves(meshed), optim.leaves(alone)):
        block = local_block(a.detach(), m.device_mesh, m.placements)
        err = torch.maximum(err, (local_tensor(m).detach() - block).abs()
                            .max().double().cpu())
    if dist.get_backend() == "nccl":
        err = err.cuda()
    dist.all_reduce(err, op=dist.ReduceOp.MAX)
    return float(err)


def _held(name, sizes, m, o, meshed, alone, launches=None, **extra
          ) -> dict:
    """A case's line: ok when losses and grad norms agree within 1e-5
    relative, parameters within 1e-4, and (on the card) the flash kernel
    ran the ``launches`` expected of this rank."""
    rel = max(_max_rel(m[0], o[0]), _max_rel(m[1], o[1]))
    err = _param_err(meshed, alone)
    ok = rel <= 1e-5 and err <= 1e-4
    if launches is not None:
        extra.update(flash_launches=m[4], expected_launches=launches)
        ok = ok and (m[4] == launches or not torch.cuda.is_available())
    return {"model": name, "mesh": sizes, "ok": ok,
            "loss_mesh": m[0], "loss_alone": o[0], "grad_norm_mesh": m[1],
            "grad_norm_alone": o[1], "max_rel": rel, "max_param_err": err,
            **extra}


def _stage_launches(cfg, pp, M):
    """Flash launches per rank over STEPS remat steps: (L / P) layers x the
    M ticks that run the stage x 2 (the forward and the recompute)."""
    return STEPS * cfg.n_layers // pp * M * 2


def _gpt_cfg(device, **kw):
    if device == "cuda":
        return gpt.GPTConfig(compute_dtype=torch.float32, **kw)
    return gpt.GPTConfig(**CPU_WIDTHS, compute_dtype=torch.float32, **kw)


def pipeline_cases(device, rank) -> list:
    """{pp: 2, dp: 2} at M=4, then {pp: 4} at M = 4, 8, 16; a pp
    checkpoint moved from the first layout to the second; the MoE GPT on
    {pp: 2, ep: 2}."""
    from determined_clone_tpu_torch.parallel.pipeline import (
        pipeline_bubble_fraction,
    )

    seq = 1024 if device == "cuda" else T
    rules = gpt.GPT_PP_SHARDING_RULES
    out = []
    cfg = _gpt_cfg(device, pipeline_microbatches=4)
    o = _steps(cfg, device, batch=8, seq=seq)
    sizes = {"pp": 2, "dp": 2}
    m = _steps(cfg, device, _mesh(sizes, device), rules, batch=8, seq=seq)
    pp2_state = m[2]
    out.append(_held("gpt_pp", sizes, m, o, m[2].params, o[2].params,
                     _stage_launches(cfg, 2, 4),
                     microbatches=4, batch=8, step_ms=m[3],
                     alone_step_ms=o[3],
                     bubble=pipeline_bubble_fraction(4, 2)))
    o16 = _steps(cfg, device, batch=16, seq=seq)
    pp4_state = None
    for M in (4, 8, 16):
        cfg = _gpt_cfg(device, pipeline_microbatches=M)
        m = _steps(cfg, device, _mesh({"pp": 4}, device), rules, batch=16,
                   seq=seq)
        pp4_state = pp4_state or m[2]
        out.append(_held("gpt_pp", {"pp": 4}, m, o16, m[2].params,
                         o16[2].params, _stage_launches(cfg, 4, M),
                         microbatches=M, batch=16,
                         step_ms=m[3], alone_step_ms=o16[3],
                         bubble=pipeline_bubble_fraction(M, 4)))
    # the {pp: 2, dp: 2} state, one shard per rank, into {pp: 4}
    box = [tempfile.mkdtemp(prefix="dct-check-pp-") if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    save_pytree(box[0], pp2_state, host_id=rank)
    dist.barrier()
    moved = load_pytree(box[0], pp4_state)
    dist.barrier()
    if rank == 0:
        shutil.rmtree(box[0], ignore_errors=True)
    with torch.no_grad():
        same = all(torch.equal(a.full_tensor(), b.full_tensor())
                   for a, b in zip(optim.leaves(moved.params)
                                   + optim.leaves(moved.opt_state),
                                   optim.leaves(pp2_state.params)
                                   + optim.leaves(pp2_state.opt_state))
                   if hasattr(a, "full_tensor"))
    out.append({"model": "pp_checkpoint", "mesh": {"from": sizes,
                                                   "to": {"pp": 4}},
                "ok": same, "restored_bit_for_bit": same})
    del pp2_state, pp4_state, moved
    # the MoE GPT (cf 1.25: tokens dropped) in one microbatch, so that
    # each stage's products have the one card's shapes: split in two,
    # cuBLAS takes other kernels for the half-size products, a router
    # score moves in its last bits and a near-tied top-2 choice flips
    # (2.5e-5 of the grad norm by step 3 on four H100s); the CPU tests
    # hold microbatched MoE stages against JAX's
    E = 8 if device == "cuda" else 4
    cfg = _gpt_cfg(device, moe_experts=E, pipeline_microbatches=1)
    o = _steps(cfg, device, batch=8, seq=seq)
    sizes = {"pp": 2, "ep": 2}
    m = _steps(cfg, device, _mesh(sizes, device), rules, batch=8, seq=seq)
    out.append(_held("moe_pp", sizes, m, o, m[2].params, o[2].params,
                     _stage_launches(cfg, 2, 1),
                     microbatches=1, batch=8, step_ms=m[3],
                     alone_step_ms=o[3]))
    return out


def sequence_cases(device, rank) -> list:
    """The GPT over sp at {sp: 2, fsdp: 2} and {sp: 4} (ring attention;
    alone: mha), then ring and Ulysses at sp 4 against mha."""
    from determined_clone_tpu_torch.ops import attention

    seq = 1024 if device == "cuda" else T
    cfg = _gpt_cfg(device, attention_impl="mha")
    o = _steps(cfg, device, batch=8, seq=seq)
    out = []
    for sizes in ({"sp": 2, "fsdp": 2}, {"sp": 4}):
        m = _steps(cfg, device, _mesh(sizes, device), batch=8, seq=seq)
        out.append(_held("gpt_sp", sizes, m, o, m[2].params, o[2].params,
                         batch=8, step_ms=m[3], alone_step_ms=o[3]))
    del o, m
    shape = (4, 1024, 12, 64) if device == "cuda" else (2, 256, 8, 32)
    gen = torch.Generator(device=device).manual_seed(5)
    qkv = [torch.randn(shape, generator=gen, device=device)
           for _ in range(3)]
    whole = [t.clone().requires_grad_(True) for t in qkv]
    ref = attention.mha(*whole, causal=True)
    ref_g = torch.autograd.grad((ref ** 2).sum(), whole)
    mesh = _mesh({"sp": 4}, device)
    n = shape[1] // 4
    sl = slice(rank * n, (rank + 1) * n)
    for fn in (attention.ring_attention, attention.ulysses_attention):
        for _ in range(2):   # the second call timed: the first opens NCCL
            mine = [t[:, sl].clone().requires_grad_(True) for t in qkv]
            _sync(device)
            t0 = time.monotonic()
            y = fn(*mine, axis_name="sp", mesh=mesh)
            g = torch.autograd.grad((y ** 2).sum(), mine)
            _sync(device)
            ms = (time.monotonic() - t0) * 1e3
        err = torch.stack([(y - ref[:, sl]).abs().max()] + [
            (a - b[:, sl]).abs().max() for a, b in zip(g, ref_g)]).max()
        dist.all_reduce(err, op=dist.ReduceOp.MAX)
        out.append({"model": fn.__name__, "mesh": {"sp": 4},
                    "shape": list(shape), "ok": float(err) <= 2e-4,
                    "max_abs_err": float(err), "fwd_bwd_ms": ms})
    return out


def _family_fit(trial_cls, cfg_dict, hp, device, storage, ctx=None,
                mesh=_ALONE):
    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.config import ExperimentConfig
    from determined_clone_tpu_torch.training import Trainer, TrialContext

    cfg = ExperimentConfig.from_dict(cfg_dict)
    kw = {} if mesh is _ALONE else {"mesh": mesh}
    with core.init(config=cfg, distributed=ctx, storage_path=storage,
                   trial_id=1) as c:
        trial = trial_cls(TrialContext(config=cfg, hparams=hp, core=c,
                                       device=device, **kw))
        t0 = time.monotonic()
        Trainer(trial).fit()
        wall = time.monotonic() - t0
        records = [(r["group"], r["steps_completed"],
                    {k: v for k, v in r["metrics"].items()
                     if k in ("loss", "accuracy")})
                   for r in c.train._backend.records]
    return records, wall


def family_cases(device, ctx) -> list:
    """BASELINE #2 and #3 cut to four ranks through Trainer.fit, each
    against the same trial alone at the same global batch."""
    import dataclasses as dc

    from determined_clone_tpu_torch.examples.mnist import MnistTrial
    from determined_clone_tpu_torch.examples.resnet50 import ResNetTrial

    class ResNet32(ResNetTrial):
        def __init__(self, context):
            super().__init__(context)
            self.cfg = dc.replace(self.cfg, compute_dtype=torch.float32)

    def config(batches, su, slots):
        return {"searcher": {"name": "single", "metric": "loss",
                             "max_length": {"batches": batches}},
                "scheduling_unit": su,
                "min_validation_period": {"batches": batches},
                "checkpoint_policy": "none",
                "resources": {"slots_per_trial": slots}}

    # lr 1e-4, not the yamls' 1e-3: Adam's first updates are about
    # lr·sign(g), so an element whose gradient is rounding noise moves by
    # up to 2·lr between two summation orders; at 1e-3 that grows to 2e-4
    # of mnist's validation loss in 20 steps (four gloo ranks)
    mnist_hp = {"global_batch_size": 256, "lr": LR, "n_filters_1": 32,
                "n_filters_2": 64, "dropout_1": 0.25, "dropout_2": 0.5,
                "dataset": "digits"}
    if device == "cuda":
        resnet_hp = {"global_batch_size": 128, "lr": LR, "depth": 50,
                     "width": 64, "n_classes": 1000, "image_size": 224,
                     "n_train": 256}
    else:
        resnet_hp = {"global_batch_size": 8, "lr": LR, "depth": 26,
                     "width": 8, "n_classes": 10, "image_size": 64,
                     "n_train": 32}
    # (name, trial, hparams, mesh, batches, scheduling unit, report bound).
    # ResNet's bound is the family trials' cross-framework one
    # (tests/test_torch_family_trials.py): 32- and 128-image convolutions
    # sum in other orders (cuDNN picks other algorithms), and the GN
    # ResNet-50 at init amplifies the last bits to 2.7e-4 of the loss by
    # step 4 (four H100s), where mnist stays within 1.1e-6 over 20
    cases = [("mnist", MnistTrial, mnist_hp, {"dp": 4}, 20, 10, 1e-5),
             ("resnet50", ResNet32, resnet_hp, {"dp": 2, "fsdp": 2}, 4, 2,
              1e-3)]
    out = []
    for name, cls, hp, sizes, batches, su, bound in cases:
        box = [tempfile.mkdtemp(prefix="dct-check-") if ctx.rank == 0
               else None]
        dist.broadcast_object_list(box, src=0)
        alone_dir = tempfile.mkdtemp(prefix="dct-check-alone-")
        meshed, wall = _family_fit(cls, config(batches, su, 4),
                                   {**hp, "mesh": sizes}, device, box[0],
                                   ctx)
        alone, alone_wall = _family_fit(cls, config(batches, su, 1), hp,
                                        device, alone_dir, mesh=None)
        dist.barrier()
        if ctx.rank == 0:
            shutil.rmtree(box[0], ignore_errors=True)
        shutil.rmtree(alone_dir, ignore_errors=True)
        ok, rel = ctx.rank != 0, None
        if ctx.rank == 0:
            keys = [(g, s) for g, s, _ in meshed]
            ok = keys == [(g, s) for g, s, _ in alone] and bool(keys)
            rel = max(abs(a[k] / b[k] - 1) if k == "loss" else
                      abs(a[k] - b[k]) for (_, _, a), (_, _, b) in
                      zip(meshed, alone) for k in b)
            ok = ok and rel <= bound
        out.append({"model": name, "mesh": sizes, "ok": ok,
                    "reports": meshed, "alone": alone, "max_rel": rel,
                    "bound": bound,
                    "global_batch": hp["global_batch_size"],
                    "fit_s": wall, "alone_fit_s": alone_wall})
    return out


def bert_case(device, rank) -> dict:
    """BERT-base on {fsdp: 2, tp: 2}: three clipped AdamW steps of the
    classification loss against the same steps alone."""
    from determined_clone_tpu_torch.models import bert

    if device == "cuda":
        cfg = bert.BertConfig(max_seq_len=128, compute_dtype=torch.float32,
                              remat=True)
        batch, seq = 8, 128
    else:
        cfg, batch, seq = bert.BertConfig.tiny(), 8, 16
    sizes = {"fsdp": 2, "tp": 2}
    gen = torch.Generator(device=device).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (STEPS, batch, seq),
                           device=device, generator=gen)
    labels = torch.randint(0, cfg.n_classes, (STEPS, batch), device=device,
                           generator=gen)

    def run(mesh):
        params = bert.init(torch.Generator(device=device).manual_seed(0),
                           cfg, device=device)
        tx = _tx()
        state = create_train_state(params, tx, 1)
        if mesh is not None:
            state = shard_state(state, state_shardings(
                state, mesh, bert.BERT_SHARDING_RULES))
        step = make_train_step(lambda p, b, s: (bert.classify_loss(
            p, cfg, b[0], b[1]), {}), tx)
        losses, norms = [], []
        for i in range(STEPS):
            if i == 1:
                _sync(device)
                t0 = time.monotonic()
            b = (tokens[i], labels[i])
            if mesh is not None:
                b = (to_dtensor(b[0], NamedSharding(mesh, batch_spec(1))),
                     to_dtensor(b[1], NamedSharding(mesh, batch_spec(0))))
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        return losses, norms, state, (time.monotonic() - t0) * 1e3 / (
            STEPS - 1), 0

    o = run(None)
    m = run(_mesh(sizes, device))
    return _held("bert", sizes, m, o, m[2].params, o[2].params,
                 batch=batch, seq=seq, step_ms=m[3], alone_step_ms=o[3])


def main() -> int:
    device = os.environ.get("DCT_DEVICE", "cuda")
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    ctx = launch.init_from_env(device)
    results = []

    def emit(rows):   # each case's line as soon as it is done
        results.extend(rows)
        if ctx.rank == 0:
            for r in rows:
                print(json.dumps(r), flush=True)

    try:
        if ctx.size not in CASES:
            raise SystemExit(f"run with --nprocs 2 or 4, not {ctx.size}")
        for m, s in CASES[ctx.size]:
            emit([run_case(m, s, device, ctx.rank)])
        emit([run_trial(CASES[ctx.size][0][1], device, ctx)])
        if ctx.size == 4:   # the second half: pp, sp, the families, BERT
            emit(pipeline_cases(device, ctx.rank))
            emit(sequence_cases(device, ctx.rank))
            emit(family_cases(device, ctx))
            emit([bert_case(device, ctx.rank)])
    finally:
        launch.shutdown()
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
