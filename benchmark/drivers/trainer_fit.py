"""Trial throughput through the port's training loop on one card:
``core.init`` → ``Trainer.fit`` of a GPT trial over ``gpt.loss_fn`` and
the port's ``chain(clip_by_global_norm, adamw)``, as a team's trial runs.

The trial takes the benchmark's weights and batches. The fit is driven by
searcher operations of one scheduling unit each, handed out while the
window lasts, so it stops at a report boundary and saves nothing
(``checkpoint_policy: none``). Its reports are the trainer's own host
syncs: the window opens at the report after the warm-up steps and closes
at the first report at least ``seconds`` later. With ``trace`` one more
unit runs under the profiler after the close.

One object is trained throughout: the first ``checked_steps`` steps are
the ones the reference follows. Their losses are noted as the trial's
loss returns them, the first gradient is read from Adam's first moment
after one step (``mu / (1 - b1)``), and the change of every leaf is
taken from the parameters as the step after the last checked one finds
them, against the seed's weights drawn again leaf by leaf.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List, Optional

import torch

from benchmark import weights
from benchmark.generators.lm_train_stream import LmTrainStream
from benchmark.reference import gpt as ref_gpt
from benchmark.trace import Profiled


def _gpt_config(cfg: dict, gpt):
    return gpt.GPTConfig(
        vocab_size=cfg["vocab_size"], n_layers=cfg["n_layers"],
        d_model=cfg["d_model"], n_heads=cfg["n_heads"], d_ff=cfg["d_ff"],
        max_seq_len=cfg["max_seq_len"],
        compute_dtype=getattr(torch, cfg["compute_dtype"]),
        param_dtype=getattr(torch, cfg["param_dtype"]),
        remat=bool(cfg["remat"]))


class _Recorder:
    """What the checks read from the one trained object, and the window's
    clock, kept at the report boundaries."""

    def __init__(self, run, mix: dict) -> None:
        self.run = run
        self.unit = int(mix["scheduling_unit"])
        self.warmup = int(mix["warmup_steps"])
        self.checked = int(mix["checked_steps"])
        self.losses: List[torch.Tensor] = []
        self.first_mu: Optional[List[torch.Tensor]] = None
        self.change: Optional[List[torch.Tensor]] = None
        self.t_open = self.t_close = 0.0
        self.b_open = self.b_close = 0
        self.phase = "warmup"
        self.memory_peak = 0
        self.profiled = Profiled() if run.trace else None

    # -- the optimizer as the trial declares it, watched ------------------
    def watch(self, inner, optim):
        rec = self

        def adam_state(state):
            if isinstance(state, optim.AdamState):
                return state
            if isinstance(state, tuple):
                for s in state:
                    found = adam_state(s)
                    if found is not None:
                        return found
            return None

        def transform(u, state, p):
            adam = adam_state(state)
            if adam.count == 1 and rec.first_mu is None:
                rec.first_mu = torch._foreach_norm(optim.leaves(adam.mu))
            if adam.count == rec.checked and rec.change is None:
                rec.change = [
                    torch.linalg.vector_norm(
                        t.detach() - weights.make_leaf(
                            rec.run.cfg, rec.run.seed, i, t.device))
                    for i, t in enumerate(p)]
            return inner.transform(u, state, p)

        return optim.Optimizer(inner.init, transform)

    def note_loss(self, loss: torch.Tensor) -> None:
        if len(self.losses) < self.checked:
            self.losses.append(loss.detach().float().clone())

    # -- report boundaries --------------------------------------------------
    def on_report(self, steps: int) -> None:
        now = time.perf_counter()
        if self.phase == "warmup" and steps >= self.warmup:
            if self.profiled is not None:
                self.profiled.warm()
                now = time.perf_counter()
            self.run.mark_setup_done(now)
            self.t_open, self.b_open, self.phase = now, steps, "window"
        elif self.phase == "window" and now - self.t_open >= self.run.seconds:
            self.t_close, self.b_close = now, steps
            self.memory_peak = self.run.memory_peak()
            self.phase = "done"
            if self.profiled is not None:
                self.profiled.start()
                self.phase = "trace"
        elif self.phase == "trace":
            self.profiled.stop()
            self.phase = "done"

    def next_target(self, done: int) -> Optional[int]:
        if self.phase == "done":
            return None
        if self.phase == "warmup":
            return self.warmup
        return done + self.unit


def run(run) -> Dict:
    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.config.experiment import ExperimentConfig
    from determined_clone_tpu_torch.models import gpt
    from determined_clone_tpu_torch.training import (
        TorchTrial,
        Trainer,
        TrialContext,
        optim,
    )

    cfg, mix, dev = run.cfg, run.mix, run.device
    gcfg = _gpt_config(cfg, gpt)
    stream = LmTrainStream(mix, cfg, run.seed)
    rec = _Recorder(run, mix)
    params = weights.make_params(cfg, run.seed, dev)
    opt = cfg["optimizer"]

    class BenchTrial(TorchTrial):
        def initial_params(self, gen):
            return params

        def optimizer(self):
            return rec.watch(optim.chain(
                optim.clip_by_global_norm(opt["clip_global_norm"]),
                optim.adamw(opt["lr"], b1=opt["b1"], b2=opt["b2"],
                            eps=opt["eps"],
                            weight_decay=opt["weight_decay"])), optim)

        def loss(self, p, batch, seed):
            loss = gpt.loss_fn(p, gcfg, batch[:, :-1], batch[:, 1:])
            rec.note_loss(loss)
            return loss, {}

        def training_data(self):
            return iter(stream)

    class Reports(core.MetricsBackend):
        def report(self, group, steps_completed, metrics):
            if group == "training":
                rec.on_report(int(steps_completed))

    class Window(core.SearcherOperationSource):
        def operations(self, is_chief):
            done = 0
            while True:
                target = rec.next_target(done)
                if target is None:
                    return
                yield core.SearcherOperation(target, is_chief=is_chief)
                done = target

    config = ExperimentConfig.from_dict({
        "searcher": {"name": "single", "metric": "loss",
                     "max_length": {"batches": 1}},
        "scheduling_unit": rec.unit,
        "checkpoint_policy": "none",
        "optimizations": {"prefetch_depth": int(mix["prefetch_depth"]),
                          "steps_per_dispatch":
                              int(mix["steps_per_dispatch"])},
    })
    with core.init(config=config, metrics_backend=Reports(),
                   searcher_source=Window()) as ctx:
        trial = BenchTrial(TrialContext(
            config=config, hparams={"global_batch_size": stream.B},
            core=ctx, device=dev))
        trainer = Trainer(trial)
        trainer.fit()
        del trainer, trial

    steps = rec.b_close - rec.b_open
    seconds = rec.t_close - rec.t_open
    tokens = steps * stream.B * stream.T
    prog = {
        "losses": [float(t) for t in rec.losses],
        "first_grad": [float(t) / (1.0 - opt["b1"]) for t in rec.first_mu],
        "change": [float(t) for t in rec.change],
    }
    del params, rec.losses, rec.first_mu, rec.change
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference(run, stream, len(prog["losses"]))
    return {
        "e2e": {"train_tokens_per_s": tokens / seconds},
        "stats": {"steps": steps, "seconds": seconds, "tokens": tokens,
                  "batch": stream.B, "seq_len": stream.T,
                  "trace_steps": rec.unit},
        "attempted": steps,
        "failed": 0,
        "memory_peak_bytes": rec.memory_peak,
        "profiled": rec.profiled,
        "checks": gaps(prog, ref),
        "program": prog,
        "reference": ref,
    }


def _leaf_gaps(prog: List[float], ref: List[float],
               keep: List[bool]) -> List[float]:
    """The gap of the norms, leaf by leaf, over the larger of the leaf's
    reference norm and the median leaf's, for the kept leaves."""
    med = statistics.median(ref)
    return [abs(p - r) / max(r, med)
            for p, r, k in zip(prog, ref, keep) if k]


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Readings of one side (leaves in the reference's order) against the
    reference's: the first step's loss gap and the worst step's; the
    worst kept leaf's gap of the first clipped gradient's norm and of the
    change's norm. A leaf whose reference gradient is under a thousandth
    of the median leaf's moves by round-off alone and is left out."""
    names = list(ref["first_grad"])
    ref_g = [ref["first_grad"][k] for k in names]
    ref_c = [ref["change"][k] for k in names]
    med = statistics.median(ref_g)
    keep = [g >= 1e-3 * med for g in ref_g]
    as_list = (lambda d: [d[k] for k in names] if isinstance(d, dict)
               else list(d))
    losses = [abs(a - b) for a, b in zip(prog["losses"], ref["losses"])]
    return {
        "loss1_gap": losses[0],
        "loss_gap": max(losses),
        "grad_gap": max(_leaf_gaps(as_list(prog["first_grad"]), ref_g,
                                   keep)),
        "change_gap": max(_leaf_gaps(as_list(prog["change"]), ref_c,
                                     keep)),
    }


def reference(run, stream: LmTrainStream, steps: int, **kw) -> Dict:
    """The plain reference over the run's first ``steps`` batches."""
    return ref_gpt.train_readings(
        run.cfg, run.seed, [stream.batch(i) for i in range(steps)],
        run.device,
        rows_per_block=int(run.mix.get("reference_rows_per_block", 2)), **kw)
