"""The readings a cell's limits are set from, for many seeds in one
process: the program's, the control's (the plain reference computed in
float8 e4m3, the precision below the configuration's bf16, in the
program's place) and, for training, the faults a cell can have.

    python3 -m benchmark.calibrate --workload train-gpt2xl-t1024 \
        --seeds 1,2,3 [--control] [--faults]
    python3 -m benchmark.calibrate --workload serve-gpt2xl-chat \
        --seeds 1,2,3 --seconds 10 [--control]

One JSON line a seed. Training runs each seed's checked steps through
the cell's own driver (a window of one scheduling unit) and reads the
control and the half-batch fault (the reference with half of each
batch, the mean over the rest) against the same reference. A state left
unchanged reads 1 on ``change_gap`` by construction and needs no run.
Serving builds the engine once and swaps each seed's weights in
(``hot_swap``), serves ``--seconds`` of the cell's traffic, and scores
the sampled requests and, with ``--control``, the control's first
choices at the same positions. Needs the card.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import run as brun
from benchmark import spec, weights
from benchmark.drivers import engine_open_loop as eol
from benchmark.drivers import trainer_fit
from benchmark.generators import open_loop_chat
from benchmark.generators.lm_train_stream import LmTrainStream
from benchmark.reference import gpt as ref_gpt


def _run(args, seed: int, seconds: float) -> brun.Run:
    return brun.Run(root=spec.ROOT, bench=spec.load_bench(),
                    workload=args.workload, seed=seed, seconds=seconds,
                    trace=False, device=torch.device("cuda", 0),
                    t0=time.perf_counter())


def training(args, seeds) -> None:
    for seed in seeds:
        run = _run(args, seed, 0.01)
        res = trainer_fit.run(run)
        ref = res["reference"]
        out = {"seed": seed, "program": res["checks"],
               "losses": res["program"]["losses"],
               "ref_losses": ref["losses"], "ref_norms": ref["grad_norms"]}
        del res
        gc.collect()
        torch.cuda.empty_cache()
        stream = LmTrainStream(run.mix, run.cfg, seed)
        n = len(ref["losses"])
        if args.control:
            ctl = trainer_fit.reference(run, stream, n, precision="fp8")
            out["control"] = trainer_fit.gaps(ctl, ref)
            out["control_losses"] = ctl["losses"]
        if args.faults:
            half = trainer_fit.reference(run, stream, n, rows=stream.B // 2)
            out["half_batch"] = trainer_fit.gaps(half, ref)
            out["half_batch_losses"] = half["losses"]
        print(json.dumps(out), flush=True)


def serving(args, seeds) -> None:
    from determined_clone_tpu_torch.serving.engine import ServerOverloaded

    first = _run(args, seeds[0], args.seconds)
    engine = eol.build_engine(first)
    try:
        for seed in seeds:
            run = _run(args, seed, args.seconds)
            new = weights.make_params(run.cfg, seed, run.device)
            engine.hot_swap(new)
            reqs = open_loop_chat.schedule(run.mix, run.cfg, seed,
                                           args.seconds)
            sent = eol._send(engine, reqs, time.monotonic(),
                             ServerOverloaded)
            res = [h.result(120.0) for h, _ in sent]
            del new
            pairs = [(p, r.tokens) for (_, p, _), r in zip(reqs, res)]
            chosen = eol.sample(pairs, seed,
                                int(run.mix["check_min_tokens"]),
                                int(run.mix["check_max_requests"]))
            out = {"seed": seed, "requests": len(reqs),
                   "sampled_tokens": sum(len(t) for _, t in chosen),
                   "program": eol.gap_readings(ref_gpt.served_gaps(
                       run.cfg, seed, chosen, run.device))}
            if args.control:
                out["control"] = eol.gap_readings(ref_gpt.served_gaps(
                    run.cfg, seed, chosen, run.device, control=True))
            gc.collect()
            torch.cuda.empty_cache()
            print(json.dumps(out), flush=True)
    finally:
        engine.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    driver = spec.mix(spec.cell(spec.load_bench(),
                                args.workload)["traffic"])["driver"]
    (training if driver == "trainer_fit" else serving)(args, seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
