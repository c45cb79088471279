"""Find a serving cell's knee: the highest Poisson rate at which the
engine's queue does not grow over a window.

    python3 -m benchmark.sweep --workload serve-gpt2xl-chat --seed 7 \
        --seconds 20 --rates 8,12,16,20

One engine serves a window of the cell's mix at each rate in turn (the
rate replaced, nothing else), every request awaited before the next
rate. Per rate one JSON line: the queue depth seen at the sends of the
window's first and last thirds, the time the last request finished
after the window's end, and the tails. Needs the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import run as brun
from benchmark import spec
from benchmark.drivers import engine_open_loop as eol
from benchmark.generators import open_loop_chat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from determined_clone_tpu_torch.serving.engine import ServerOverloaded

    run = brun.Run(root=spec.ROOT, bench=spec.load_bench(),
                   workload=args.workload, seed=args.seed,
                   seconds=args.seconds, trace=False,
                   device=torch.device("cuda", 0))
    engine = eol.build_engine(run)
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            mix = dict(run.mix, rate_per_s=rate)
            reqs = open_loop_chat.schedule(mix, run.cfg, args.seed + i,
                                           args.seconds)
            depth = []
            t0 = time.monotonic()
            sent = eol._send(engine, reqs, t0, ServerOverloaded,
                             probe=lambda: depth.append(
                                 engine.stats().queue_depth))
            res = [(h.result(120.0) if h is not None else None, late)
                   for h, late in sent]
            ok = [(r, late) for r, late in res if r is not None]
            third = max(1, len(depth) // 3)
            ends = [t0 + due + late + r.total_s
                    for (due, _, _), (r, late) in zip(reqs, res)
                    if r is not None]
            print(json.dumps({
                "rate": rate, "requests": len(reqs), "served": len(ok),
                "queue_first_third": float(np.mean(depth[:third])),
                "queue_last_third": float(np.mean(depth[-third:])),
                "finish_after_window_s": max(ends) - (t0 + args.seconds),
                "ttft_p50_ms": 1e3 * float(np.percentile(
                    [late + r.total_s - r.decode_s for r, late in ok], 50)),
                "ttft_p95_ms": 1e3 * float(np.percentile(
                    [late + r.total_s - r.decode_s for r, late in ok], 95)),
                "tpot_p95_ms": 1e3 * float(np.percentile(
                    [r.decode_s / (len(r.tokens) - 1) for r, _ in ok], 95)),
                "tokens_per_s": sum(len(r.tokens) for r, _ in ok)
                / (max(ends) - t0),
            }), flush=True)
    finally:
        engine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
