"""Open-loop serving through the port's ``InferenceEngine``, in process.

The engine is built from the mix's ``serving`` block and the seed's
weights, and ``warmup()`` readies its whole program ladder as CUDA graphs
(that is set-up). Then the requests of the schedule are submitted at
their due times, whatever the engine's state, and each is timed from
when it was due: its time to first token is the sender's lateness plus
``total_s - decode_s`` (the first token comes out of the prefill). A
refused or failed request counts as later than every served one. After
the last request due in the window, every one of them is awaited (up to
``drain_timeout_s``). With ``trace``, once the engine has drained, the
profiler starts and another ``trace_extra_s`` of the mix's arrivals is
sent and awaited before it stops, so that the profiler is switched on
and off only while the engine's scheduler thread launches nothing;
those requests are served but counted in no end-to-end metric.

The check: a sample of the finished requests, drawn from the seed with
the longest among them, is scored by the plain reference over each
prompt and its served tokens; the number compared is the widest gap by
which a served token's logit lies below the reference's best.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import flops, weights
from benchmark.drivers.trainer_fit import _gpt_config
from benchmark.generators import open_loop_chat
from benchmark.reference import gpt as ref_gpt
from benchmark.trace import Profiled


def _pct(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def _send(engine, requests, t_start: float, ServerOverloaded, probe=None):
    """Submit each request at its due time; (handle or None, lateness).
    ``probe``, if given, is called after each submission."""
    sent = []
    for due, prompt, n in requests:
        wait = t_start + due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        late = time.monotonic() - (t_start + due)
        try:
            sent.append((engine.submit(prompt, n), late))
        except (ServerOverloaded, ValueError, RuntimeError):
            sent.append((None, late))
        if probe is not None:
            probe()
    return sent


def _await(sent, timeout_s: float):
    """(result or None, lateness) of each sent request, all awaited
    until ``timeout_s`` from now; a request that fails is None."""
    deadline = time.monotonic() + timeout_s
    out = []
    for handle, late in sent:
        res = None
        if handle is not None:
            try:
                res = handle.result(max(0.0, deadline - time.monotonic()))
            except Exception:  # noqa: BLE001 - a failed request
                res = None
        out.append((res, late))
    return out


def build_engine(run, params=None):
    """The engine of the mix's ``serving`` block over the seed's weights,
    its program ladder warmed up (CUDA graphs on the card)."""
    from determined_clone_tpu_torch.config.experiment import ServingConfig
    from determined_clone_tpu_torch.models import gpt
    from determined_clone_tpu_torch.serving.engine import InferenceEngine

    gcfg = _gpt_config(run.cfg, gpt)
    scfg = ServingConfig.from_dict(dict(run.mix["serving"]))
    if params is None:
        params = weights.make_params(run.cfg, run.seed, run.device)
    engine = InferenceEngine.from_serving_config(params, gcfg, scfg,
                                                 device=run.device)
    del params
    engine.warmup()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    return engine


def run(run) -> Dict:
    from determined_clone_tpu_torch.serving.engine import ServerOverloaded

    cfg, mix, dev = run.cfg, run.mix, run.device
    window = open_loop_chat.schedule(mix, cfg, run.seed, run.seconds)
    extra = (open_loop_chat.schedule(mix, cfg, run.seed,
                                     float(mix["trace_extra_s"]), stream=1)
             if run.trace else [])
    drain_s = float(mix["drain_timeout_s"])
    engine = build_engine(run)
    profiled = Profiled() if run.trace else None
    try:
        if profiled is not None:
            profiled.warm()
        run.mark_setup_done(time.perf_counter())
        t_start = time.monotonic()
        results = _await(_send(engine, window, t_start, ServerOverloaded),
                         drain_s)
        memory_peak = run.memory_peak()
        if profiled is not None:
            profiled.start()
            results += _await(_send(engine, extra, time.monotonic(),
                                    ServerOverloaded), drain_s)
            profiled.stop()
        h = engine.registry
        busy = (h.histogram("serving_prefill_seconds").sum
                + h.histogram("serving_decode_step_seconds").sum)
    finally:
        engine.close()
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    n_win = len(window)
    win = results[:n_win]
    ok = [(r, late, prompt) for (r, late), (_, prompt, _) in zip(win, window)
          if r is not None and r.finish_reason == "length"]
    failed = n_win - len(ok)
    # a request never served is later than any served one can be
    never = run.seconds + float(mix["drain_timeout_s"])
    ttft = [late + r.total_s - r.decode_s for r, late, _ in ok]
    ttft += [never] * failed
    tpot = [r.decode_s / (len(r.tokens) - 1) for r, _, _ in ok
            if len(r.tokens) > 1]
    first_send = t_start + min(due + late for (due, _, _), (_, late)
                               in zip(window, win))
    last_end = max((t_start + due + late + r.total_s
                    for (due, _, _), (r, late) in zip(window, win)
                    if r is not None), default=float("nan"))
    out_tokens = sum(len(r.tokens) for r, _, _ in ok)
    served = [(prompt, r.tokens) for (r, _), (_, prompt, _)
              in zip(results, window + extra)
              if r is not None and r.finish_reason == "length"]
    model_flops = sum(flops.gpt_request_flops(cfg, len(p), len(t))
                      for p, t in served)
    checks = compare_serving(run, [(p, r.tokens) for r, _, p in ok])
    return {
        "e2e": {
            "serve_ttft_p90_ms": _pct(ttft, 90) * 1e3,
            "serve_tpot_p90_ms": _pct(tpot, 90) * 1e3,
            "serve_tokens_per_s": out_tokens / (last_end - first_send),
        },
        "stats": {
            "requests": n_win,
            "queue_wait_s": [r.queue_wait_s for r, _, _ in ok],
            "lateness_p99_ms": _pct([late for _, late in win], 99) * 1e3,
            "model_flops": model_flops,
            "program_seconds": busy,
        },
        "attempted": n_win,
        "failed": failed,
        "memory_peak_bytes": memory_peak,
        "profiled": profiled,
        "checks": checks,
    }


def sample(pairs, seed: int, min_tokens: int, max_requests: int):
    """The request with the most served tokens, then others drawn from
    the seed, until ``min_tokens`` served tokens or ``max_requests``."""
    if not pairs:
        return []
    longest = max(range(len(pairs)), key=lambda i: len(pairs[i][1]))
    rest = [i for i in np.random.default_rng([int(seed), 5]).permutation(
        len(pairs)) if i != longest]
    picked, tokens = [longest], len(pairs[longest][1])
    for i in rest:
        if tokens >= min_tokens or len(picked) >= max_requests:
            break
        picked.append(int(i))
        tokens += len(pairs[i][1])
    return [pairs[i] for i in picked]


def gap_readings(per_request) -> Dict[str, float]:
    """The widest and the mean gap over every scored token."""
    flat = [g for gaps in per_request for g in gaps]
    if not flat:
        return {"logit_gap": float("inf"), "mean_logit_gap": float("inf")}
    return {"logit_gap": max(flat), "mean_logit_gap": sum(flat) / len(flat)}


def compare_serving(run, pairs) -> Dict:
    """The sampled requests' served tokens against the reference."""
    chosen = sample(pairs, run.seed, int(run.mix["check_min_tokens"]),
                    int(run.mix["check_max_requests"]))
    return gap_readings(ref_gpt.served_gaps(run.cfg, run.seed, chosen,
                                            run.device))
