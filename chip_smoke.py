#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card, end to end.

    python3 chip_smoke.py           # everything below
    python3 chip_smoke.py --quick   # phases 1-2 only, each case once, untimed

Phases, each of which fails the run (non-zero exit) if it fails:

1. build the CUDA kernels from ``determined_clone_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and print the build time
   and ptxas' register/spill report;
2. hold each kernel against its plain PyTorch version on the card, at the
   GPT shapes (in bf16 and in fp32) and at small ones: within 1e-4 in
   fp32, and in bf16 within the reference's 0.05 and, element by element,
   within two bf16 ulps of the plain version's value (``BF16_REL``); time
   kernel, plain version and the PyTorch library call that computes the
   same function (timed here only; the port never calls it) on the device,
   by replaying a CUDA graph of 20 calls (``device_ms``), time the
   kernel's calls back to back from the host as well (``call_ms``: the
   wrapper's Python included), and report each case's share of its bound
   (``bound_ms / kernel_ms``);
3. run the uncached GPT forward at full width (``GPTConfig()``, random
   weights from a seed), at T=1024 and at a ragged T=1000 that the kernel
   takes unpadded, and check that the flash kernel ran once per layer and
   that the logits agree with the plain-attention forward within
   ``LOGITS_TOL``;
4. serve 8 requests through the continuous-batching engine at full width
   and check every token against a greedy loop over the port's
   plain-attention forward (fp32: every token equal; bf16: at most
   ``BF16_MAX_TIES`` near ties), and that every KV block comes back;
5. profile one full-width forward and the engine's 8 requests
   (``torch.profiler``; tables in ``smoke_out/chip_profile.txt``);
6. training: (a) the attention gradient — the flash kernel's forward
   with the blockwise recompute backward (``FlashAttentionFunction``)
   against autograd through ``mha`` on the same inputs in fp32, at
   B=4, T=1024, H=12, D=64 causal in fp32 and bf16 and at a ragged
   T=1000 in bf16, output, dq, dk and dv each within ``GRAD_TOL``; (b)
   32 AdamW steps (``bench.py``'s optimizer) of ``GPTConfig()`` at B=8,
   T=1024 on one seeded batch: every loss finite, the first near
   ln(vocab) and the last below it by ``MIN_LOSS_DROP``, the flash kernel
   launched ``2 * n_layers`` times per step (remat recomputes each
   block's forward), ms/step, tokens/s, MFU, peak memory, the device's
   busy share over one profiled step; and one step through flash and
   one through ``mha`` from the same weights agreeing within
   ``TRAIN_TOL``;
7. the trainer loop: the port's ``GPTTrial``
   (``determined_clone_tpu_torch/examples/gpt_fsdp.py``) at
   ``examples/gpt_fsdp/fsdp.yaml``'s hyperparameters on one card, through
   ``core.init(config=...)`` → ``Trainer(trial).fit()`` with checkpoints
   in a temporary directory: 20 batches (``scheduling_unit`` 10,
   validation and checkpoint periods of 10), then a second ``fit`` that
   restores the last checkpoint and trains to 40. Checks: 20 then 40
   batches trained, training reports at 10, 20, 30, 40 and validation
   reports at 10, 20, 20, 30, 40, 40 (each op ends in a validation);
   every loss finite, the first within 0.5 of ln(vocab); the checkpoint,
   loaded back with ``load_pytree``, equal bit for bit to leg 1's params
   and Adam moments, its step and Adam count 20; the resumed leg's first
   batch equal to batch 21 of the trial's stream (the replay); the first
   batches the CUDA prefetcher hands over, each copy queued behind busy
   work on the side stream and read at once, equal to the host's (the
   stream wait); no ``*prefetch*`` thread alive after either fit; and
   the flash kernel launched
   ``2 * n_layers`` times per trained batch plus ``n_layers`` per eval
   batch over the two legs. Prints each leg's samples/s per chunk beside
   phase 6's bare step, checkpoint save and restore seconds and bytes,
   and 10 batches at ``prefetch_depth`` 0 and 2 with their queue waits;
8. the model families, each through ``core.init`` → ``Trainer.fit`` (or
   the Core API ``main``) with checkpoints in a temporary directory, the
   flash kernel's launch count set to 0 before and read after (they
   attend through plain ``mha``, as in the JAX package: no launch): (a)
   BASELINE #1, ``MnistTrial`` at ``examples/mnist/const.yaml`` read with
   ``ExperimentConfig.from_yaml``, 400 batches, best validation accuracy
   above ``MNIST_GATE``; (b) BASELINE #3, ``ResNetTrial`` at
   ``examples/resnet50/distributed.yaml`` cut to one card
   (``resnet_config``), 20 batches: every loss finite, the first within
   1.0 of the initial logits' chance-level loss, one bf16 and one fp32
   step from the same weights within ``BF16_STEP_REL``; bare steps timed,
   one profiled (busy share, top kernels), peak memory; (c) BASELINE #4,
   the BERT fine-tune's ``main`` at bert-base widths (seq 128, batch 32,
   bf16), preempted at 30 through a ``FilePreemptionSource`` and resumed
   from its checkpoint to 60: the preemption, reports at 40, 50, 60, the
   ``state.pkl`` arrays numpy fp32 under ``bert.init``'s tree, finite
   losses, a bf16 and an fp32 step within ``BF16_STEP_REL``; (d)
   ViT-S/16 (the hub's ``ViTClassificationTrial``) and the detector at
   ``DetectorConfig()``, 10 batches each, every loss finite. Prints each
   trial's samples/s and ms/step per report.

fp32 matrix products run in full fp32 throughout (TF32 off), the
training phases included. The launch count in each kernel's entry is
that of phase 3, the uncached forward (the engine's paged forward
attends with plain ``mha``, as in the JAX package); ``train_launches``
is that of phase 6's 32 steps and ``trial_launches`` that of phase 7's
two legs; phase 8 launches none. The last three lines are the kernels' JSON line, the card's
name and power limit, and the result. Details go to
``smoke_out/chip_smoke.json``. Exits non-zero, printing no result, when
CUDA is unavailable.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12              # H100 SXM data sheet
# dense tensor-core peaks: the kernel runs bf16 on them, and fp32 as three
# TF32 products, so TF32's rate bounds fp32 inputs
PEAK_OPS_PER_S = {"torch.bfloat16": 989e12,
                  "torch.float32": 495e12}
TOL = {"torch.float32": 1e-4, "torch.bfloat16": 0.05}
# bf16 output: the kernel and the plain version both round an fp32 result
# once, so they may differ by a rounding step of the value: per element
# |out - ref| <= BF16_REL * |ref| + BF16_ABS (two ulps, 2**-6, plus a floor
# for values near zero, far below the ~0.06 typical output at T=1024)
BF16_REL, BF16_ABS = 2.0 ** -6, 1e-4
# flash vs plain-attention forward at full width: the logits' spread is
# ~0.5, bf16 rounding moves them by ~0.03 (PERF.md)
LOGITS_TOL = 0.1
# engine vs the greedy loop over the uncached forward, in bf16: a step may
# pick another token only at a near tie, this close, and this often
BF16_TIE_GAP, BF16_MAX_TIES = 0.1, 2
# attention gradient against autograd through mha on the fp32 values of
# the same inputs: fp32 runs the same fp32 math summed in another order
# (~1e-6 of the largest value expected), so within 1e-4 of it; in bf16
# the forward and the fp32 recompute round once to bf16 at the end, so
# per element within BF16_REL·|ref| plus 1e-4 of the largest value (the
# floor for elements near zero)
GRAD_TOL = {"torch.float32": (0.0, 1e-4), "torch.bfloat16": (BF16_REL, 1e-4)}
# one train step through flash and through mha from the same weights, in
# bf16: the two attentions round at different places (fp32 probabilities
# in the kernel, bf16 in mha), which moves the mean loss by ~1e-4 and
# grad_norm by a few 1e-4 relative (PERF.md); the largest update is
# Adam's first-step bound on both sides
TRAIN_TOL = {"loss": 2e-3, "grad_norm_rel": 5e-3, "max_update_rel": 0.01}
MIN_LOSS_DROP = 1.0  # 32 steps on one batch: it memorises
REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "smoke_out")


def log(*args) -> None:
    print(*args, flush=True)


def phase_build() -> dict:
    from determined_clone_tpu_torch.ops import _build

    t0 = time.monotonic()
    records = _build.build_all()
    wall = time.monotonic() - t0
    for r in records:
        log(f"[build] {r.name}: {r.seconds:.2f} s")
        for line in r.ptxas.splitlines():
            if "sm_90a" in line or "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels: {wall:.2f} s wall")
    return {"seconds": wall, "kernels": {r.name: r.seconds for r in records}}


def attention_bound(B, Tq, Tk, H, D, dtype, causal) -> tuple:
    """(bound_ms, bound_by): q, k, v read once and o written once over HBM
    bandwidth, against the score and value products this input needs
    (only the causal pairs when causal) over the dtype's peak."""
    import torch

    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * B * Tq * H * D + 2 * B * Tk * H * D) * item
    pairs = (sum(min(i + 1, Tk) for i in range(Tq)) if causal
             else Tq * Tk)
    ops = 4 * B * H * pairs * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(timed: bool = True) -> list:
    import torch
    import torch.nn.functional as F

    from determined_clone_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_reference,
    )
    from determined_clone_tpu_torch.timing import (
        call_ms,
        device_ms,
        warm_clocks,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    if timed:
        warm_clocks()
    # (name, B, Tq, Tk, H, D, dtype, causal, block)
    cases = [
        ("gpt_width_bf16_causal", 4, 1024, 1024, 12, 64, torch.bfloat16,
         True, 128),
        ("gpt_width_fp32_causal", 4, 1024, 1024, 12, 64, torch.float32,
         True, 128),
        ("fp32_causal_t256", 2, 256, 256, 4, 64, torch.float32, True, 64),
        ("fp32_noncausal_t256", 2, 256, 256, 4, 64, torch.float32, False,
         64),
        ("fp32_uneven_tq192_tk320", 2, 192, 320, 3, 32, torch.float32,
         True, 64),
        ("fp32_d16", 2, 128, 128, 2, 16, torch.float32, True, 32),
        ("bf16_d128_noncausal", 1, 512, 512, 4, 128, torch.bfloat16, False,
         128),
        ("bf16_causal_t1000_ragged", 4, 1000, 1000, 12, 64, torch.bfloat16,
         True, 200),
        ("bf16_causal_d16", 4, 1024, 1024, 12, 16, torch.bfloat16, True,
         128),
        ("bf16_causal_d32", 4, 1024, 1024, 12, 32, torch.bfloat16, True,
         128),
        ("gpt_width_bf16_noncausal", 4, 1024, 1024, 12, 64, torch.bfloat16,
         False, 128),
        ("bf16_causal_t2048", 2, 2048, 2048, 12, 64, torch.bfloat16, True,
         128),
    ]
    results = []
    for name, B, Tq, Tk, H, D, dtype, causal, blk in cases:
        q = torch.randn((B, Tq, H, D), generator=gen, device="cuda",
                        dtype=dtype)
        # k and v as strided views of one fused tensor, as the GPT block
        # hands them over from its qkv projection
        kv = torch.randn((B, Tk, 2 * H * D), generator=gen, device="cuda",
                         dtype=dtype)
        k = kv[..., :H * D].reshape(B, Tk, H, D)
        v = kv[..., H * D:].reshape(B, Tk, H, D)
        out = flash_attention(q, k, v, causal=causal, block_q=blk,
                              block_k=blk)
        ref = flash_attention_reference(q, k, v, causal=causal, block_q=blk,
                                        block_k=blk)
        torch.cuda.synchronize()
        if out.shape != q.shape or out.dtype != dtype:
            raise AssertionError(f"{name}: output {out.shape} {out.dtype}")
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        tol = TOL[str(dtype)]
        if not err <= tol:
            raise AssertionError(f"{name}: max abs err {err} > {tol}")
        # share of the per-element bound used, at the worst element
        rel_used = None
        if dtype == torch.bfloat16:
            bound = BF16_REL * ref.float().abs() + BF16_ABS
            rel_used = (diff / bound).max().item()
            if not rel_used <= 1.0:
                raise AssertionError(
                    f"{name}: an element differs by more than two bf16 ulps "
                    f"({rel_used:.3g} of the bound)")
        rel = "" if rel_used is None else f", {rel_used:.3g} of ulp bound"
        row = {"case": name, "shape": [B, Tq, Tk, H, D],
               "dtype": str(dtype), "causal": causal, "max_abs_err": err,
               "tol": tol, "bf16_bound_used": rel_used}
        results.append(row)
        if not timed:
            log(f"[kernel] {name}: err {err:.3g} (tol {tol}{rel})")
            continue
        def kernel():
            return flash_attention(q, k, v, causal=causal, block_q=blk,
                                   block_k=blk)

        kernel_ms = device_ms(kernel)
        kernel_call_ms = call_ms(kernel)
        plain_ms = device_ms(lambda: flash_attention_reference(
            q, k, v, causal=causal, block_q=blk, block_k=blk), iters=2,
            replays=2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        bound_ms, bound_by = attention_bound(B, Tq, Tk, H, D, dtype, causal)
        row.update({"kernel_ms": kernel_ms, "call_ms": kernel_call_ms,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_share": bound_ms / kernel_ms})
        log(f"[kernel] {name}: err {err:.3g} (tol {tol}{rel}) kernel "
            f"{kernel_ms:.4f} ms (call {kernel_call_ms:.4f} ms) plain "
            f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by}), "
            f"{bound_ms / kernel_ms:.3f} of bound")
    return results


def drive_forward(params, cfg, B, T, reps, seed) -> dict:
    """``reps`` uncached forwards at [B, T] through the flash kernel, with
    its launch count set to 0 just before and read just after; then the
    plain-attention forward on the same tokens, and the logits held
    against it."""
    import torch

    from determined_clone_tpu_torch.models import gpt
    from determined_clone_tpu_torch.ops.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           device="cuda")
    if gpt.resolved_attention_impl(cfg, tokens.device) != "flash":
        raise AssertionError("auto attention did not resolve to flash")
    with torch.no_grad():
        flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(reps):
            logits = gpt.apply(params, cfg, tokens)
        torch.cuda.synchronize()
        fwd_s = (time.monotonic() - t0) / reps
        launches = flash_attention.launches
        if launches != reps * cfg.n_layers:
            raise AssertionError(f"flash launched {launches} times in {reps} "
                                 f"forwards of {cfg.n_layers} layers")
        ref = gpt.apply(params, dataclasses.replace(cfg, attention_impl="mha"),
                        tokens)
    if logits.shape != (B, T, cfg.vocab_size) or logits.dtype != torch.float32:
        raise AssertionError(f"logits {tuple(logits.shape)} {logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    diff = (logits - ref).abs().max().item()
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"[forward] GPTConfig() B={B} T={T}: {fwd_s * 1e3:.2f} ms/forward, "
        f"flash launches {launches} ({cfg.n_layers} per forward), logits "
        f"max |flash - mha| {diff:.4g}, argmax agreement {agree:.5f}")
    # bf16 activations through 12 layers: the two attentions round at
    # different places (fp32 probabilities in the kernel, bf16 in mha).
    # Random weights leave many near-tied logits, so the argmax agreement
    # is reported, and the bound is on the logits themselves.
    if not diff <= LOGITS_TOL:
        raise AssertionError(f"flash forward logits differ from mha by "
                             f"{diff} > {LOGITS_TOL}")
    return {"batch": B, "seq": T, "forward_ms": fwd_s * 1e3,
            "launches": launches, "forwards": reps,
            "max_abs_diff_vs_mha": diff, "argmax_agreement_vs_mha": agree}


def phase_forward(params, cfg) -> dict:
    import torch

    from determined_clone_tpu_torch.models import gpt

    with torch.no_grad():  # first call: cuBLAS, lazy modules
        gpt.apply(params, cfg, torch.zeros((4, 1024), dtype=torch.long,
                                           device="cuda"))
    main = drive_forward(params, cfg, B=4, T=1024, reps=3, seed=1)
    # T not a multiple of the kernel's 64-row tile, handed over unpadded
    main["ragged"] = drive_forward(params, cfg, B=2, T=1000, reps=1, seed=2)
    return main


def serve(params, cfg, prompts, new):
    """All prompts through one engine at once; returns the results, the
    wall time from first submit to last token, and the final stats."""
    from determined_clone_tpu_torch.serving import BucketSpec, InferenceEngine

    with InferenceEngine(params, cfg,
                         buckets=BucketSpec.build(8, 256)) as eng:
        eng.generate([1, 2, 3], 2)  # first calls: cuBLAS handles, allocator
        t0 = time.monotonic()
        handles = [eng.submit(p, new, request_id=str(i))
                   for i, p in enumerate(prompts)]
        results = [h.result(timeout=600) for h in handles]
        wall = time.monotonic() - t0
        eng.wait_idle()
        stats = eng.stats()
        pool = eng.cache.num_blocks
    for r in results:
        if r.finish_reason != "length" or len(r.tokens) != new:
            raise AssertionError(f"request {r.request_id}: {r.finish_reason} "
                                 f"with {len(r.tokens)} tokens")
    if stats.completed != len(prompts) + 1 or stats.free_blocks != pool:
        raise AssertionError(f"engine stats {stats} (pool {pool})")
    return results, wall, stats


def check_greedy(params, cfg, prompts, results, tie_tol=0.0,
                 max_ties=0) -> dict:
    """The reference's pin, step by step: at every generated position the
    full uncached forward (plain attention) over the prompt and the
    engine's tokens so far must pick the engine's token. Where every
    step agrees this IS the greedy loop over ``apply``. With ``max_ties``
    above 0, up to that many steps may pick another token at a near tie —
    the engine's token within ``tie_tol`` of the best logit — since the
    paged and uncached forwards run different matrix shapes, whose bf16
    sums the card orders differently."""
    import torch

    from determined_clone_tpu_torch.models import gpt

    mha_cfg = dataclasses.replace(cfg, attention_impl="mha")
    exact = ties = 0
    worst = 0.0
    with torch.no_grad():
        for p, r in zip(prompts, results):
            toks = list(p)
            for t in r.tokens:
                logits = gpt.apply(params, mha_cfg,
                                   torch.tensor([toks], device="cuda"))[0, -1]
                best = int(logits.argmax())
                if best == t:
                    exact += 1
                else:
                    margin = float(logits[best] - logits[t])
                    if not margin <= tie_tol:
                        raise AssertionError(
                            f"request {r.request_id} step {len(toks) - len(p)}"
                            f": engine token {t}, greedy {best}, logit gap "
                            f"{margin} > {tie_tol}")
                    ties += 1
                    worst = max(worst, margin)
                    if ties > max_ties:
                        raise AssertionError(
                            f"{ties} steps differ from the greedy loop at "
                            f"near ties, more than {max_ties}")
                toks.append(t)
    return {"exact": exact, "near_ties": ties, "worst_tie_gap": worst,
            "tie_tol": tie_tol}


def greedy_loop(params, cfg, prompt, n):
    """Free-running greedy decode over the uncached forward."""
    import torch

    from determined_clone_tpu_torch.models import gpt

    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = gpt.apply(params, cfg, torch.tensor([toks],
                                                         device="cuda"))
            toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


def phase_engine(params, cfg) -> dict:
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    lengths = [16, 40, 64, 90, 120, 150, 180, 200]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    new = 32
    results, wall, stats = serve(params, cfg, prompts, new)
    tokens = sum(len(r.tokens) for r in results)
    lat = sorted(r.total_s for r in results)
    p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
    log(f"[engine] 8 requests, prompts {lengths[0]}-{lengths[-1]}, {new} new "
        f"tokens each: {tokens / wall:.1f} tokens/s, p50 {p50 * 1e3:.1f} ms, "
        f"p99 {p99 * 1e3:.1f} ms, free blocks {stats.free_blocks} (all)")
    pin = check_greedy(params, cfg, prompts, results, tie_tol=BF16_TIE_GAP,
                       max_ties=BF16_MAX_TIES)
    log(f"[engine] bf16 vs the mha greedy loop: {pin['exact']}/{tokens} "
        f"steps exact, {pin['near_ties']} near ties (worst gap "
        f"{pin['worst_tie_gap']:.4g})")
    same = 0
    for p, r in zip(prompts, results):
        flash_tokens = greedy_loop(params, cfg, p, new)
        same += sum(a == b for a, b in zip(r.tokens, flash_tokens))
    log(f"[engine] agreement with the flash greedy loop: {same / tokens:.4f} "
        f"({same}/{tokens} tokens)")

    # the same pin in fp32, token for token
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    results32, _, _ = serve(params, cfg32, prompts, new)
    pin32 = check_greedy(params, cfg32, prompts, results32)
    log(f"[engine] fp32 vs the mha greedy loop: {pin32['exact']}/{tokens} "
        f"steps equal")
    return {"requests": len(prompts), "prompt_lengths": lengths,
            "new_tokens": new, "wall_s": wall, "tokens_per_s": tokens / wall,
            "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3,
            "latencies_s": lat, "free_blocks": stats.free_blocks,
            "pin_bf16": pin, "pin_fp32": pin32,
            "flash_greedy_agreement": same / tokens}


def profile_window(fn, label, out_lines, op_keys=()) -> dict:
    """Run ``fn`` under torch.profiler; the device time of its kernels,
    summed (one stream, so no two overlap), and the top kernels. Only
    kernel rows count: an operator's row repeats its kernels' time. With
    ``op_keys``, also the device time of those operators' own kernels
    (``ops_ms``). Appends the full table to ``out_lines``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total_us = sum(e.self_device_time_total for e in kernels)
    out_lines += [f"== {label}: kernel time {total_us / 1e3:.3f} ms",
                  averages.table(sort_by="self_device_time_total",
                                 row_limit=30)]
    top = [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
            "calls": e.count} for e in kernels[:8]]
    out = {"device_ms": total_us / 1e3, "top": top}
    if op_keys:
        out["ops_ms"] = {e.key: e.self_device_time_total / 1e3
                         for e in averages if e.key in op_keys}
    return out


def phase_profile(params, cfg, engine_wall_s) -> dict:
    """Where the time goes: one full-width forward, and the engine serving
    the 8 requests again. Device busy share = profiled kernel time over
    the unprofiled wall time of the same work."""
    import numpy as np
    import torch

    from determined_clone_tpu_torch.models import gpt

    lines: list = []
    tokens = torch.randint(0, cfg.vocab_size, (4, 1024), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    with torch.no_grad():
        fwd = profile_window(lambda: gpt.apply(params, cfg, tokens),
                             "forward B=4 T=1024", lines)
    rng = np.random.default_rng(0)
    lengths = [16, 40, 64, 90, 120, 150, 180, 200]
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    eng = profile_window(lambda: serve(params, cfg, prompts, 32),
                         "engine, 8 requests", lines)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_profile.txt"), "w") as f:
        f.write("\n".join(lines))
    eng["busy_share"] = eng["device_ms"] / 1e3 / engine_wall_s
    for label, r in (("forward", fwd), ("engine", eng)):
        top = ", ".join(f"{t['name'][:40]} {t['ms']:.2f} ms x{t['calls']}"
                        for t in r["top"][:5])
        log(f"[profile] {label}: device {r['device_ms']:.2f} ms; {top}")
    log(f"[profile] engine device busy share {eng['busy_share']:.3f} of "
        f"{engine_wall_s * 1e3:.1f} ms unprofiled wall")
    return {"forward": fwd, "engine": eng}


def attention_grad_case(name, B, T, H, D, dtype, gen) -> dict:
    """The flash Function's output and gradients against autograd through
    ``mha`` on the fp32 values of the same inputs (and, for scale, bf16
    ``mha``'s own error); fwd+bwd times of the Function, of ``mha`` and
    of the library's fused attention."""
    import torch
    import torch.nn.functional as F

    from determined_clone_tpu_torch.ops.attention import mha
    from determined_clone_tpu_torch.ops.flash_attention import (
        flash_attention_kernel,
    )
    from determined_clone_tpu_torch.timing import call_ms

    q = torch.randn((B, T, H, D), generator=gen, device="cuda", dtype=dtype)
    kv = torch.randn((B, T, 2 * H * D), generator=gen, device="cuda",
                     dtype=dtype)
    g = torch.randn((B, T, H, D), generator=gen, device="cuda", dtype=dtype)

    def run(attn, q, kv, g):
        q, kv = q.detach().requires_grad_(), kv.detach().requires_grad_()
        # k and v as strided views of one fused tensor, as in the GPT block
        k = kv[..., :H * D].reshape(B, T, H, D)
        v = kv[..., H * D:].reshape(B, T, H, D)
        out = attn(q, k, v)
        dq, dkv = torch.autograd.grad(out, (q, kv), g)
        return [out.detach(), dq, dkv[..., :H * D].reshape(B, T, H, D),
                dkv[..., H * D:].reshape(B, T, H, D)]

    def flash(q, k, v):
        return flash_attention_kernel(q, k, v, causal=True)

    def plain(q, k, v):
        return mha(q, k, v, causal=True)

    got = run(flash, q, kv, g)
    ref = run(plain, q.float(), kv.float(), g.float())
    same_dtype = run(plain, q, kv, g)
    torch.cuda.synchronize()
    rel, floor = GRAD_TOL[str(dtype)]
    row = {"case": name, "shape": [B, T, H, D], "dtype": str(dtype)}
    for label, a, b, c in zip(("out", "dq", "dk", "dv"), got, ref,
                              same_dtype):
        if a.shape != b.shape or a.dtype != dtype:
            raise AssertionError(f"{name} {label}: {a.shape} {a.dtype}")
        diff = (a.float() - b).abs()
        scale = b.abs().max().item()
        used = (diff / (rel * b.abs() + floor * scale)).max().item()
        row[label] = {"max_abs_err": diff.max().item(), "max_abs_ref": scale,
                      "bound_used": used,
                      "mha_same_dtype_err": (c.float() - b).abs().max().item()}
        if not used <= 1.0:
            raise AssertionError(
                f"{name} {label}: max err {diff.max().item():.4g} "
                f"({used:.3g} of the bound; max |ref| {scale:.4g})")
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, kv[..., :H * D].reshape(B, T, H, D),
                            kv[..., H * D:].reshape(B, T, H, D)))
    gt = g.transpose(1, 2)
    row["ms"] = {
        "flash_fwd_bwd": call_ms(lambda: run(flash, q, kv, g), iters=5,
                                 warmup=2),
        "mha_fwd_bwd": call_ms(lambda: run(plain, q, kv, g), iters=5,
                               warmup=2),
        "library_fwd_bwd": call_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
            (qt, kt, vt), gt), iters=5, warmup=2)}
    errs = ", ".join(f"{k} {row[k]['max_abs_err']:.3g} "
                     f"({row[k]['bound_used']:.3g} of bound; mha in "
                     f"{str(dtype)[6:]} {row[k]['mha_same_dtype_err']:.3g})"
                     for k in ("out", "dq", "dk", "dv"))
    ms = row["ms"]
    log(f"[grad] {name}: {errs}; fwd+bwd flash {ms['flash_fwd_bwd']:.3f} "
        f"ms, mha {ms['mha_fwd_bwd']:.3f} ms, library "
        f"{ms['library_fwd_bwd']:.3f} ms")
    return row


def phase_attention_grad() -> list:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(4)
    return [attention_grad_case(*case, gen) for case in (
        ("gpt_width_fp32", 4, 1024, 12, 64, torch.float32),
        ("gpt_width_bf16", 4, 1024, 12, 64, torch.bfloat16),
        ("bf16_t1000_ragged", 4, 1000, 12, 64, torch.bfloat16))]


def train_setup(cfg, params):
    """``bench.py``'s training step: AdamW(3e-4, 0.9, 0.95, wd 0.1), the
    loss on ``b[:, :-1]`` against ``b[:, 1:]``."""
    from determined_clone_tpu_torch.models import gpt
    from determined_clone_tpu_torch.training.optim import adamw
    from determined_clone_tpu_torch.training.train_step import (
        create_train_state,
        make_train_step,
    )

    tx = adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)

    def loss(p, b, seed):
        return gpt.loss_fn(p, cfg, b[:, :-1], b[:, 1:]), {}

    return create_train_state(params, tx, seed=1), make_train_step(loss, tx)


def flash_vs_mha_step(cfg, tokens) -> dict:
    """One step through flash and one through mha from the same weights
    and batch: loss, grad_norm, and the largest parameter change, which
    Adam's first step bounds by lr·(1 + wd·|p|)."""
    import torch

    from determined_clone_tpu_torch.models import gpt
    from determined_clone_tpu_torch.training.optim import leaves, tree_map

    p0 = gpt.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    out = {}
    for impl in ("flash", "mha"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        state, step = train_setup(c, tree_map(torch.clone, p0))
        state, m = step(state, tokens)
        delta = max((p.detach() - q).abs().max().item()
                    for p, q in zip(leaves(state.params), leaves(p0)))
        out[impl] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "max_update": delta, "params": state.params}
    f, m = out["flash"], out["mha"]
    bound = 3e-4 * (1 + 0.1 * max(p.abs().max().item() for p in leaves(p0)))
    apart = max((a.detach() - b.detach()).abs().max().item()
                for a, b in zip(leaves(f.pop("params")),
                                leaves(m.pop("params"))))
    res = {"flash": f, "mha": m, "update_bound": bound,
           "max_param_apart_lr": apart / 3e-4,
           "loss_diff": abs(f["loss"] - m["loss"]),
           "grad_norm_rel": abs(f["grad_norm"] / m["grad_norm"] - 1),
           "max_update_rel": abs(f["max_update"] / m["max_update"] - 1)}
    log(f"[train] flash vs mha, one step from the same weights: loss "
        f"{f['loss']:.6f} vs {m['loss']:.6f}, grad_norm {f['grad_norm']:.6g}"
        f" vs {m['grad_norm']:.6g}, max update {f['max_update']:.4g} vs "
        f"{m['max_update']:.4g} (bound {bound:.4g}), params apart by at "
        f"most {res['max_param_apart_lr']:.3g} lr")
    checks = {"loss": res["loss_diff"], "grad_norm_rel": res["grad_norm_rel"],
              "max_update_rel": res["max_update_rel"]}
    for key, val in checks.items():
        if not val <= TRAIN_TOL[key]:
            raise AssertionError(f"flash vs mha step: {key} {val} > "
                                 f"{TRAIN_TOL[key]}")
    for impl in ("flash", "mha"):
        if not out[impl]["max_update"] <= bound * (1 + 1e-3):
            raise AssertionError(f"{impl} step moved a parameter by "
                                 f"{out[impl]['max_update']} > {bound}")
    return res


def step_breakdown(cfg, state, B, T, lines) -> dict:
    """Device ms of the step's parts, each profiled alone at the step's
    shapes: one layer's attention forward and backward through the flash
    Function (the step runs it ``n_layers`` times, plus one more forward
    launch per layer in the recompute); the head — final layernorm, the
    fp32 tied logits and the cross-entropy, forward and backward; and the
    AdamW update with ``grad_norm`` over the full parameter set."""
    import torch

    from determined_clone_tpu_torch.ops.flash_attention import (
        flash_attention_kernel,
    )
    from determined_clone_tpu_torch.ops.layers import (
        layernorm,
        softmax_cross_entropy,
    )
    from determined_clone_tpu_torch.training.optim import (
        adamw,
        global_norm,
        leaves,
        tree_map,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    H, D, V = cfg.n_heads, cfg.head_dim, cfg.vocab_size
    bf16 = cfg.compute_dtype
    q = torch.randn((B, T, H, D), generator=gen, device="cuda", dtype=bf16,
                    requires_grad=True)
    kv = torch.randn((B, T, 2 * H * D), generator=gen, device="cuda",
                     dtype=bf16, requires_grad=True)
    g = torch.randn((B, T, H, D), generator=gen, device="cuda", dtype=bf16)

    def attention():
        k = kv[..., :H * D].reshape(B, T, H, D)
        v = kv[..., H * D:].reshape(B, T, H, D)
        torch.autograd.grad(flash_attention_kernel(q, k, v), (q, kv), g)

    params = state.params
    x = torch.randn((B, T, cfg.d_model), generator=gen, device="cuda",
                    dtype=bf16, requires_grad=True)
    targets = torch.randint(0, V, (B, T), generator=gen, device="cuda")

    def head():
        h = layernorm(params["final_norm"], x)
        logits = h.float() @ params["embed"]["table"].float().T
        loss = softmax_cross_entropy(logits, targets).mean()
        torch.autograd.grad(loss, (x, params["embed"]["table"]))

    copies = tree_map(lambda t: t.detach().clone(), params)
    grads = tree_map(torch.randn_like, copies)
    tx = adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)
    opt = [tx.init(copies)]

    def update():
        global_norm(leaves(grads))
        opt[0] = tx.update(grads, opt[0], copies)

    parts = {}
    for name, fn in (("attention_layer", attention), ("head", head),
                     ("optimizer", update)):
        fn()  # first call: allocator, cuBLAS
        parts[name] = profile_window(fn, f"part: {name}", lines)["device_ms"]
    return parts


def phase_train() -> dict:
    """32 steps of ``GPTConfig()`` at B=8, T=1024 on one seeded batch:
    2 warm steps, then 3 windows of 10, each ending in a host read of
    the loss; the median window gives ms/step. Then one profiled step,
    and the flash-vs-mha step."""
    import math
    import statistics

    import torch

    from determined_clone_tpu_torch.models import gpt
    from determined_clone_tpu_torch.ops.flash_attention import flash_attention
    from determined_clone_tpu_torch.telemetry import flops

    cfg = gpt.GPTConfig()
    B, T = 8, 1024
    params = gpt.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(3))
    if gpt.resolved_attention_impl(cfg, tokens.device) != "flash":
        raise AssertionError("auto attention did not resolve to flash")
    state, step = train_setup(cfg, params)
    losses, windows = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    for _ in range(2):
        state, m = step(state, tokens)
        losses.append(m["loss"])
    float(m["loss"])
    for _ in range(3):
        t0 = time.monotonic()
        for _ in range(10):
            state, m = step(state, tokens)
            losses.append(m["loss"])
        float(m["loss"])
        windows.append((time.monotonic() - t0) / 10)
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).tolist()
    n = len(losses)
    per_step = 2 * cfg.n_layers if cfg.remat else cfg.n_layers
    if launches != n * per_step:
        raise AssertionError(f"flash launched {launches} times in {n} steps,"
                             f" expected {per_step} per step")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    ln_v = math.log(cfg.vocab_size)
    if not abs(losses[0] - ln_v) <= 0.5:
        raise AssertionError(f"first loss {losses[0]}, ln(vocab) {ln_v}")
    if not losses[-1] <= losses[0] - MIN_LOSS_DROP:
        raise AssertionError(f"loss did not fall: {losses}")
    step_s = statistics.median(windows)
    model_flops = flops.gpt_train_step_flops(cfg, B, T)
    mfu = flops.mfu(model_flops.flops_per_sec(step_s))
    log(f"[train] GPTConfig() B={B} T={T}, AdamW: {step_s * 1e3:.2f} ms/step"
        f" (windows {', '.join(f'{w * 1e3:.2f}' for w in windows)}), "
        f"{B * T / step_s:.0f} tokens/s, {B / step_s:.2f} samples/s, MFU "
        f"{mfu:.4f} of 989 TFLOP/s ({model_flops.total / 1e12:.3f} "
        f"TFLOP/step), peak memory {peak / 2**30:.2f} GiB, flash launches "
        f"{launches} ({launches // n} per step)")
    log(f"[train] loss: first {losses[0]:.4f} (ln vocab {ln_v:.4f}), last "
        f"{losses[-1]:.4f} after {n} steps")

    box = [state]

    def one_step():
        box[0], _ = step(box[0], tokens)

    lines = []
    prof = profile_window(one_step, "train step B=8 T=1024", lines)
    prof["busy_share"] = prof["device_ms"] / 1e3 / step_s
    parts = step_breakdown(cfg, box[0], B, T, lines)
    attn = parts["attention_layer"] * cfg.n_layers
    parts["rest"] = (prof["device_ms"] - attn - parts["head"]
                     - parts["optimizer"])
    prof["parts_ms"] = parts
    with open(os.path.join(OUT_DIR, "chip_profile.txt"), "a") as f:
        f.write("\n" + "\n".join(lines))
    top = ", ".join(f"{t['name'][:40]} {t['ms']:.2f} ms x{t['calls']}"
                    for t in prof["top"][:5])
    log(f"[profile] train step: device {prof['device_ms']:.2f} ms, busy "
        f"share {prof['busy_share']:.3f} of {step_s * 1e3:.2f} ms; {top}")
    log(f"[profile] train step parts, device ms: attention fwd+bwd "
        f"{parts['attention_layer']:.2f} a layer x {cfg.n_layers} = "
        f"{attn:.2f}; head (norm, fp32 logits, cross-entropy) "
        f"{parts['head']:.2f}; AdamW + grad_norm {parts['optimizer']:.2f}; "
        f"the rest of the blocks {parts['rest']:.2f}")
    del state, box, params
    return {"batch": B, "seq": T, "steps": n, "step_ms": step_s * 1e3,
            "window_ms": [w * 1e3 for w in windows],
            "tokens_per_s": B * T / step_s, "samples_per_s": B / step_s,
            "model_tflop_per_step": model_flops.total / 1e12, "mfu": mfu,
            "peak_memory_bytes": peak, "launches": launches,
            "launches_per_step": launches // n, "losses": losses,
            "profile": prof, "flash_vs_mha": flash_vs_mha_step(cfg, tokens)}


# examples/gpt_fsdp/fsdp.yaml's hyperparameters, on one card (no mesh)
GPT_FSDP_HPARAMS = {"global_batch_size": 8, "lr": 3.0e-4, "weight_decay": 0.1,
                    "vocab_size": 50304, "n_layers": 12, "d_model": 768,
                    "n_heads": 12, "d_ff": 3072, "seq_len": 1024,
                    "remat": True, "attention_impl": "auto"}


class _BatchTimings:
    """The profiler hook the trainer calls at each chunk boundary
    (``record_batch_timing``, as the JAX package's ProfilerAgent)."""

    def __init__(self) -> None:
        self.rows = []

    def record_batch_timing(self, batches, **timing) -> None:
        self.rows.append({"batches": batches, **timing})


def _trial_classes():
    """The port's GPT trial, recording the first batch it trains on, and
    a Trainer that times its checkpoint saves and restores."""
    import torch

    from determined_clone_tpu_torch.examples.gpt_fsdp import GPTTrial
    from determined_clone_tpu_torch.training import Trainer

    class RecordingGPTTrial(GPTTrial):
        first_batch = None

        def loss(self, params, batch, seed):
            if self.first_batch is None and torch.is_grad_enabled():
                self.first_batch = batch.cpu().numpy()
            return super().loss(params, batch, seed)

    class TimedTrainer(Trainer):
        def __init__(self, trial):
            super().__init__(trial)
            self.save_s, self.restore_s = [], []

        def _save(self, *args, **kwargs):
            t0 = time.monotonic()
            out = super()._save(*args, **kwargs)
            self.save_s.append(time.monotonic() - t0)
            return out

        def _restore_one(self, *args, **kwargs):
            t0 = time.monotonic()
            out = super()._restore_one(*args, **kwargs)
            self.restore_s.append(time.monotonic() - t0)
            return out

    return RecordingGPTTrial, TimedTrainer


def fit_trial(storage, max_batches, *, latest=None, extra=None) -> dict:
    """``core.init(config=...)`` → ``Trainer(GPTTrial).fit()``: what a
    user of the port calls to train a trial. Returns the result, the
    reports, the final state, the first batch trained and the timings."""
    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.config import ExperimentConfig
    from determined_clone_tpu_torch.training import TrialContext

    trial_cls, trainer_cls = _trial_classes()
    cfg = ExperimentConfig.from_dict({
        "searcher": {"name": "single", "metric": "loss",
                     "max_length": {"batches": max_batches}},
        "scheduling_unit": 10,
        "checkpoint_storage": {"type": "shared_fs", "host_path": storage},
        "hyperparameters": GPT_FSDP_HPARAMS,
        "resources": {"slots_per_trial": 1},
        **(extra or {})})
    with core.init(config=cfg, trial_id=1) as ctx:
        timings = ctx.profiler = _BatchTimings()
        trial = trial_cls(TrialContext(config=cfg, hparams=GPT_FSDP_HPARAMS,
                                       core=ctx))
        trainer = trainer_cls(trial)
        t0 = time.monotonic()
        result = trainer.fit(latest_checkpoint=latest)
        wall = time.monotonic() - t0
        records = list(ctx.train._backend.records)
    return {"result": result, "wall_s": wall, "trial": trial,
            "state": trainer._final_state, "first_batch": trial.first_batch,
            "save_s": trainer.save_s, "restore_s": trainer.restore_s,
            "timings": timings.rows,
            "training": [(r["steps_completed"], r["metrics"])
                         for r in records if r["group"] == "training"],
            "validation": [(r["steps_completed"], r["metrics"])
                           for r in records if r["group"] == "validation"]}


def _prefetch_threads() -> list:
    import threading

    return [t.name for t in threading.enumerate()
            if "prefetch" in t.name and t.is_alive()]


def check_prefetched_batches(batches, n=6) -> int:
    """The first ``n`` batches the CUDA prefetcher hands over equal the
    host's. The copy is made the slow side: the producer queues four
    4096² fp32 matrix products (~3 ms each with TF32 off) on the
    stager's side stream before each batch's copy, and the consumer
    reads each batch at once on its idle stream. A ``ready`` that does
    not make that stream wait for the copy's event reads the batch
    before its copy has run, and the check fails."""
    import numpy as np
    import torch

    from determined_clone_tpu_torch.utils.data import (
        CudaStager,
        make_device_feeder,
    )

    it = iter(batches)
    host = [next(it) for _ in range(n)]
    stager = CudaStager("cuda")
    busy = [torch.randn(4096, 4096, device="cuda")]
    torch.cuda.synchronize()

    def slow_put(batch):
        with torch.cuda.stream(stager.stream):
            for _ in range(4):
                busy[0] = torch.tanh(busy[0] @ busy[0] * 1e-3)
        return stager.put(batch)

    feed = make_device_feeder(iter(host), slow_put, depth=2,
                              name="check-prefetch", ready=stager.ready)
    try:
        for i, want in enumerate(host):
            got = next(feed)
            copy = (got + 0).cpu().numpy()  # read on the consumer's stream
            if not np.array_equal(copy, want):
                raise AssertionError(f"prefetched batch {i} differs from "
                                     f"the host's")
    finally:
        feed.close()
    return n


def phase_trial(bare_samples_per_s) -> dict:
    """Phase 7: the GPT trial through the trainer loop, 20 batches then a
    restore from the last checkpoint to 40, with the checks of the module
    docstring; then 10 batches at prefetch depth 0 and at depth 2."""
    import math
    import shutil
    import tempfile

    import numpy as np
    import torch

    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.ops.flash_attention import flash_attention
    from determined_clone_tpu_torch.training.optim import leaves

    hparams = GPT_FSDP_HPARAMS
    storage = tempfile.mkdtemp(prefix="chip-smoke-trial-")
    periods = {"min_validation_period": {"batches": 10},
               "min_checkpoint_period": {"batches": 10}}
    try:
        flash_attention.launches = 0
        leg1 = fit_trial(storage, 20, extra=periods)
        registry = core.LocalCheckpointRegistry(
            os.path.join(storage, "checkpoints.jsonl"))
        ckpts = registry.list()
        last = ckpts[-1]
        threads_after_1 = _prefetch_threads()
        leg2 = fit_trial(storage, 40, latest=last["storage_id"],
                         extra=periods)
        launches = flash_attention.launches
        threads_after_2 = _prefetch_threads()

        # the checkpoint, loaded back, against the state that leg 1 ended in
        state1 = leg1["state"]
        with core.init(config=None, storage_path=storage) as ctx:
            with ctx.checkpoint.restore_path(last["storage_id"]) as path:
                loaded = core.load_pytree(os.path.join(path, "state"), state1)
        adam1, adam_l = state1.opt_state[1][0], loaded.opt_state[1][0]
        pairs = list(zip(leaves(state1.params), leaves(loaded.params)))
        pairs += list(zip(leaves(adam1.mu), leaves(adam_l.mu)))
        pairs += list(zip(leaves(adam1.nu), leaves(adam_l.nu)))
        bitwise = all(torch.equal(a.detach(), b) for a, b in pairs)
        ckpt_bytes = sum(last["resources"].values())
        restored = (loaded.step, adam_l.count)
        del loaded, pairs, adam1, adam_l, state1
        leg1["state"] = None

        it = leg1["trial"].training_data()
        for _ in range(20):
            next(it)
        batch21 = next(it)
        # batches from 64 on, which no fit of this run staged: memory that
        # a read reaches before its copy cannot hold them already
        for _ in range(64 - 21):
            next(it)
        fed = check_prefetched_batches(it)

        # 10 batches at each prefetch depth, nothing saved
        depth_runs = {}
        for depth in (0, 2):
            run = fit_trial(storage, 10, extra={
                "checkpoint_policy": "none",
                "optimizations": {"prefetch_depth": depth}})
            depth_runs[depth] = {
                "samples_per_s": run["training"][0][1]["samples_per_second"],
                "queue_wait_s": run["timings"][0]["queue_wait_s"],
                "host_input_s": run["timings"][0]["dataloading_s"],
                "wall_s": run["wall_s"]}
            run["state"] = None
    finally:
        shutil.rmtree(storage, ignore_errors=True)

    reports = {"leg1": leg1, "leg2": leg2}
    losses = [m["loss"] for leg in reports.values()
              for group in ("training", "validation")
              for _, m in leg[group]]
    n_eval = len(leg1["validation"]) + len(leg2["validation"])
    per_step = 2 * hparams["n_layers"] if hparams["remat"] else hparams[
        "n_layers"]
    want_launches = per_step * 40 + hparams["n_layers"] * n_eval
    ln_v = math.log(hparams["vocab_size"])
    checks = {
        "batches_trained 20 then 40": (
            leg1["result"]["batches_trained"] == 20
            and leg2["result"]["batches_trained"] == 40),
        "training reports at 10, 20 then 30, 40": (
            [s for s, _ in leg1["training"]] == [10, 20]
            and [s for s, _ in leg2["training"]] == [30, 40]),
        "validation reports at 10, 20, 20 then 30, 40, 40": (
            [s for s, _ in leg1["validation"]] == [10, 20, 20]
            and [s for s, _ in leg2["validation"]] == [30, 40, 40]),
        "every loss finite": all(math.isfinite(x) for x in losses),
        "first training loss within 0.5 of ln(vocab)": abs(
            leg1["training"][0][1]["loss"] - ln_v) <= 0.5,
        "checkpoint equals leg 1's state bit for bit": bitwise,
        "restored step 20, Adam count 20": restored == (20, 20),
        "resumed leg trains batch 21 first": np.array_equal(
            leg2["first_batch"], batch21),
        "leg 2 ends at step 40, Adam count 40": (
            leg2["state"].step == 40
            and leg2["state"].opt_state[1][0].count == 40),
        "no prefetch thread alive after either fit": (
            threads_after_1 == [] and threads_after_2 == []
            and _prefetch_threads() == []),
        f"flash launches {want_launches} ({per_step} x 40 + "
        f"{hparams['n_layers']} x {n_eval} eval batches)":
            launches == want_launches,
    }
    leg2["state"] = None
    def fmt(values, digits):
        return ", ".join(f"{v:.{digits}f}" for v in values)

    for leg_name, leg in reports.items():
        sps = [m["samples_per_second"] for _, m in leg["training"]]
        log(f"[trial] {leg_name}: samples/s per chunk {fmt(sps, 3)} (bare "
            f"step, phase 6: {bare_samples_per_s:.3f}); training loss "
            f"{fmt([m['loss'] for _, m in leg['training']], 4)}; validation "
            f"{fmt([m['loss'] for _, m in leg['validation']], 4)}; saves "
            f"{fmt(leg['save_s'], 2)} s; restores {fmt(leg['restore_s'], 2)}"
            f" s; fit {leg['wall_s']:.2f} s")
    log(f"[trial] checkpoint {ckpt_bytes} bytes ({ckpt_bytes / 2**30:.3f} "
        f"GiB); flash launches over the two legs {launches}; prefetched "
        f"batches checked {fed}")
    for depth, r in depth_runs.items():
        log(f"[trial] prefetch_depth {depth}: {r['samples_per_s']:.3f} "
            f"samples/s over 10 batches, queue wait {r['queue_wait_s']:.4f} "
            f"s, host input {r['host_input_s']:.4f} s, fit {r['wall_s']:.2f}"
            f" s")
    failed = [name for name, ok in checks.items() if not ok]
    for name, ok in checks.items():
        log(f"[trial] check {'ok' if ok else 'FAILED'}: {name}")
    if failed:
        raise AssertionError(f"phase 7 checks failed: {failed}")
    strip = ("trial", "state", "first_batch")
    return {"legs": {k: {f: v for f, v in leg.items() if f not in strip}
                     for k, leg in reports.items()},
            "checkpoint_bytes": ckpt_bytes, "launches": launches,
            "eval_batches": n_eval, "prefetch_depths": depth_runs,
            "prefetched_batches_checked": fed,
            "bare_step_samples_per_s": bare_samples_per_s,
            "checks": checks}


# ---------------------------------------------------------------------------
# Phase 8: the model families (BASELINE configs #1, #3 and #4, ViT and the
# detector), each trained through core.init -> Trainer.fit (or main)
# ---------------------------------------------------------------------------

RESNET_TRAIN_BATCHES, RESNET_BATCH, RESNET_IMAGES = 20, 32, 640
BERT_BATCHES, BERT_PREEMPT_AT = 60, 30
# bert-base widths; seq 128 is a GLUE fine-tune length
BERT_BASE = {"vocab_size": 30522, "n_layers": 12, "d_model": 768,
             "n_heads": 12, "d_ff": 3072, "seq_len": 128,
             "global_batch_size": 32}
VIT_S16 = {"image_size": 224, "patch_size": 16, "channels": 3,
           "n_classes": 1000, "d_model": 384, "n_layers": 12, "n_heads": 6,
           "d_ff": 1536, "global_batch_size": 32, "n_train": 320}
VISION_BATCHES = 10
# the operators whose kernels are the convolutions of a ResNet step
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward")
MNIST_GATE = 0.97        # BASELINE.md's accuracy gate for config #1
BF16_STEP_REL = 0.01     # a bf16 step's loss against an fp32 one's


def _read_yaml(rel_path) -> dict:
    import yaml

    with open(os.path.join(REPO, rel_path)) as f:
        return yaml.safe_load(f)


def fit_family(trial_cls, cfg, hparams, storage, device="cuda") -> dict:
    """``core.init(config=...)`` → ``Trainer(trial).fit()`` with
    checkpoints under ``storage``: the reports, the result and the wall
    time."""
    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.training import Trainer, TrialContext

    with core.init(config=cfg, storage_path=storage, trial_id=1) as ctx:
        trial = trial_cls(TrialContext(config=cfg, hparams=hparams,
                                       core=ctx, device=device))
        trainer = Trainer(trial)
        t0 = time.monotonic()
        result = trainer.fit()
        wall = time.monotonic() - t0
        records = list(ctx.train._backend.records)
    return {"result": result, "wall_s": wall, "trial": trial,
            "state": trainer._final_state,
            "training": [(r["steps_completed"], r["metrics"])
                         for r in records if r["group"] == "training"],
            "validation": [(r["steps_completed"], r["metrics"])
                           for r in records if r["group"] == "validation"]}


def _losses(run) -> list:
    return [m["loss"] for group in ("training", "validation")
            for _, m in run[group] if "loss" in m]


def _rate_line(name, run, batch) -> str:
    sps = [m["samples_per_second"] for _, m in run["training"]]
    return (f"[families] {name}: samples/s per report "
            f"{', '.join(f'{v:.2f}' for v in sps)} (ms/step "
            f"{', '.join(f'{batch / v * 1e3:.2f}' for v in sps)}); losses "
            f"{', '.join(f'{v:.4f}' for v in _losses(run))}; fit "
            f"{run['wall_s']:.2f} s")


def dtype_steps(init_fn, cfg, loss_fn, tx_fn, batch, seed,
                device="cuda") -> dict:
    """One train step in bf16 and one in fp32 from the same weights and
    batch: their losses (taken before the update), and how far apart."""
    import torch

    from determined_clone_tpu_torch.training.train_step import (
        create_train_state,
        make_train_step,
    )

    out = {}
    for name, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        c = dataclasses.replace(cfg, compute_dtype=dt)
        params = init_fn(torch.Generator(device=device).manual_seed(seed), c,
                         device)
        tx = tx_fn()
        state = create_train_state(params, tx, seed)
        step = make_train_step(lambda p, b, s, c=c: (loss_fn(p, c, *b), {}),
                               tx)
        _, m = step(state, batch)
        out[name] = float(m["loss"])
        del state, params
    out["rel"] = abs(out["bf16"] / out["fp32"] - 1)
    return out


def family_mnist(storage, device="cuda") -> dict:
    """BASELINE #1: the port's MnistTrial at ``examples/mnist/const.yaml``
    (read as the platform reads it), 400 batches on the digit scans."""
    from determined_clone_tpu_torch.config import ExperimentConfig
    from determined_clone_tpu_torch.examples.mnist import MnistTrial

    cfg = ExperimentConfig.from_yaml(
        os.path.join(REPO, "examples", "mnist", "const.yaml"))
    run = fit_family(MnistTrial, cfg, cfg.hyperparameters, storage, device)
    accs = [m["accuracy"] for _, m in run["validation"]]
    run["best_accuracy"] = max(accs)
    log(_rate_line("mnist", run, cfg.hyperparameters["global_batch_size"]))
    log(f"[families] mnist: validation accuracy "
        f"{', '.join(f'{a:.4f}' for a in accs)} at "
        f"{', '.join(str(s) for s, _ in run['validation'])}")
    return run


def resnet_config():
    """``examples/resnet50/distributed.yaml`` cut to one card: global
    batch 256 → 32 (the yaml's per-chip batch), the mesh dropped, slots
    8 → 1, 200 → 20 batches, ``scheduling_unit`` 20 → 5 (four reports),
    and synthetic images 4096 → 640 (the 20 batches trained)."""
    from determined_clone_tpu_torch.config import ExperimentConfig

    raw = _read_yaml(os.path.join("examples", "resnet50",
                                  "distributed.yaml"))
    hp = {k: v for k, v in raw["hyperparameters"].items() if k != "mesh"}
    hp.update(global_batch_size=RESNET_BATCH, n_train=RESNET_IMAGES)
    raw.update(hyperparameters=hp, resources={"slots_per_trial": 1},
               searcher={**raw["searcher"], "max_length": {
                   "batches": RESNET_TRAIN_BATCHES}},
               scheduling_unit=5)
    return ExperimentConfig.from_dict(raw), hp


def _first_step_trial(base):
    """``base`` (the ResNet trial) keeping its first training batch's loss
    and that batch's chance-level loss under the initial params: the mean
    over examples of ``logsumexp(z) - mean(z)``, the loss of labels that
    the initial logits ``z`` know nothing of. It is not ln 1000: the GN
    ResNet's residual stream grows unnormalised through the blocks, so its
    initial logits spread (the JAX package's ResNet-50 at init gives
    chance-level losses of 7.64-7.66 and first losses of 8.05-8.48 at
    B=4 on 64×64 inputs), and the first loss differs from the chance
    level by the label logits' mean, ~σ/√B."""
    import torch

    from determined_clone_tpu_torch.models import resnet

    class FirstStep(base):
        first = None

        def loss(self, params, batch, seed):
            out = super().loss(params, batch, seed)
            if self.first is None and torch.is_grad_enabled():
                with torch.no_grad():
                    z = resnet.apply(params, self.cfg, batch[0]).float()
                chance = (torch.logsumexp(z, -1) - z.mean(-1)).mean()
                self.first = (float(out[0].detach()), float(chance))
            return out

    return FirstStep


def family_resnet(storage, lines, device="cuda") -> dict:
    """BASELINE #3: ResNet-50-GN through the trainer, then on one batch:
    bare steps timed, one step profiled, and a bf16 against an fp32
    step."""
    import math
    import statistics

    import torch

    from determined_clone_tpu_torch.examples.resnet50 import ResNetTrial
    from determined_clone_tpu_torch.models import resnet
    from determined_clone_tpu_torch.training import optim
    from determined_clone_tpu_torch.training.train_step import (
        create_train_state,
        make_train_step,
    )
    from determined_clone_tpu_torch.utils.data import batch_to_device

    cfg, hp = resnet_config()
    torch.cuda.reset_peak_memory_stats()
    run = fit_family(_first_step_trial(ResNetTrial), cfg, hp, storage,
                     device)
    run["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    log(_rate_line("resnet50", run, hp["global_batch_size"]))
    trial = run.pop("trial")
    run["first_loss"], run["chance_loss"] = trial.first
    batch = batch_to_device(next(iter(trial.training_data())), device)
    run["state"] = None

    def tx():
        return optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(float(hp["lr"])))

    state = create_train_state(
        resnet.init(torch.Generator(device=device).manual_seed(0),
                    trial.cfg, device), tx(), 0)
    step = make_train_step(
        lambda p, b, s: (resnet.loss_fn(p, trial.cfg, *b), {}), tx())
    box = [state]

    def one_step():
        box[0], m = step(box[0], batch)
        return m

    for _ in range(2):
        one_step()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        float(one_step()["loss"])
        times.append(time.monotonic() - t0)
    step_s = statistics.median(times)
    prof = profile_window(one_step, "resnet50 train step B=32", lines,
                          op_keys=CONV_OPS)
    prof["busy_share"] = prof["device_ms"] / 1e3 / step_s
    conv_ms = sum(prof["ops_ms"].values())
    del box, state
    run["bare_step_ms"] = step_s * 1e3
    run["profile"] = prof
    run["dtype_steps"] = dtype_steps(resnet.init, trial.cfg, resnet.loss_fn,
                                     tx, batch, seed=1, device=device)
    top = "; ".join(f"{t['name'][:60]} {t['ms']:.2f} ms x{t['calls']}"
                    for t in prof["top"])
    log(f"[families] resnet50: first step loss {run['first_loss']:.4f}, "
        f"chance-level {run['chance_loss']:.4f} (ln 1000 = "
        f"{math.log(1000):.4f}); bare step {step_s * 1e3:.2f} ms "
        f"({hp['global_batch_size'] / step_s:.2f} samples/s), device "
        f"{prof['device_ms']:.2f} ms, busy share {prof['busy_share']:.3f}, "
        f"peak memory {run['peak_memory_bytes'] / 2**30:.2f} GiB; "
        f"convolutions (cuDNN, forward and backward) {conv_ms:.2f} ms, "
        f"the rest (GroupNorm's fp32 passes, ReLU, residual adds, pool, "
        f"loss, AdamW) {prof['device_ms'] - conv_ms:.2f} ms; top kernels: "
        f"{top}")
    d = run["dtype_steps"]
    log(f"[families] resnet50: one step from the same weights, loss bf16 "
        f"{d['bf16']:.6f} vs fp32 {d['fp32']:.6f} ({d['rel']:.2e} apart)")
    return run


def bert_leg(storage, hparams, latest, preempt_at=None, device="cuda"):
    """One leg of the fine-tune: ``core.init`` → the port's ``main``.
    With ``preempt_at``, the metrics backend creates the flag that a
    ``FilePreemptionSource`` polls at that training report and waits
    until the watcher has seen it, so the leg stops right after that
    batch. The backend keeps each training report's time."""
    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.config import ExperimentConfig
    from determined_clone_tpu_torch.examples import bert_finetune
    from determined_clone_tpu_torch.exec.trial import ClusterInfo

    class PreemptAt(core.LocalMetricsBackend):
        def __init__(self):
            super().__init__()
            self.ctx, self.times = None, {}

        def report(self, group, steps_completed, metrics):
            super().report(group, steps_completed, metrics)
            if group != "training":
                return
            self.times[steps_completed] = time.monotonic()
            if steps_completed == preempt_at:
                open(flag, "w").close()
                deadline = time.monotonic() + 30.0
                while not self.ctx.preempt.should_preempt():
                    if time.monotonic() > deadline:
                        raise AssertionError("the preemption watcher "
                                             "never saw the flag")
                    time.sleep(0.05)

    raw = _read_yaml(os.path.join("examples", "bert_finetune",
                                  "const.yaml"))
    raw["hyperparameters"] = hparams
    raw["searcher"]["max_length"] = {"batches": BERT_BATCHES}
    cfg = ExperimentConfig.from_dict(raw)
    flag = os.path.join(storage, "preempt-flag")
    backend = PreemptAt()
    source = core.FilePreemptionSource(flag) if preempt_at else None
    info = ClusterInfo(
        master_host="", master_port=0, allocation_id="chip-smoke",
        trial_id=1, experiment_id=0, rank=0, world_size=1, slots=1,
        n_slices=1, hparams=hparams, target_units=BERT_BATCHES,
        latest_checkpoint=latest, experiment_config=raw)
    with core.init(config=cfg, storage_path=storage, trial_id=1,
                   metrics_backend=backend,
                   preemption_source=source) as ctx:
        backend.ctx = ctx
        t0 = time.monotonic()
        result = bert_finetune.main(ctx, info, device=device)
        wall = time.monotonic() - t0
    ckpt = core.LocalCheckpointRegistry(
        os.path.join(storage, "checkpoints.jsonl")).list()[-1]
    return {"result": result, "wall_s": wall, "times": backend.times,
            "checkpoint": ckpt["storage_id"],
            "training": [(r["steps_completed"], r["metrics"])
                         for r in backend.records
                         if r["group"] == "training"],
            "validation": [(r["steps_completed"], r["metrics"])
                           for r in backend.records
                           if r["group"] == "validation"]}


def family_bert(storage, device="cuda") -> dict:
    """BASELINE #4 at bert-base widths: ``main`` preempted at 30 by a
    flag file, then resumed from its checkpoint to 60; the checkpoint's
    arrays; a bf16 against an fp32 step."""
    import pickle

    import numpy as np
    import torch

    from determined_clone_tpu_torch.core._serialization import (
        tree_paths_and_leaves,
    )
    from determined_clone_tpu_torch.examples import bert_finetune
    from determined_clone_tpu_torch.models import bert
    from determined_clone_tpu_torch.training import optim

    hp = {**_read_yaml(os.path.join("examples", "bert_finetune",
                                    "const.yaml"))["hyperparameters"],
          **BERT_BASE}
    leg1 = bert_leg(storage, hp, None, preempt_at=BERT_PREEMPT_AT,
                    device=device)
    leg2 = bert_leg(storage, hp, leg1["checkpoint"], device=device)
    with open(os.path.join(storage, leg2["checkpoint"], "state.pkl"),
              "rb") as f:
        saved = pickle.load(f)
    cfg = bert_finetune.config_from_hparams(hp, device)
    ref = bert.init(torch.Generator(device=device).manual_seed(0), cfg,
                    device)
    got = tree_paths_and_leaves(saved)
    leg2["checkpoint_tree_ok"] = (
        [(k, tuple(v.shape)) for k, v in got]
        == [(k, tuple(v.shape)) for k, v in tree_paths_and_leaves(ref)]
        and all(type(v) is np.ndarray and v.dtype == np.float32
                for _, v in got))
    del ref, saved
    t = leg2["times"]
    batch = hp["global_batch_size"]
    first, last = min(t), max(t)
    leg2["ms_per_step"] = (t[last] - t[first]) / (last - first) * 1e3
    tokens, labels = bert_finetune._synthetic_reviews(
        batch, cfg.vocab_size, hp["seq_len"], seed=3)
    dev_batch = (torch.from_numpy(tokens).to(device),
                 torch.from_numpy(labels).to(device))
    d = dtype_steps(bert.init, cfg, bert.classify_loss,
                    lambda: optim.adamw(float(hp["lr"]), weight_decay=0.01),
                    dev_batch, seed=0, device=device)
    for name, leg in (("leg 1", leg1), ("leg 2", leg2)):
        train = [(s, round(m["loss"], 4)) for s, m in leg["training"]]
        val = [(s, round(m["accuracy"], 4)) for s, m in leg["validation"]]
        log(f"[families] bert-base {name}: {leg['result']}; training loss "
            f"{train}; validation accuracy {val}; wall {leg['wall_s']:.2f} s")
    log(f"[families] bert-base: {leg2['ms_per_step']:.2f} ms/step "
        f"({batch / leg2['ms_per_step'] * 1e3:.2f} samples/s) over batches "
        f"{first}-{last}; one step from the same weights, loss bf16 "
        f"{d['bf16']:.6f} vs fp32 {d['fp32']:.6f} ({d['rel']:.2e} apart)")
    return {"leg1": leg1, "leg2": leg2, "dtype_steps": d}


def family_vision(storage, device="cuda") -> dict:
    """ViT-S/16 on the ResNet example's synthetic images, and the
    detector at ``DetectorConfig()`` on ``synthetic_detection_batches``,
    each a subclass of the hub's trial that supplies the data."""
    import numpy as np

    from determined_clone_tpu_torch.config import ExperimentConfig
    from determined_clone_tpu_torch.examples.resnet50 import (
        _synthetic_images,
    )
    from determined_clone_tpu_torch.model_hub import (
        SingleStageDetectionTrial,
        ViTClassificationTrial,
        synthetic_detection_batches,
    )

    class SyntheticViT(ViTClassificationTrial):
        def training_data(self):
            bs = self.global_batch_size
            x, y = _synthetic_images(int(self.context.get_hparam("n_train")),
                                     self._cfg.image_size,
                                     self._cfg.n_classes)
            i = 0
            while True:
                sel = np.arange(i, i + bs) % len(x)
                yield {"image": x[sel], "label": y[sel]}
                i += bs

    class SyntheticDetection(SingleStageDetectionTrial):
        def training_data(self):
            return synthetic_detection_batches(
                self._cfg, batch_size=self.global_batch_size,
                n_batches=VISION_BATCHES)

    out = {}
    for name, cls, hp in (("vit_s16", SyntheticViT, VIT_S16),
                          ("detector", SyntheticDetection,
                           {"global_batch_size": 32})):
        cfg = ExperimentConfig.from_dict({
            "searcher": {"name": "single", "metric": "loss",
                         "max_length": {"batches": VISION_BATCHES}},
            "scheduling_unit": 5, "hyperparameters": hp})
        run = fit_family(cls, cfg, hp, os.path.join(storage, name), device)
        log(_rate_line(name, run, hp["global_batch_size"]))
        out[name] = run
    return out


def phase_families() -> dict:
    """Phase 8: the families at full width, with the flash kernel's
    launch count set to 0 before and read after (they attend through
    plain ``mha``, as in the JAX package)."""
    import math
    import shutil
    import tempfile

    from determined_clone_tpu_torch.ops.flash_attention import flash_attention

    storage = tempfile.mkdtemp(prefix="chip-smoke-families-")
    lines: list = []
    t0 = time.monotonic()
    flash_attention.launches = 0
    try:
        mnist = family_mnist(os.path.join(storage, "mnist"))
        resnet = family_resnet(os.path.join(storage, "resnet50"), lines)
        bert = family_bert(os.path.join(storage, "bert"))
        vision = family_vision(os.path.join(storage, "vision"))
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    launches = flash_attention.launches
    wall = time.monotonic() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_profile.txt"), "a") as f:
        f.write("\n" + "\n".join(lines))

    def finite(values):
        return bool(values) and all(math.isfinite(v) for v in values)

    b1, b2 = bert["leg1"], bert["leg2"]
    res_losses = _losses(resnet) + [resnet["first_loss"]]
    checks = {
        "mnist: 400 batches trained": (
            mnist["result"]["batches_trained"] == 400),
        f"mnist: best validation accuracy > {MNIST_GATE}": (
            mnist["best_accuracy"] > MNIST_GATE),
        f"resnet50: {RESNET_TRAIN_BATCHES} batches trained": (
            resnet["result"]["batches_trained"] == RESNET_TRAIN_BATCHES),
        "resnet50: every loss finite": finite(res_losses),
        "resnet50: first loss within 1.0 of the initial logits' "
        "chance-level loss": (
            abs(resnet["first_loss"] - resnet["chance_loss"]) <= 1.0),
        f"resnet50: bf16 and fp32 step losses within {BF16_STEP_REL}": (
            resnet["dtype_steps"]["rel"] <= BF16_STEP_REL),
        f"bert: leg 1 preempted at {BERT_PREEMPT_AT}": b1["result"] == {
            "state": "preempted", "batches": BERT_PREEMPT_AT},
        "bert: leg 2 reports at 40, 50, 60 and completes": (
            [s for s, _ in b2["training"]] == [40, 50, 60]
            and b2["result"] == {"state": "completed",
                                 "batches": BERT_BATCHES}),
        "bert: checkpoint is numpy fp32 under bert.init's tree": (
            b2["checkpoint_tree_ok"]),
        "bert: every loss finite": finite(
            [m["loss"] for leg in (b1, b2) for _, m in leg["training"]]),
        f"bert: bf16 and fp32 step losses within {BF16_STEP_REL}": (
            bert["dtype_steps"]["rel"] <= BF16_STEP_REL),
        "vit_s16 and detector: every loss finite": all(
            finite(_losses(r)) for r in vision.values()),
        "no flash launch in phase 8": launches == 0,
    }
    for name, ok in checks.items():
        log(f"[families] check {'ok' if ok else 'FAILED'}: {name}")
    log(f"[families] phase 8 wall {wall:.1f} s; flash launches {launches}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 8 checks failed: {failed}")
    keep = ("result", "wall_s", "training", "validation")
    return {"mnist": {k: mnist[k] for k in keep + ("best_accuracy",)},
            "resnet50": {k: resnet[k] for k in keep + (
                "first_loss", "chance_loss", "peak_memory_bytes",
                "bare_step_ms",
                "profile", "dtype_steps")},
            "bert": {"leg1": {k: b1[k] for k in keep},
                     "leg2": {k: b2[k] for k in keep + ("ms_per_step",)},
                     "dtype_steps": bert["dtype_steps"]},
            "vision": {n: {k: r[k] for k in keep}
                       for n, r in vision.items()},
            "flash_launches": launches, "wall_s": wall, "checks": checks}


def kernel_entry(case: dict) -> dict:
    return {"max_abs_err": case["max_abs_err"], "ms": case["kernel_ms"],
            "call_ms": case["call_ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"]}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from determined_clone_tpu_torch.models import gpt

    quick = "--quick" in argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    report = {"build": phase_build(),
              "kernels": phase_kernels(timed=not quick)}
    if quick:
        log("[quick] every kernel case agrees with its plain version")
        return 0

    cfg = gpt.GPTConfig()
    t0 = time.monotonic()
    params = gpt.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    log(f"[init] GPTConfig(): {gpt.param_count(params)} params in "
        f"{time.monotonic() - t0:.2f} s")
    report["forward"] = phase_forward(params, cfg)
    report["engine"] = phase_engine(params, cfg)
    report["profile"] = phase_profile(params, cfg, report["engine"]["wall_s"])
    del params
    report["attention_grad"] = phase_attention_grad()
    report["train"] = phase_train()
    report["trial"] = phase_trial(report["train"]["samples_per_s"])
    report["families"] = phase_families()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    # the main path's case (bf16 at the GPT width) and, beside it, the
    # same shape in fp32
    cases = {c["case"]: c for c in report["kernels"]}
    kernels = [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "determined_clone_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "determined_clone_tpu/ops/flash_attention.py:38",
        "launches": report["forward"]["launches"],
        "train_launches": report["train"]["launches"],
        "train_launches_per_step": report["train"]["launches_per_step"],
        "trial_launches": report["trial"]["launches"],
        **kernel_entry(cases["gpt_width_bf16_causal"]),
        "fp32": kernel_entry(cases["gpt_width_fp32_causal"])}]
    report["card"] = smi
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
