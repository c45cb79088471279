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
   trial's samples/s and ms/step per report;
9. the serving features at full width: ``GPTConfig()`` (bf16) with
   random weights from a seed (phase 4's), engines built by
   ``InferenceEngine.from_serving_config`` from ``ServingConfig(
   max_batch=8, max_prefill_len=128, kv_block_size=16)``, every greedy
   token held to the phase-4 rule (``check_greedy``; in bf16 each near
   tie also within ``BF16_TIE_GAP`` of the best logit in fp32). A fresh
   init's greedy decode mostly repeats its last token, which a wrong KV
   context barely moves, so (a), (b) and (f) run again on
   ``branch_scaled`` weights in fp32, token for token: (a) the prefix
   cache — 8 requests sharing a 96-token system prompt with their own
   8–40-token tails, the first alone, then the rest, then all 8 again:
   the hit and miss counts per request, a fork of every repeated
   prompt's last block, equal tokens on the repeat, held blocks equal to
   the cache's and 0 after a flush; and the same requests in bf16 on the
   scaled weights, every step off the greedy loop a near tie in bf16 and
   in fp32; (b) chunked prefill on a warmed engine — two 900-token
   prompts in 128-token chunks while 6 short requests decode: 8 chunks
   of each prompt, at most one chunk call between two decode steps, each
   gap within the longest chunk call plus the longest decode step plus
   ``GAP_MARGIN_MS``, and ``run_static`` on the same requests; (c)
   speculative decoding with k=4, in fp32 and bf16, with the identity
   testbed (``extend_with_identity_layers`` by 12 as the target, the
   model as the draft: acceptance exactly 1.0 in fp32, at least
   ``SPEC_MIN_ACCEPT_BF16`` in bf16) and a disagreeing draft
   (``slice_prefix_layers`` to 2; in fp32 also on ``branch_scaled``
   weights, where it disagrees, every token equal); (d) the lifecycle —
   an abort mid-decode, a past deadline, ``hot_swap`` to a second seed's
   weights, ``liveness``, ``fail_inflight`` raising ``ReplicaFailed``,
   every block back; (e) ``ServingHTTPServer`` on an ephemeral port:
   three ``generate_over_http`` calls, ``/metrics`` parsed against
   ``stats()``, 429 from a full queue; (f) warmup with prefix cache,
   chunking and speculation on: ``warmup() == program_budget()`` CUDA
   graphs, capture seconds and memory, then the phase-4 burst cold
   (eager) and warm (graph replays only, counted; the cold tokens), each
   with tokens/s, p50/p99 and the device's busy share, and ``hot_swap``
   after warmup. No flash launch. Prints the phase's wall time;
10. the fleet at full width: ``ServingFleet`` replicas, each configured
   as phase 9's engines with the prefix cache, 128-token chunked
   prefill (a 96-token system prompt and a 40-token tail pass the
   largest prefill bucket) and a host tier over a CAS
   tier in a temporary directory (``tier_store``), behind the
   prefix-affinity router. Traffic: 3 system prompts of 96 tokens with
   8 requests each (own 8–40-token tails, 32 new tokens), the first
   request of each system prompt alone, then the rest at once. (a) in
   bf16 on phase 4's weights at 1 and 3 replicas: every request held to
   the phase-4 rule per system prompt, tokens/s, p50/p99 and the busy
   share of a profiled second run of the same shape; at 3 replicas each
   system prompt served mostly by one replica (prefix hits per replica
   printed); in fp32 on ``branch_scaled`` weights every request's
   tokens equal one engine's (``reference_tokens``); (b) in bf16 and in
   fp32: a replica's spilled blocks promoted into another replica's
   pool, equal bit for bit; (c) ``replace_replica`` on a replica holding
   the three system prompts (the others stopped): equal tokens,
   ``kv_host_hit`` at least the 18 shared blocks, the time to first
   token of a promoted prefix against a cold prompt; again with a host
   budget below one block, the hits from CAS; (d) ``scale_down`` in the
   middle of the traffic: nothing dropped, every token right; (e) a
   blue-green ``rollout`` to ``branch_scaled`` seed-1 weights under the
   traffic: each request exactly one version's, none failed, the canary
   passed; (f) ``scale_up`` (warmup: graph capture) with the traffic
   sent to the other replicas as the warmup starts: every graph
   captured, programs of the other replicas run during the capture, the
   tokens unchanged, the warmup's seconds beside the first replica's
   (captured alone); (g) ``FleetHTTPServer``: ``/v1/generate`` (phase-4 rule),
   ``/v1/fleet``, ``/v1/scale``, ``/v1/rollout`` of a checkpoint, and
   the replicas' ``kv_tier_*`` counters in ``/metrics`` equal
   ``kv_stats()``; (h) six chaos scenarios at chaos's own configuration
   (``serving/chaos.py``) pass on the card; (i) no flash launch. Prints
   memory after each scale_up and every rate beside the card's name and
   power limit;
11. the parallelism slice, in a one-rank NCCL world joined through
   ``exec/launch.py`` (``init_rank``; the card is one, so world size 1):
   (a) ``moe_ffn`` at N=8192 tokens, D 768, F 3072, E 8, k 2, cf 1.25
   against ``moe_ffn_dense`` (the JAX package's one-hot einsum form) on
   the same inputs, fp32 within 1e-5 of the largest output and bf16
   within ``TOL``, the same dropped choices, each form's device ms; (b)
   ``GPTConfig(moe_experts=8)`` (Switch-Base-8's widths on the GPT-2-small
   stack, ~520M parameters) at B=8, T=1024, bf16, remat, ``bench.py``'s
   AdamW, 16 steps on one batch, state and batch DTensors placed by
   ``GPT_SHARDING_RULES`` on the one-rank mesh: finite losses that fall,
   24 flash launches per step; ms/step, tokens/s, MFU by the index-form
   FLOP count, the dropped share, the aux loss, peak memory, the busy
   share and the top kernels; (c) BASELINE #5,
   ``examples/gpt_fsdp/fsdp.yaml`` cut as phase 7 cuts it (one slot,
   ``mesh.fsdp`` 1), through ``core.init`` → ``Trainer.fit`` on that
   mesh for 10 batches: the training and validation losses at 10 equal
   phase 7's unmeshed leg bit for bit, the checkpoint's manifest in the
   JAX block layout, the checkpoint restored into the DTensor state bit
   for bit; (d) the MoE GPT in fp32 behind phase 9's ``ServingConfig``
   (128-token chunks): phase 4's 8-request burst on a cold engine
   (eager) and on a warmed one (graph replays only), token for token,
   with tokens/s;
12. the second half of the parallelism slice, in a one-rank NCCL world
   (``init_rank``; the card is one, so the pipeline and sequence axes
   have size 1 and their collectives are skipped — ``parallel/check.py``
   runs them across four cards): (a) ``ring_attention`` and
   ``ulysses_attention`` at sp 1 on B=4, T=1024, H=12, D=64 in fp32 and
   bf16, each within phase 2's bound (``TOL``) of ``mha`` and of the
   flash kernel on the same inputs; (b) ``GPTConfig()`` with
   ``pipeline_microbatches=4`` on the one-rank mesh, state and batch
   placed by ``GPT_PP_SHARDING_RULES``, phase 6's weights, batch and
   AdamW for 4 steps: the losses equal phase 6's first 4 bit for bit, the
   flash kernel launched ``2 * n_layers`` times per step (the stage
   count of (L/P) layers x the ticks that run the stage x 2 at P = 1);
   (c) BASELINE #2's and #3's ``distributed.yaml`` cut 8 → 1 rank, the
   global batch cut to one chip's share (64, 32; ResNet 200 → 10
   batches), through ``Trainer.fit`` on the one-rank mesh: every report
   equal to the same trial's without a mesh, bit for bit (both with
   cuDNN's deterministic algorithms); (d) BERT-base
   ``classify`` (bf16, batch 32, seq 128) under ``BERT_SHARDING_RULES``
   on the one-rank mesh equal to the unmeshed forward bit for bit;
13. the telemetry slice: phase 7's trial with an ``observability`` block
   (goodput journal, flight recorder, Chrome trace), its first leg (20
   batches) and a leg restored from its checkpoint at 20 to 40: (a) the
   training and validation reports equal phase 7's bit for bit; (b)
   ``train_dispatch`` spans equal the dispatches, one marked
   ``compiled``; ``host_sync`` spans equal the chunks; ``validate``,
   ``checkpoint_save`` (and in the restored leg ``checkpoint_restore``,
   ``restore_replay``) present; each leg's Chrome trace valid; (c) each
   leg's goodput conserved with productive and compile time booked, and
   the journal's two legs merged and conserved; (d) ``mfu`` equal to
   ``flops_per_sec / mfu_peak_flops``, the peak labelled ``gpu:h100``,
   printed beside ``mfu_measured`` and ``mfu_divergence_total``; (e) the
   memory gauges of ``gpu:0`` read from ``torch.cuda``, the limit equal
   to ``mem_get_info``'s total, ``device_memory_peak_bytes`` between
   ``memory_allocated()`` and ``max_memory_allocated()`` at the last
   boundary; (f) the flash launches ``2 * n_layers`` per step and
   ``n_layers`` per eval batch; (g) samples/s printed beside phase 7's
   (the per-step sync's cost; no bound); (h) the scaling bench at one
   rank (``parallel/scaling_bench.py``, in a one-rank NCCL world) gives
   an artifact that ``validate_multichip`` accepts;
14. the control-plane slice: an ASHA search of two ``GPTTrial``s at
   phase 7's hyperparameters but ``lr`` log-uniform in [10^-4.5,
   10^-3] (``SEARCH``: 2 rungs at 10 and 20 batches, divisor 2,
   ``scheduling_unit`` 10, ``max_restarts`` 1, ``observability`` on with
   spans and metrics shipped), through ``ExperimentConfig.from_dict`` →
   ``LocalExperimentRunner(..., master=InProcessMaster(),
   device="cuda").run()``, the first promoted trial's rung-1 leg raising
   once before its first step: (a) 2 trials created, the searcher shut
   down, every trial completed, at least one promoted to 20 batches, and
   each promoted trial's reports at 10 then 20 with its checkpoint
   registered under its own request id (it resumed its own checkpoint);
   (b) the best promoted trial's final searcher metric and state (params
   and Adam moments) equal an unbroken 20-batch ``fit_trial`` of its
   hparams bit for bit; (c) the failed leg restarted once
   (``restarts`` 1, the runner's ``trial_restarts_total`` 1); (d) the
   events the searcher was given, replayed into a fresh ``Searcher``
   built from the same config and seed, give the same operations; (e)
   the master's ``/metrics`` over ``serve_http`` has both trials'
   rollups and the restart counter, and its spans the runner's
   ``experiment`` lane and its 4 ``trial_leg`` spans (2 at rung 0, the
   promoted trial's failed leg and its restart) under one trace id;
   (f) the flash launches ``2 * n_layers`` per train batch and
   ``n_layers`` per eval batch of every leg. Prints each trial's lr,
   rung, legs, restarts and metrics, the search's wall, its saves and
   restores, and the share of the wall in training steps;
15. the managed-cluster slice: (a) the C++ master built with ``make``
   (``deploy.local.ensure_master``, started in a thread with the script
   so its one g++ overlaps phases 1–14) and ``deploy.local.cluster_up``
   with one of the port's agents, which must detect the card (slots 1,
   topology ``<gen>-1``, no override); (b) phase 7's trial at
   ``GPT_FSDP_HPARAMS`` (``managed_config``: a single searcher of 20
   batches, a report every batch, a validation and a checkpoint every
   10, ``shared_fs`` storage) submitted through the port's CLI in a
   subprocess (``experiment create <cfg> <model_dir> -f``; the uploaded
   ``model_def.py`` subclasses ``GPTTrial`` only to print the flash
   launch count when a leg ends), paused once its first checkpoint is
   registered and activated. Checks: COMPLETED in exactly 2 legs, the
   second resumed from the pause's checkpoint; the master's 20 training
   losses and its validation losses equal an unbroken in-process
   ``fit_trial`` of the same config bit for bit; every listed
   checkpoint passes ``validate_checkpoint_dir``; the launches in the
   legs' shipped logs equal ``2 * n_layers`` per batch plus
   ``n_layers`` per validation; each leg had its own
   ``CUDA_VISIBLE_DEVICES``; the slot is free again; the master's GC
   task exits 0; (c) ``core.init_unmanaged`` around 8 steps of the same
   trial in this process: COMPLETED on the master, its 8 losses equal
   (b)'s first 8 bit for bit. Prints the master's build and cluster-up
   seconds, each leg's submit→running (the master's queue) and start-up
   (spawn → first step), pause→checkpointed, and the experiment's wall
   with its share in training steps beside phase 14's;
16. the rest of the control plane, on phase 15's cluster before its
   teardown (which follows phase 16 and runs even when phase 16 fails):
   (a) ``sdk.Determined`` on phase 15's experiment (COMPLETED, one
   trial), its ``top_checkpoint()`` registered as a model version,
   downloaded (digest-verified, ``validate_checkpoint_dir``), loaded into
   the port's ``GPTTrial`` and evaluated on the card as the trainer
   evaluates: the validation loss equal to the master's at that
   checkpoint's batch bit for bit, ``n_layers`` flash launches per eval
   batch; (b) a ``ServingFleet`` of two ``GPTConfig()`` replicas (fp32 on
   ``branch_scaled`` weights, phase 10's ``ServingConfig``) as the
   master's serving gang through ``MasterLink`` in a pool of its own (so
   no replica lands on phase 15's card agent): the master's fleet record
   and its ``dct_master_sched_serving_*`` families, 8 requests with one
   engine's tokens, a master-driven scale 2 → 1 with 8 requests in
   flight (all answered with the same tokens, none rejected; the
   drained replica's exit stamped after its last request), the kill
   reclaiming every slot, no ``fleet-link``/``fleet-drain`` thread left;
   (c) meanwhile an in-process master ingesting the fleet's metrics,
   ``scrape_tick`` once a second, one absence rule per replica and the
   stock SLO rules: the drained replica's rule goes pending → firing
   within ``stale_s + for_s`` (one tick's slack) while the other stays
   inactive, the CLI's ``query`` lists the series and reads a ``rate``,
   ``alerts`` prints the rule firing and ``dct_alert_firing`` reads 1;
   (d) through the port's CLI, a shell (``shell exec`` sees
   ``CUDA_VISIBLE_DEVICES`` empty: a task without a slot gets no card),
   a command (exit 0, its log on the master) and a TensorBoard task over
   phase 15's experiment (``/data`` through the master's proxy holds the
   20 training losses the master has); ``task kill`` ends the shell and
   the TensorBoard task, the command having exited.
   Prints the download's seconds and bytes, the replicas' time to
   RUNNING, the drain's seconds and each task's submit → serving.

fp32 matrix products run in full fp32 throughout (TF32 off), the
training phases included. The launch count in each kernel's entry is
that of phase 3, the uncached forward (the engine's paged forward
attends with plain ``mha``, as in the JAX package); ``train_launches``
is that of phase 6's 32 steps and ``trial_launches`` that of phase 7's
two legs; phases 8, 9 and 10 launch none (``serving_launches``,
``fleet_launches``); ``parallel_launches`` is phase 11's, (b) to (d);
``pipeline_launches`` is phase 12's (b), ``telemetry_launches``
phase 13's two legs, ``search_launches`` phase 14's search (its
witness run not counted) and ``managed_launches`` the sum over phase
15's managed legs, read from their shipped logs (each leg is a process
the agent starts, so its count is its own); ``sdk_launches`` is phase
16 (a)'s evaluation and ``fleet_master_launches`` its (b), none.
The last
three lines are the kernels' JSON line, the card's name and power limit,
and the result; the line before them gives the whole script's wall
time. Details go to ``smoke_out/chip_smoke.json``. Exits non-zero,
printing no result, when CUDA is unavailable.
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
                 max_ties=0, witness=None) -> dict:
    """The reference's pin, step by step: at every generated position the
    full uncached forward (plain attention) over the prompt and the
    engine's tokens so far must pick the engine's token. Where every
    step agrees this IS the greedy loop over ``apply``. With ``max_ties``
    above 0 (None: no cap), up to that many steps may pick another token
    at a near tie — the engine's token within ``tie_tol`` of the best
    logit — since the paged and uncached forwards run different matrix
    shapes, whose bf16 sums the card orders differently. ``witness``
    (a config, fp32) is a second judge of each such step: its uncached
    forward over the same tokens must also put the engine's token within
    ``tie_tol`` of its best, or the step is a fault, not a tie."""
    import torch

    from determined_clone_tpu_torch.models import gpt

    mha_cfg = dataclasses.replace(cfg, attention_impl="mha")
    exact = 0
    ties = []
    with torch.no_grad():
        for p, r in zip(prompts, results):
            toks = list(p)
            for t in r.tokens:
                x = torch.tensor([toks], device="cuda")
                logits = gpt.apply(params, mha_cfg, x)[0, -1]
                best = int(logits.argmax())
                if best == t:
                    exact += 1
                    toks.append(t)
                    continue
                where = (f"request {r.request_id} step {len(toks) - len(p)}"
                         f": engine token {t}, greedy {best}")
                tie = {"gap": float(logits[best] - logits[t])}
                if not tie["gap"] <= tie_tol:
                    raise AssertionError(f"{where}, logit gap {tie['gap']} > "
                                         f"{tie_tol}")
                if witness is not None:
                    w = gpt.apply(params, dataclasses.replace(
                        witness, attention_impl="mha"), x)[0, -1]
                    tie["witness_gap"] = float(w.max() - w[t])
                    if not tie["witness_gap"] <= tie_tol:
                        raise AssertionError(
                            f"{where}: the witness puts the engine's token "
                            f"{tie['witness_gap']} below its best, more "
                            f"than {tie_tol}")
                ties.append(tie)
                if max_ties is not None and len(ties) > max_ties:
                    raise AssertionError(
                        f"{len(ties)} steps differ from the greedy loop at "
                        f"near ties, more than {max_ties}")
                toks.append(t)
    return {"exact": exact, "near_ties": len(ties),
            "worst_tie_gap": max([x["gap"] for x in ties], default=0.0),
            "ties": ties, "tie_tol": tie_tol}


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
TRIAL_METRIC = "loss"      # the trials' searcher metric (phases 7 and 14)
GPT_FSDP_HPARAMS = {"global_batch_size": 8, "lr": 3.0e-4, "weight_decay": 0.1,
                    "vocab_size": 50304, "n_layers": 12, "d_model": 768,
                    "n_heads": 12, "d_ff": 3072, "seq_len": 1024,
                    "remat": True, "attention_impl": "auto"}


class _BatchTimings:
    """The profiler hook the trainer calls at each chunk boundary
    (``record_batch_timing``, as the JAX package's ProfilerAgent). With
    a telemetry ``registry`` it also reads, at that boundary, the card's
    allocated and peak allocated bytes beside the registry's
    ``device_memory_peak_bytes``."""

    def __init__(self, registry=None) -> None:
        self.rows = []
        self.registry = registry

    def record_batch_timing(self, batches, **timing) -> None:
        row = {"batches": batches, **timing}
        if self.registry is not None:
            import torch

            row.update(
                memory_allocated=torch.cuda.memory_allocated(),
                max_memory_allocated=torch.cuda.max_memory_allocated(),
                device_memory_peak_bytes=self.registry.gauge(
                    "device_memory_peak_bytes").value)
        self.rows.append(row)


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


def fit_trial(storage, max_batches, *, latest=None, extra=None,
              hparams=GPT_FSDP_HPARAMS) -> dict:
    """``core.init(config=...)`` → ``Trainer(GPTTrial).fit()``: what a
    user of the port calls to train a trial. Returns the result, the
    reports, the final state, the first batch trained and the timings."""
    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.config import ExperimentConfig
    from determined_clone_tpu_torch.training import TrialContext

    trial_cls, trainer_cls = _trial_classes()
    cfg = ExperimentConfig.from_dict({
        "searcher": {"name": "single", "metric": TRIAL_METRIC,
                     "max_length": {"batches": max_batches}},
        "scheduling_unit": 10,
        "checkpoint_storage": {"type": "shared_fs", "host_path": storage},
        "hyperparameters": hparams,
        "resources": {"slots_per_trial": 1},
        **(extra or {})})
    with core.init(config=cfg, trial_id=1) as ctx:
        tel = ctx.telemetry
        timings = ctx.profiler = _BatchTimings(
            tel.registry if tel is not None else None)
        trial = trial_cls(TrialContext(config=cfg, hparams=hparams,
                                       core=ctx))
        trainer = trainer_cls(trial)
        t0 = time.monotonic()
        result = trainer.fit(latest_checkpoint=latest)
        wall = time.monotonic() - t0
        records = list(ctx.train._backend.records)
        goodput = tel.goodput.snapshot() if tel is not None else None
    return {"result": result, "wall_s": wall, "trial": trial,
            "telemetry": tel, "goodput": goodput,
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


def fit_family(trial_cls, cfg, hparams, storage, device="cuda",
               distributed=None, **mesh) -> dict:
    """``core.init(config=...)`` → ``Trainer(trial).fit()`` with
    checkpoints under ``storage``: the reports, the result and the wall
    time. ``mesh=None`` trains without a mesh in a distributed world."""
    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.training import Trainer, TrialContext

    with core.init(config=cfg, storage_path=storage, trial_id=1,
                   distributed=distributed) as ctx:
        trial = trial_cls(TrialContext(config=cfg, hparams=hparams,
                                       core=ctx, device=device, **mesh))
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
    run = fit_family(MnistTrial, cfg, cfg.hyperparameters.raw, storage,
                     device)
    accs = [m["accuracy"] for _, m in run["validation"]]
    run["best_accuracy"] = max(accs)
    log(_rate_line("mnist", run,
                   cfg.hyperparameters.raw["global_batch_size"]))
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


# phase 9: the serving features at full width
SERVE = {"max_batch": 8, "max_prefill_len": 128, "kv_block_size": 16,
         "system": 96, "tails": (8, 40), "new": 32, "long": 900,
         "chunk": 128, "short": 16, "short_new": 48,
         "spec_lengths": (16, 40, 90, 120),
         "burst": (16, 40, 64, 90, 120, 150, 180, 200), "spec_k": 4,
         "identity_extra": 12, "draft_layers": 2, "abort_new": 400}
SPEC_MIN_ACCEPT_BF16 = 0.95  # identity draft in bf16: near ties may flip
# a short row's decode gap during a chunked prefill: one chunk call and
# one decode step, plus the scheduler's host work between them
GAP_MARGIN_MS = 3.0


def branch_scaled(params):
    """A copy of ``params`` whose greedy tokens depend on the context: each
    block's output projections (``attn_out``, ``mlp_down``) scaled by 10
    and its query and key projections by 2 (attention scores by 4). A
    fresh init's greedy decode mostly repeats the last token
    (``echo_share``): its attention is nearly uniform and its residual
    branches small, so a wrong KV context barely moves the argmax. The
    logits keep their scale (the final layernorm and the tied embedding
    are untouched)."""
    blocks = dict(params["blocks"])
    for name in ("attn_out", "mlp_down"):
        blocks[name] = dict(blocks[name],
                            kernel=blocks[name]["kernel"] * 10.0)
    qkv = blocks["attn_qkv"]["kernel"].clone()
    qkv[..., :2 * qkv.shape[-1] // 3] *= 2.0
    blocks["attn_qkv"] = dict(blocks["attn_qkv"], kernel=qkv)
    return dict(params, blocks=blocks)


def serving_config(**kw):
    from determined_clone_tpu_torch.config import ServingConfig

    cfg = ServingConfig(max_batch=SERVE["max_batch"],
                        max_prefill_len=SERVE["max_prefill_len"],
                        kv_block_size=SERVE["kv_block_size"], **kw)
    cfg.validate()
    return cfg


def spec_block(cfg, k, layers):
    """A speculative: block whose draft has ``cfg``'s widths."""
    from determined_clone_tpu_torch.config import SpeculativeConfig

    return SpeculativeConfig(enabled=True, k=k, draft_layers=layers,
                             draft_d_model=cfg.d_model,
                             draft_n_heads=cfg.n_heads, draft_d_ff=cfg.d_ff)


def serving_engine(params, cfg, scfg, **kw):
    from determined_clone_tpu_torch.serving import InferenceEngine

    return InferenceEngine.from_serving_config(params, cfg, scfg,
                                               device="cuda", **kw)


def traced():
    """(telemetry for an engine, its tracer)."""
    import types

    from determined_clone_tpu_torch.telemetry.spans import Tracer

    tracer = Tracer()
    return types.SimpleNamespace(registry=None, tracer=tracer), tracer


def prompts_of(lengths, vocab, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


def echo_share(prompts, results) -> float:
    """Share of generated tokens equal to the token before them: near 1
    would mean a model that only repeats, and checks that prove little."""
    same = total = 0
    for p, r in zip(prompts, results):
        prev = p[-1]
        for t in r.tokens:
            same += t == prev
            total += 1
            prev = t
    return same / max(total, 1)


def burst(eng, prompts, new, timeout=900):
    """All prompts submitted at once; (results, wall s, p50 s, p99 s)."""
    import numpy as np

    t0 = time.monotonic()
    hs = [eng.submit(p, new, request_id=str(i)) for i, p in enumerate(prompts)]
    results = [h.result(timeout=timeout) for h in hs]
    wall = time.monotonic() - t0
    lat = sorted(r.total_s for r in results)
    return (results, wall, float(np.percentile(lat, 50)),
            float(np.percentile(lat, 99)))


def pinned(pin, results) -> bool:
    """check_greedy raised on any step outside the rule; this holds when
    it went through every generated token."""
    return pin["exact"] + pin["near_ties"] == sum(len(r.tokens)
                                                   for r in results)


def pin_rule(cfg):
    """The phase-4 rule: token for token in fp32; in bf16 at most
    ``BF16_MAX_TIES`` near ties, each one also within ``BF16_TIE_GAP`` of
    the best logit in fp32 (``check_greedy``'s witness)."""
    import torch

    if cfg.compute_dtype == torch.float32:
        return {"tie_tol": 0.0, "max_ties": 0}
    return {"tie_tol": BF16_TIE_GAP, "max_ties": BF16_MAX_TIES,
            "witness": dataclasses.replace(cfg, compute_dtype=torch.float32)}


def lane_name(cfg, scaled) -> str:
    import torch

    dtype = "fp32" if cfg.compute_dtype == torch.float32 else "bf16"
    return f"{dtype}, {'scaled' if scaled else 'fresh'} weights"


def prefix_traffic(params, cfg):
    """(a)'s requests: 8 prompts sharing a system prompt, each with its
    own tail; the first alone, then the other 7 (they alias its full
    blocks); then all 8 again (every prompt block hits, the last one is
    forked). Returns what the checks read."""
    import numpy as np

    system = prompts_of([SERVE["system"]], cfg.vocab_size, 90)[0]
    lengths = np.linspace(*SERVE["tails"], 8).astype(int).tolist()
    prompts = [system + t for t in prompts_of(lengths, cfg.vocab_size, 91)]
    telemetry, tracer = traced()
    scfg = serving_config(prefix_cache=True,
                          chunk_prefill_len=SERVE["chunk"])
    new = SERVE["new"]
    with serving_engine(params, cfg, scfg, telemetry=telemetry) as eng:
        wave1 = [eng.generate(prompts[0], new, timeout=900)]
        wave1 += burst(eng, prompts[1:], new)[0]
        wave2 = burst(eng, prompts, new)[0]
        eng.wait_idle()
        stats = eng.stats()
        outstanding = eng.kv_outstanding()
        eng.assert_kv_balanced(stats.prefix_cached_entries)
        flushed = eng.flush_prefix_cache()
        eng.assert_kv_balanced(0)
    forks = [e for e in tracer.events() if e["name"] == "request_cow_fork"]
    return {"prompts": prompts, "lengths": lengths, "wave1": wave1,
            "wave2": wave2, "stats": stats, "outstanding": outstanding,
            "flushed": flushed, "forks": len(forks)}


def serving_prefix(params, cfg, scaled) -> dict:
    """(a) the prefix cache: hit and miss counts per request, a fork of
    every repeated prompt's last block, the repeat's tokens, the greedy
    pin, and the blocks the cache holds."""
    lane = lane_name(cfg, scaled)
    t = prefix_traffic(params, cfg)
    prompts, wave1, wave2, stats = (t["prompts"], t["wave1"], t["wave2"],
                                    t["stats"])
    bs = SERVE["kv_block_size"]
    need = [-(-len(p) // bs) for p in prompts]
    shared = SERVE["system"] // bs
    pin = check_greedy(params, cfg, prompts, wave1, **pin_rule(cfg))
    everyone = wave1 + wave2
    checks = {
        f"prefix ({lane}): the first request misses every prompt block": (
            wave1[0].prefix_hit_blocks, wave1[0].prefix_miss_blocks)
        == (0, need[0]),
        f"prefix ({lane}): requests 2-8 hit the {shared} shared blocks and "
        f"miss their tails": all(
            (r.prefix_hit_blocks, r.prefix_miss_blocks) == (shared, n - shared)
            for r, n in zip(wave1[1:], need[1:])),
        f"prefix ({lane}): the repeat hits every prompt block and forks the "
        f"last": all((r.prefix_hit_blocks, r.prefix_miss_blocks) == (n, 0)
                     for r, n in zip(wave2, need))
        and t["forks"] == len(prompts),
        f"prefix ({lane}): hit and miss counters sum the requests'": (
            stats.prefix_hit_blocks == sum(r.prefix_hit_blocks
                                           for r in everyone)
            and stats.prefix_miss_blocks == sum(r.prefix_miss_blocks
                                                for r in everyone)),
        f"prefix ({lane}): the repeat's tokens equal the first wave's": [
            r.tokens for r in wave2] == [r.tokens for r in wave1],
        f"prefix ({lane}): tokens follow the greedy loop (phase-4 rule)":
        pinned(pin, wave1),
        f"prefix ({lane}): outstanding blocks == resident cache blocks, "
        f"then 0": t["outstanding"] == stats.prefix_cached_entries
        == t["flushed"] > 0,
    }
    echo = echo_share(prompts, wave1)
    log(f"[serving] (a) prefix, {lane}: {len(prompts)} prompts of "
        f"{SERVE['system']} shared + {t['lengths'][0]}-{t['lengths'][-1]} "
        f"own tokens: hits {[r.prefix_hit_blocks for r in wave1]} then "
        f"{[r.prefix_hit_blocks for r in wave2]} blocks, misses "
        f"{[r.prefix_miss_blocks for r in wave1]}; {t['forks']} forks; "
        f"{stats.prefix_cached_entries} cached blocks flushed; greedy "
        f"{pin['exact']} exact, {pin['near_ties']} near ties {pin['ties']}; "
        f"echo share {echo:.3f}")
    return {"checks": checks, "hits": [r.prefix_hit_blocks for r in everyone],
            "misses": [r.prefix_miss_blocks for r in everyone],
            "forks": t["forks"], "cached_blocks": stats.prefix_cached_entries,
            "pin": pin, "echo_share": echo}


def serving_prefix_witness(params, cfg) -> dict:
    """(a)'s traffic in bf16 on the scaled weights, both waves against
    the greedy loop: how many steps pick another token than the uncached
    bf16 forward, and whether the fp32 witness calls each a near tie
    too. No cap on their number: the phase-4 cap was set on the fresh
    weights, whose decode mostly repeats; the fp32 lane on the same
    weights holds these requests token for token."""
    t = prefix_traffic(params, cfg)
    pin = check_greedy(params, cfg, t["prompts"] * 2, t["wave1"] + t["wave2"],
                       **dict(pin_rule(cfg), max_ties=None))
    steps = 2 * len(t["prompts"]) * SERVE["new"]
    log(f"[serving] (a) prefix, {lane_name(cfg, True)}: {pin['exact']}/"
        f"{steps} steps equal the bf16 greedy loop, {pin['near_ties']} near "
        f"ties (gap, fp32 witness's gap): "
        f"{[(x['gap'], x['witness_gap']) for x in pin['ties']]}")
    return {"checks": {
        "prefix (bf16, scaled weights): every step off the greedy loop is a "
        "near tie in bf16 and in fp32": pinned(pin, t["wave1"] + t["wave2"])},
        "pin": pin, "steps": steps}


def serving_chunked(params, cfg, scaled) -> dict:
    """(b) on a warmed engine, two long prompts prefilled in chunks while
    6 short requests decode: between two of the short rows' decode steps
    during the long prefill runs one chunk call at most, and each gap is
    no longer than the longest chunk call plus the longest decode step
    plus ``GAP_MARGIN_MS``; then ``run_static`` on the same requests."""
    lane = lane_name(cfg, scaled)
    telemetry, tracer = traced()
    shorts = prompts_of([SERVE["short"]] * 6, cfg.vocab_size, 92)
    longs = prompts_of([SERVE["long"]] * 2, cfg.vocab_size, 93)
    scfg = serving_config(chunk_prefill_len=SERVE["chunk"])
    with serving_engine(params, cfg, scfg, telemetry=telemetry) as eng:
        eng.warmup()  # graph replays: the gaps are not first calls' costs
        hs = [eng.submit(p, SERVE["short_new"]) for p in shorts]
        while sum(e["name"] == "serving_decode_step"
                  for e in tracer.events()) < 3:
            time.sleep(0.001)
        hs += [eng.submit(p, SERVE["new"], request_id=f"long-{i}")
               for i, p in enumerate(longs)]
        results = [h.result(timeout=900) for h in hs]
        eng.wait_idle()
        static = eng.run_static([(p, SERVE["short_new"]) for p in shorts]
                                + [(p, SERVE["new"]) for p in longs])
        eng.assert_kv_balanced(0)
    events = tracer.events()
    chunks = {(e["args"]["request_id"], e["ts_us"]): e["dur_us"]
              for e in events if e["name"] == "request_prefill_chunk"
              and e["args"]["request_id"].startswith("long-")}
    calls = {ts: d for (_, ts), d in chunks.items()}  # one per chunk call
    lo = min(calls)
    hi = max(ts + d for ts, d in calls.items())
    steps = sorted((e["ts_us"], e["dur_us"]) for e in events
                   if e["name"] == "serving_decode_step")
    # the short rows' inter-token gaps: decode steps around a chunk call
    gaps = [(a, b) for a, b in zip(steps, steps[1:])
            if a[0] < hi and b[0] > lo]
    gaps_ms = [(b[0] - a[0]) / 1e3 for a, b in gaps]
    calls_in_gap = [sum(a[0] < ts < b[0] for ts in calls) for a, b in gaps]
    bound_ms = (max(calls.values()) + max(d for _, d in steps)) / 1e3 \
        + GAP_MARGIN_MS
    whole_ms = sum(calls.values()) / 1e3
    prompts = shorts + longs
    pin = check_greedy(params, cfg, prompts, results, **pin_rule(cfg))
    pin_static = check_greedy(params, cfg, prompts, static, **pin_rule(cfg))
    same_static = sum(a.tokens == b.tokens for a, b in zip(results, static))
    n_chunks = -(-SERVE["long"] // SERVE["chunk"])
    checks = {
        f"chunked ({lane}): every request generated its tokens": all(
            r.finish_reason == "length" for r in results),
        f"chunked ({lane}): {2 * n_chunks} chunks covered both "
        f"{SERVE['long']}-token prompts": len(chunks) == 2 * n_chunks
        and all(sum(r == f"long-{i}" for r, _ in chunks) == n_chunks
                for i in range(2)),
        f"chunked ({lane}): one chunk call at most between two decode "
        f"steps, each gap within the longest chunk call + the longest "
        f"decode step + {GAP_MARGIN_MS} ms": bool(gaps_ms)
        and max(calls_in_gap) <= 1 and max(gaps_ms) <= bound_ms,
        f"chunked ({lane}): tokens follow the greedy loop (phase-4 rule)":
        pinned(pin, results),
        f"chunked ({lane}): run_static's tokens follow it too": pinned(
            pin_static, static),
        # both follow the rule, so they can differ only after a near tie
        f"chunked ({lane}): run_static's tokens equal the continuous "
        f"engine's (bf16: but for near ties)": same_static == len(results)
        or pin["near_ties"] + pin_static["near_ties"] > 0,
    }
    log(f"[serving] (b) chunked, {lane}: 2 x {SERVE['long']} tokens in "
        f"{len(calls)} chunk calls of {SERVE['chunk']} ({whole_ms:.1f} ms) "
        f"beside 6 decoding requests: their decode gaps meanwhile "
        f"{', '.join(f'{g:.1f}' for g in gaps_ms)} ms (bound "
        f"{bound_ms:.1f}), chunk calls per gap {calls_in_gap}; greedy "
        f"{pin['exact']} exact, {pin['near_ties']} near ties; run_static "
        f"equal on {same_static}/{len(results)} requests; echo share "
        f"{echo_share(prompts, results):.3f}")
    return {"checks": checks, "chunk_calls": len(calls),
            "whole_prefill_ms": whole_ms, "decode_gaps_ms": gaps_ms,
            "gap_bound_ms": bound_ms, "chunk_calls_per_gap": calls_in_gap,
            "pin": pin, "pin_static": pin_static,
            "static_equal_requests": same_static}


def serving_speculative(params, cfg) -> dict:
    """(c) k-token speculation with the identity testbed (target = the
    model deepened by identity layers, draft = the model) and with a
    disagreeing draft (its first layers), in fp32 and in bf16; and in
    fp32 the disagreeing draft again on ``branch_scaled`` weights, where
    it does disagree."""
    import torch

    from determined_clone_tpu_torch.models import gpt

    k, layers = SERVE["spec_k"], SERVE["draft_layers"]
    prompts = prompts_of(SERVE["spec_lengths"], cfg.vocab_size, 94)
    out, checks = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        name = "fp32" if dtype == torch.float32 else "bf16"
        ext, ext_cfg = gpt.extend_with_identity_layers(
            params, c, SERVE["identity_extra"])
        lanes = {"identity": (ext, ext_cfg, params, c.n_layers, params),
                 "disagreeing": (params, c, gpt.slice_prefix_layers(
                     params, c, layers)[0], layers, params)}
        if dtype == torch.float32:
            scaled = branch_scaled(params)  # a draft that disagrees
            lanes["disagreeing_scaled"] = (
                scaled, c, gpt.slice_prefix_layers(scaled, c, layers)[0],
                layers, scaled)
        for lane, (tp, tc, dp, n_draft, ref) in lanes.items():
            scfg = serving_config(speculative=spec_block(c, k, n_draft))
            telemetry, tracer = traced()
            with serving_engine(tp, tc, scfg, draft_params=dp,
                                telemetry=telemetry) as eng:
                results, wall, _, _ = burst(eng, prompts, SERVE["new"])
                stats = eng.stats()
            del eng
            pin = check_greedy(ref, c, prompts, results, **pin_rule(c))
            rate = stats.spec_acceptance_rate
            # tokens one row emits per verify call, over every row's rounds
            emitted = [e["args"]["emitted"] for e in tracer.events()
                       if e["name"] == "request_spec_round"]
            rounds = len(emitted)
            per_verify = sum(emitted) / rounds
            out[f"{lane}_{name}"] = {
                "acceptance": rate, "tokens_per_verify": per_verify,
                "row_rounds": rounds, "tokens_per_s":
                stats.tokens_generated / wall, "pin": pin,
                "echo_share": echo_share(prompts, results)}
            log(f"[serving] (c) {lane} draft, {name}, k={k}: acceptance "
                f"{rate:.4f}, {per_verify:.3f} tokens per row and verify "
                f"({rounds} row-rounds), "
                f"{stats.tokens_generated / wall:.1f} tokens/s; greedy "
                f"{pin['exact']} exact, {pin['near_ties']} near ties; echo "
                f"share {echo_share(prompts, results):.3f}")
            checks[f"speculative ({lane}, {name}): tokens follow the "
                   f"greedy loop (phase-4 rule)"] = pinned(pin, results)
        del ext, lanes
    checks["speculative: identity acceptance exactly 1.0 in fp32"] = (
        out["identity_fp32"]["acceptance"] == 1.0)
    checks[f"speculative: identity acceptance >= {SPEC_MIN_ACCEPT_BF16} in "
           f"bf16"] = out["identity_bf16"]["acceptance"] >= \
        SPEC_MIN_ACCEPT_BF16
    return {"checks": checks, **out}


def serving_lifecycle(params, params2, cfg) -> dict:
    """(d) abort mid-decode, a deadline already past, hot_swap to other
    weights, liveness, and condemnation with fail_inflight."""
    from determined_clone_tpu_torch.serving import ReplicaFailed

    prompts = prompts_of(SERVE["spec_lengths"][:3], cfg.vocab_size, 95)
    many, new = SERVE["abort_new"], SERVE["new"]
    with serving_engine(params, cfg, serving_config()) as eng:
        h = eng.submit(prompts[0], many)
        while not eng.stats().peak_active:
            time.sleep(0.001)
        time.sleep(0.2)
        eng.abort(h)
        aborted = h.result(timeout=600)
        eng.wait_idle()
        eng.assert_kv_balanced(0)
        expired = eng.submit(prompts[1], 8,
                             deadline_t=time.monotonic() - 1.0).result(600)
        eng.assert_kv_balanced(0)
        before = eng.generate(prompts[2], new, timeout=600)
        eng.hot_swap(params2)
        after = eng.generate(prompts[2], new, timeout=600)
        # a handle resolves inside the scheduler's pass: wait for the
        # pass to end before reading an idle engine's beat
        eng.wait_idle()
        live = eng.liveness()
        hs = [eng.submit(p, many) for p in prompts]
        while not eng.liveness()["pending"]:
            time.sleep(0.001)
        failed = eng.fail_inflight("chip smoke")
        raised = 0
        for x in hs:
            try:
                x.result(timeout=600)
            except ReplicaFailed:
                raised += 1
        deadline = time.monotonic() + 60
        while eng.liveness()["thread_alive"] and time.monotonic() < deadline:
            time.sleep(0.01)
        dead = not eng.liveness()["thread_alive"]
        eng.assert_kv_balanced(0)
    pin = check_greedy(params2, cfg, [prompts[2]], [after], **pin_rule(cfg))
    checks = {
        "lifecycle: an abort mid-decode resolves aborted, blocks back": (
            aborted.finish_reason == "aborted"
            and 0 < len(aborted.tokens) < many),
        "lifecycle: a past deadline expires at admission": (
            expired.finish_reason, expired.tokens) == ("expired", []),
        "lifecycle: after hot_swap the tokens are the new weights' greedy "
        "ones (phase-4 rule)": pinned(pin, [after]),
        "lifecycle: liveness reports a fresh beat": (
            live["thread_alive"] and not live["pending"]
            and live["beat_age_s"] < 5.0),
        "lifecycle: fail_inflight resolves in-flight handles with "
        "ReplicaFailed, blocks back": failed == raised == len(hs) and dead,
    }
    log(f"[serving] (d) lifecycle: aborted after {len(aborted.tokens)} "
        f"tokens; expired at admission; hot_swap changed "
        f"{sum(a != b for a, b in zip(before.tokens, after.tokens))}/"
        f"{len(after.tokens)} tokens (greedy {pin['exact']} exact); beat "
        f"age {live['beat_age_s'] * 1e3:.1f} ms; fail_inflight failed "
        f"{failed}, raised {raised}")
    return {"checks": checks, "aborted_tokens": len(aborted.tokens),
            "hot_swap_pin": pin, "beat_age_s": live["beat_age_s"]}


def serving_http(params, cfg) -> dict:
    """(e) the HTTP server on an ephemeral port: three generations,
    /metrics against stats(), and 429 from a full queue (the scheduler
    held in a delay fault while the queue fills)."""
    import urllib.error
    import urllib.request

    from determined_clone_tpu_torch import faults
    from determined_clone_tpu_torch.serving.http import (
        ServingHTTPServer,
        generate_over_http,
    )
    from determined_clone_tpu_torch.telemetry.metrics import (
        parse_prometheus_text,
    )

    prompts = prompts_of(SERVE["spec_lengths"][:3], cfg.vocab_size, 96)
    with serving_engine(params, cfg, serving_config()) as eng, \
            ServingHTTPServer(eng) as srv:
        outs = [generate_over_http(srv.url, p, max_new_tokens=SERVE["new"])
                for p in prompts]
        with urllib.request.urlopen(f"{srv.url}/metrics", timeout=60) as r:
            text = r.read().decode()
        eng.wait_idle()
        stats = eng.stats()
    values = {n: v for n, labels, v in parse_prometheus_text(text)["samples"]
              if not labels}

    class _R:
        def __init__(self, out):
            self.tokens, self.request_id = out["tokens"], out["request_id"]
    pin = check_greedy(params, cfg, prompts, [_R(o) for o in outs],
                       **pin_rule(cfg))
    delay = {"rules": [{"point": "engine.step", "action": "delay",
                        "delay_s": 3.0}]}
    with serving_engine(params, cfg, serving_config(max_queue_depth=1)) \
            as eng, ServingHTTPServer(eng) as srv, faults.plan_active(delay):
        first = eng.submit(prompts[0], 4)
        while not eng.stats().peak_active:
            time.sleep(0.001)
        second = eng.submit(prompts[1], 4)  # fills the queue
        req = urllib.request.Request(
            f"{srv.url}/v1/generate", data=json.dumps(
                {"prompt": prompts[2], "max_new_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=60)
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
        first.result(timeout=600), second.result(timeout=600)
    checks = {
        "http: three generations return their tokens (phase-4 rule)": all(
            len(o["tokens"]) == SERVE["new"]
            and "spec_acceptance" in o["latency"] for o in outs)
        and pinned(pin, [_R(o) for o in outs]),
        "http: /metrics parses and agrees with stats()": (
            values["serving_requests_completed_total"] == stats.completed
            == 3 and values["serving_tokens_generated_total"]
            == stats.tokens_generated
            and values["serving_free_kv_blocks"] == stats.free_blocks),
        "http: a full queue answers 429": code == 429,
    }
    log(f"[serving] (e) http: 3 generations (greedy {pin['exact']} exact, "
        f"{pin['near_ties']} near ties), /metrics completed "
        f"{values['serving_requests_completed_total']:.0f} tokens "
        f"{values['serving_tokens_generated_total']:.0f}; full queue -> "
        f"{code}")
    return {"checks": checks, "pin": pin, "overload_code": code}


def serving_warmup(params, params2, cfg, scaled, lines) -> dict:
    """(f) the phase-4 burst with prefix cache, chunking and speculation
    on, on a cold engine and on one warmed by CUDA-graph capture; then
    hot_swap on the warmed engine."""
    import torch

    from determined_clone_tpu_torch.models import gpt

    lane = lane_name(cfg, scaled)
    prompts = prompts_of(SERVE["burst"], cfg.vocab_size, 0)
    new, layers = SERVE["new"], SERVE["draft_layers"]
    draft, _ = gpt.slice_prefix_layers(params, cfg, layers)
    scfg = serving_config(prefix_cache=True, chunk_prefill_len=SERVE["chunk"],
                          speculative=spec_block(cfg, SERVE["spec_k"],
                                                 layers))

    def run(eng, label):
        res = burst(eng, prompts, new)
        eng.flush_prefix_cache()
        prof = profile_window(lambda: burst(eng, prompts, new),
                              f"serving burst, {lane}, {label}", lines)
        eng.flush_prefix_cache()
        return res[0], {
            "tokens_per_s": sum(len(r.tokens) for r in res[0]) / res[1],
            "wall_s": res[1], "p50_ms": res[2] * 1e3, "p99_ms": res[3] * 1e3,
            "device_ms": prof["device_ms"],
            "busy_share": prof["device_ms"] / 1e3 / res[1]}

    with serving_engine(params, cfg, scfg, draft_params=draft) as eng:
        eng.generate([1, 2, 3], 2)  # first calls: cuBLAS handles, allocator
        eng.flush_prefix_cache()
        cold_res, cold = run(eng, "cold (eager)")
        cold_calls = eng.program_calls()
    del eng
    with serving_engine(params, cfg, scfg, draft_params=draft) as eng:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        programs = eng.warmup()
        warm_s = time.monotonic() - t0
        budget = eng.program_budget()
        mem = {"allocated_before_gib": mem0 / 2 ** 30,
               "allocated_after_gib": torch.cuda.memory_allocated() / 2 ** 30,
               "reserved_after_gib": torch.cuda.memory_reserved() / 2 ** 30}
        calls0 = eng.program_calls()
        warm_res, warm = run(eng, "warm (graph replays)")
        calls1 = eng.program_calls()
        eng.hot_swap(params2)
        swapped = eng.generate(prompts[3], new, timeout=900)
        calls2 = eng.program_calls()
        eng.wait_idle()
        eng.assert_kv_balanced(eng.stats().prefix_cached_entries)
    pin = check_greedy(params, cfg, prompts, cold_res, **pin_rule(cfg))
    pin_swap = check_greedy(params2, cfg, [prompts[3]], [swapped],
                            **pin_rule(cfg))
    burst_calls = {k: calls1[k] - calls0[k] for k in calls0}
    swap_calls = {k: calls2[k] - calls1[k] for k in calls1}
    checks = {
        f"warmup ({lane}): programs_compiled() == program_budget()": (
            programs == budget),
        f"warmup ({lane}): the warm burst ran graph replays only": (
            burst_calls["eager"] == 0 and burst_calls["replays"] > 0),
        f"warmup ({lane}): the warm burst's tokens are the cold engine's": [
            r.tokens for r in warm_res] == [r.tokens for r in cold_res],
        f"warmup ({lane}): the cold burst follows the greedy loop (phase-4 "
        f"rule)": pinned(pin, cold_res),
        f"warmup ({lane}): hot_swap after warmup serves the new weights "
        f"(phase-4 rule), by replays only": pinned(pin_swap, [swapped])
        and swap_calls["eager"] == 0,
    }
    log(f"[serving] (f) warmup, {lane}: {programs} programs (budget "
        f"{budget}) in {warm_s:.2f} s; memory {mem}")
    for label, r in (("cold", cold), ("warm", warm)):
        log(f"[serving] (f) burst {label}, {lane}: {r['tokens_per_s']:.1f} "
            f"tokens/s, p50 {r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms, "
            f"device {r['device_ms']:.1f} ms, busy share "
            f"{r['busy_share']:.3f}")
    log(f"[serving] (f) {lane}: warm burst calls {burst_calls} (cold engine "
        f"{cold_calls}); greedy {pin['exact']} exact, {pin['near_ties']} "
        f"near ties, echo share {echo_share(prompts, cold_res):.3f}; "
        f"hot_swap after warmup: calls {swap_calls}, greedy "
        f"{pin_swap['exact']} exact, {pin_swap['near_ties']} near ties")
    return {"checks": checks, "programs": programs, "budget": budget,
            "warmup_s": warm_s, "memory": mem, "cold": cold, "warm": warm,
            "warm_burst_calls": burst_calls, "cold_calls": cold_calls,
            "pin": pin, "hot_swap_pin": pin_swap}


def phase_serving(params, cfg) -> dict:
    """Phase 9: the serving features at ``cfg``'s width, each part's
    checks failing the run; the flash kernel's launch count set to 0
    before and read after (the paged forward attends through ``mha``).
    (a), (b) and (f) run twice: on ``params`` in ``cfg``'s bf16 under the
    phase-4 rule, and on ``branch_scaled(params)`` in fp32 token for
    token, where the context decides the tokens."""
    import torch

    from determined_clone_tpu_torch.models import gpt
    from determined_clone_tpu_torch.ops.flash_attention import flash_attention

    params2 = gpt.init(torch.Generator(device="cuda").manual_seed(1), cfg)
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    scaled, scaled2 = branch_scaled(params), branch_scaled(params2)
    lines: list = []
    flash_attention.launches = 0
    t0 = time.monotonic()
    parts = {}
    with torch.no_grad():
        parts["prefix"] = serving_prefix(params, cfg, False)
        parts["prefix_fp32_scaled"] = serving_prefix(scaled, cfg32, True)
        parts["prefix_bf16_scaled"] = serving_prefix_witness(scaled, cfg)
        parts["chunked"] = serving_chunked(params, cfg, False)
        parts["chunked_fp32_scaled"] = serving_chunked(scaled, cfg32, True)
        parts["speculative"] = serving_speculative(params, cfg)
        parts["lifecycle"] = serving_lifecycle(params, params2, cfg)
        parts["http"] = serving_http(params, cfg)
        parts["warmup"] = serving_warmup(params, params2, cfg, False, lines)
        parts["warmup_fp32_scaled"] = serving_warmup(scaled, scaled2, cfg32,
                                                     True, lines)
    wall = time.monotonic() - t0
    launches = flash_attention.launches
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_profile.txt"), "a") as f:
        f.write("\n" + "\n".join(lines))
    checks = {}
    for part in parts.values():
        checks.update(part.pop("checks"))
    checks["no flash launch in phase 9"] = launches == 0
    for name, ok in checks.items():
        log(f"[serving] check {'ok' if ok else 'FAILED'}: {name}")
    log(f"[serving] phase 9 wall {wall:.1f} s; flash launches {launches}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 9 checks failed: {failed}")
    return {**parts, "flash_launches": launches, "wall_s": wall,
            "checks": checks}


# -- phase 10: the fleet ------------------------------------------------------

FLEET = {"replicas": 3, "systems": 3, "per_system": 8, "system": 96,
         "tails": (8, 40), "new": 32, "seed": 100}
# chaos's own scenarios, run on the card (torn_warmstart waits with the
# XLA executable cache)
CHAOS_SCENARIOS = ("kill_replica_mid_decode", "wedged_scheduler",
                   "double_fault", "poison_pill", "kv_warm_failover",
                   "deadline_storm")


def fleet_traffic(vocab, seed):
    """(a)'s requests: ``FLEET["systems"]`` system prompts of
    ``FLEET["system"]`` tokens with ``FLEET["per_system"]`` requests each,
    every request with its own 8–40-token tail; interleaved by system,
    so the first ``systems`` requests open one system prompt each.
    Returns (prompts, system index per prompt)."""
    import numpy as np

    n, per = FLEET["systems"], FLEET["per_system"]
    systems = prompts_of([FLEET["system"]] * n, vocab, seed)
    lengths = np.linspace(*FLEET["tails"], per).astype(int).tolist()
    tails = prompts_of(lengths * n, vocab, seed + 1)
    prompts, groups = [], []
    for j in range(per):
        for s in range(n):
            prompts.append(systems[s] + tails[s * per + j])
            groups.append(s)
    return prompts, groups


def tier_store(tmp, host_budget=256 << 20):
    """A host tier over a CAS tier in ``tmp`` (a fresh directory)."""
    from determined_clone_tpu_torch.serving import KVBlockStore
    from determined_clone_tpu_torch.storage import SharedFSStorageManager
    from determined_clone_tpu_torch.storage.cas import KVBlobStore

    return KVBlockStore(budget_bytes=host_budget, blob_store=KVBlobStore(
        SharedFSStorageManager(tmp)))


def device_memory():
    import torch

    return {"allocated_gib": torch.cuda.memory_allocated() / 2 ** 30,
            "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}


def make_fleet(params, cfg, n, store, lines=None, **kw):
    """A ServingFleet of ``n`` replicas, each as phase 9's engines are
    configured (``serving_config``) with the prefix cache and the tiers
    of ``store``, and phase 9's chunked prefill (a prompt may be longer
    than the largest prefill bucket); device memory after each
    scale_up."""
    import math

    from determined_clone_tpu_torch.serving import (
        BucketSpec,
        KVCacheConfig,
        ServingFleet,
    )

    scfg = serving_config(prefix_cache=True, chunk_prefill_len=SERVE["chunk"])
    buckets = BucketSpec.build(scfg.max_batch, min(scfg.max_prefill_len,
                                                   cfg.max_seq_len))
    blocks = scfg.kv_blocks or scfg.max_batch * max(
        1, math.ceil(cfg.max_seq_len / scfg.kv_block_size))
    fleet = ServingFleet(params, cfg, buckets=buckets,
                         cache=KVCacheConfig(num_blocks=blocks,
                                             block_size=scfg.kv_block_size),
                         max_queue_depth=scfg.max_queue_depth,
                         prefix_cache=True,
                         chunk_prefill_len=scfg.chunk_prefill_len,
                         kv_store=store, device="cuda",
                         **kw)
    mem = []
    for _ in range(n):
        fleet.scale_up(1)
        mem.append(device_memory())
    if lines is not None:
        lines.append(mem)
    return fleet


def fleet_requests(fleet, prompts, new, tag, timeout=900):
    """Every prompt through the front door (``handle_request``) at once,
    one thread each; (results, replica ids, wall s, front-door latencies)."""
    import threading

    out = [None] * len(prompts)

    def one(i):
        t0 = time.monotonic()
        try:
            res, handle = fleet.handle_request(
                prompts[i], new, request_id=f"{tag}-{i}", timeout=timeout)
            out[i] = (res, handle.replica_id, time.monotonic() - t0)
        except Exception as exc:  # noqa: BLE001 — checked by the caller
            out[i] = (exc, None, time.monotonic() - t0)

    t0 = time.monotonic()
    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 60)
    wall = time.monotonic() - t0
    failed = [f"{tag}-{i}: {o[0]!r}" for i, o in enumerate(out)
              if o is None or isinstance(o[0], BaseException)]
    if failed:
        raise AssertionError(f"fleet requests failed: {failed[:4]}")
    return ([o[0] for o in out], [o[1] for o in out], wall,
            [o[2] for o in out])


def fleet_run(fleet, prompts, new, tag):
    """(a)'s traffic: the first request of each system prompt one after
    another (each then rests on one replica), the rest at once. Returns
    results, replica ids, tokens/s, p50/p99 ms over all requests, and
    the wall s."""
    import numpy as np

    n = FLEET["systems"]
    t0 = time.monotonic()
    first = [fleet_requests(fleet, [p], new, f"{tag}-open{i}")
             for i, p in enumerate(prompts[:n])]
    rest = fleet_requests(fleet, prompts[n:], new, tag)
    wall = time.monotonic() - t0
    results = [f[0][0] for f in first] + rest[0]
    reps = [f[1][0] for f in first] + rest[1]
    lat = [f[3][0] for f in first] + rest[3]
    return {"results": results, "replicas": reps, "wall_s": wall,
            "tokens_per_s": sum(len(r.tokens) for r in results) / wall,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}


def affinity_of(groups, reps):
    """Per system prompt, the replicas that served its requests, and
    whether one replica served most of them."""
    import collections

    per = {}
    for g, r in zip(groups, reps):
        per.setdefault(g, collections.Counter())[r] += 1
    share = {g: c.most_common(1)[0][1] / sum(c.values())
             for g, c in per.items()}
    return {g: dict(c) for g, c in per.items()}, share


def fleet_lane(params, cfg, n, lines, tmp, tag) -> dict:
    """(a) at one width: a fleet of ``n`` replicas serving the traffic
    once timed and once, with other tokens of the same shape, under the
    profiler (busy share = its kernel time over the timed wall)."""
    prompts, groups = fleet_traffic(cfg.vocab_size, FLEET["seed"])
    other, _ = fleet_traffic(cfg.vocab_size, FLEET["seed"] + 50)
    mem = []
    fleet = make_fleet(params, cfg, n, tier_store(tmp), mem)
    fleet.handle_request([1, 2, 3], 2)  # cuBLAS handles, allocator
    run = fleet_run(fleet, prompts, FLEET["new"], f"{tag}-a")
    prof = profile_window(
        lambda: fleet_run(fleet, other, FLEET["new"], f"{tag}-b"),
        f"fleet traffic, {tag}", lines)
    busy = prof["device_ms"] / 1e3 / run["wall_s"]
    run.update(busy_share=busy, memory=mem, prompts=prompts, groups=groups)
    return fleet, run


def equal_bits(a, b) -> bool:
    import torch

    return torch.equal(a.flatten().view(torch.uint8),
                       b.flatten().view(torch.uint8))


def tier_round_trip(fleet, prompt) -> dict:
    """(b): the replica holding ``prompt``'s first block spills every
    resident block (``flush_kv_to_tier``); another replica, its resident
    blocks dropped, serves ``prompt`` by promoting them into its own
    pool. Every promoted block's K and V equal the source's bit for
    bit."""
    from determined_clone_tpu_torch.serving.kv_store import prompt_chain_keys

    bs = fleet.cache.block_size
    keys = [bytes.fromhex(k) for k in prompt_chain_keys(
        prompt, bs, len(prompt) // bs)]
    src = dst = None
    for rep in fleet.replicas():
        resident = {k for k, _b, _d in rep.engine._prefix.entries()}
        if src is None and keys[0] in resident:
            src = rep
        elif dst is None:
            dst = rep
    for rep in (src, dst):
        rep.engine.wait_idle()
    spilled = src.engine.flush_kv_to_tier()
    dst.engine.flush_prefix_cache()
    before = dst.engine.stats()
    dst.submit(prompt, 1).result(timeout=900)
    dst.engine.wait_idle()
    after = dst.engine.stats()
    src_blocks = {k: b for k, b, _d in src.engine._prefix.entries()}
    dst_blocks = {k: b for k, b, _d in dst.engine._prefix.entries()}
    moved = [k for k in keys if k in src_blocks and k in dst_blocks]
    same = all(
        equal_bits(getattr(src.engine, pool)[:, src_blocks[k]],
                   getattr(dst.engine, pool)[:, dst_blocks[k]])
        for k in moved for pool in ("_k_pool", "_v_pool"))
    block_bytes = 2 * src.engine._k_pool[:, 0].nbytes
    return {"src": src.replica_id, "dst": dst.replica_id,
            "spilled": spilled,
            "promoted": after.kv_promoted_blocks - before.kv_promoted_blocks,
            "host_hits": after.kv_host_hit_blocks
            - before.kv_host_hit_blocks,
            "moved": len(moved), "blocks": len(keys), "bit_equal": same,
            "block_bytes": block_bytes,
            "pairs": [(src_blocks[k], dst_blocks[k]) for k in moved]}


def fleet_kv_counters(fleet):
    """The replicas' kv_tier_* counters, summed."""
    tot = {"host": 0, "cas": 0, "miss": 0, "promoted": 0, "spilled": 0}
    for rep in fleet.replicas():
        st = rep.engine.stats()
        tot["host"] += st.kv_host_hit_blocks
        tot["cas"] += st.kv_cas_hit_blocks
        tot["miss"] += st.kv_miss_blocks
        tot["promoted"] += st.kv_promoted_blocks
        tot["spilled"] += st.kv_spilled_blocks
    return tot


def fleet_http(fleet, params, cfg, prompt, tmp) -> dict:
    """(g): FleetHTTPServer over ``fleet``: /v1/generate, /metrics (the
    replicas' KV counters summed equal kv_stats()), /v1/fleet,
    /v1/scale to one replica fewer, /v1/rollout of a checkpoint of
    ``params`` written by ``save_pytree``."""
    import urllib.request

    from determined_clone_tpu_torch.core._serialization import save_pytree
    from determined_clone_tpu_torch.serving.http import (
        FleetHTTPServer,
        generate_over_http,
    )
    from determined_clone_tpu_torch.telemetry.metrics import (
        parse_prometheus_text,
    )

    def get(url):
        with urllib.request.urlopen(url, timeout=600) as r:
            return r.status, r.read().decode()

    def post(url, body):
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, json.loads(r.read().decode())

    ckpt = os.path.join(tmp, "ckpt")
    save_pytree(ckpt, params)
    n0 = len(fleet.replica_ids())
    with FleetHTTPServer(fleet) as srv:
        gen = generate_over_http(srv.url, prompt, FLEET["new"], timeout=900)
        for rep in fleet.replicas():
            rep.engine.wait_idle()
        code_m, text = get(f"{srv.url}/metrics")
        kv = fleet.kv_stats()
        summed = fleet_kv_counters(fleet)
        sums = {}
        for name, labels, v in parse_prometheus_text(text)["samples"]:
            if name.startswith("kv_tier_") and str(
                    labels.get("component", "")).startswith(
                        "serving_replica_"):
                sums[name] = sums.get(name, 0.0) + v
        code_f, view = get(f"{srv.url}/v1/fleet")
        view = json.loads(view)
        code_s, scaled = post(f"{srv.url}/v1/scale", {"replicas": n0 - 1})
        t0 = time.monotonic()
        code_r, report = post(f"{srv.url}/v1/rollout", {"checkpoint": ckpt})
        rollout_s = time.monotonic() - t0
        after = generate_over_http(srv.url, prompt, FLEET["new"],
                                   timeout=900)
    metrics_ok = (
        code_m == 200
        and sums.get("kv_tier_host_hit_blocks_total") == kv["host_hits"]
        == summed["host"]
        and sums.get("kv_tier_cas_hit_blocks_total") == kv["cas_hits"]
        == summed["cas"]
        and sums.get("kv_tier_miss_blocks_total") == kv["misses"]
        == summed["miss"]
        and sums.get("kv_tier_spilled_blocks_total")
        == kv["puts"] + kv["duplicate_puts"] == summed["spilled"]
        and sums.get("kv_tier_promoted_blocks_total") == summed["promoted"])
    return {"generate": gen, "after_rollout": after, "metrics_ok": metrics_ok,
            "sums": sums, "kv": {k: kv[k] for k in (
                "host_hits", "cas_hits", "misses", "puts", "duplicate_puts",
                "entries", "bytes")},
            "fleet_ok": code_f == 200 and view["name"] == fleet.name
            and view["kv_tier"] is not None
            and len(view["replicas"]) == n0,
            "scale_ok": code_s == 200 and len(scaled["replicas"]) == n0 - 1,
            "rollout_ok": code_r == 200 and len(report["order"]) == n0 - 1
            and len(report["probe_output"]) == 8,
            "rollout_s": rollout_s}


def drain_mid_burst(fleet, prompts, new, tag) -> dict:
    """(d): the traffic at once; once the first request is running,
    ``scale_down(1)`` drains the newest replica (it finishes what it
    accepted, takes nothing new) while the rest is served."""
    import threading

    box = {}

    def shrink():
        while not any(rep.engine.stats().tokens_generated
                      > box.get("t0", {}).get(rep.replica_id, 0)
                      for rep in fleet.replicas()):
            time.sleep(0.001)
        t0 = time.monotonic()
        box["removed"] = fleet.scale_down(1)
        box["drain_s"] = time.monotonic() - t0

    box["t0"] = {rep.replica_id: rep.engine.stats().tokens_generated
                 for rep in fleet.replicas()}
    t = threading.Thread(target=shrink, daemon=True)
    t.start()
    res = fleet_requests(fleet, prompts, new, tag)
    t.join(900)
    return {"results": res[0], "replicas": res[1], **box}


def capture_beside_traffic(fleet, prompts, new, tag) -> dict:
    """(f): ``scale_up(1)`` — engine build and warmup, which captures the
    new replica's graphs — while the traffic runs over and over through
    the front door, from before the scale_up starts until after it ends
    (the case the autoscaler meets). The programs the other replicas ran
    during the warmup are counted (the capture really ran beside their
    replays), and the warmup's seconds are set beside those of the first
    replica's, captured alone. Then the new replica alone serves the
    traffic through its own ``submit``, so its graphs are held to the
    reference."""
    import threading

    from determined_clone_tpu_torch.serving import engine as eng_mod

    others = fleet.replicas()

    def calls():
        return sum(sum(rep.engine.program_calls().values())
                   for rep in others)

    windows = []
    orig = eng_mod.InferenceEngine.warmup

    def watched(self):
        c0, t0 = calls(), time.monotonic()
        n = orig(self)
        windows.append({"s": time.monotonic() - t0,
                        "calls_beside": calls() - c0, "programs": n,
                        "budget": self.program_budget()})
        return n

    stop = threading.Event()
    waves = []  # (start, end, results or the exception)

    def traffic():
        while not stop.is_set():
            t0 = time.monotonic()
            try:
                res = fleet_requests(fleet, prompts, new,
                                     f"{tag}-{len(waves)}")[0]
            except Exception as exc:  # noqa: BLE001 — checked by the caller
                res = exc
            waves.append((t0, time.monotonic(), res))
            if isinstance(res, BaseException):
                return

    alone = others[0].registry.histogram(
        "serving_warmup_seconds",
        "whole program ladder readied (graphs captured) at startup")
    t = threading.Thread(target=traffic, daemon=True)
    c0 = fleet.stats().tokens_generated
    eng_mod.InferenceEngine.warmup = watched
    try:
        t.start()
        while fleet.stats().tokens_generated == c0 and t.is_alive():
            time.sleep(0.001)
        t0 = time.monotonic()
        added = fleet.scale_up(1)
        t1 = time.monotonic()
    finally:
        stop.set()
        eng_mod.InferenceEngine.warmup = orig
    t.join(1800)
    unbroken = (bool(waves) and not t.is_alive() and waves[0][0] <= t0
                and waves[-1][1] >= t1
                and all(b[0] >= a[1] for a, b in zip(waves, waves[1:]))
                and all(b[0] - a[1] < 1.0 for a, b in zip(waves, waves[1:])))
    rep = next(r for r in fleet.replicas() if r.replica_id in added)
    handles = [rep.submit(p, new, request_id=f"{tag}-solo-{i}")
               for i, p in enumerate(prompts)]
    solo = [h.result(timeout=900) for h in handles]
    return {"added": added, "windows": windows, "scale_up_s": t1 - t0,
            "waves": [w[2] for w in waves], "unbroken": unbroken,
            "new_replica": rep.replica_id, "solo": solo,
            "warmup_alone_s": alone.sum / max(alone.count, 1)}


def warm_replacement(fleet, prompts, groups, new, tag, cold_prompt) -> dict:
    """(c): one replica made to hold every system prompt (one request of
    each sent to it directly), the others stopped through the drain
    protocol, then ``replace_replica`` on it (flush to the tiers, warmup
    of the replacement). The replacement serves one system prompt's
    request alone (its blocks promoted: time to first token) and a cold
    prompt of the same length, then the whole traffic."""
    n = FLEET["systems"]
    keep = fleet.replicas()[0]
    for p in prompts[:n]:
        keep.submit(p, 1).result(timeout=900)
    for rep in fleet.replicas()[1:]:
        fleet.stop_replica(rep.replica_id)
    keep.engine.wait_idle()
    t0 = time.monotonic()
    new_ids = fleet.replace_replica(keep.replica_id, reason="replace")
    replace_s = time.monotonic() - t0
    rep = fleet.replicas()[0]

    def ttft(p):
        r = rep.submit(p, new).result(timeout=900)
        return r, r.total_s - r.decode_s

    promoted, ttft_promoted = ttft(prompts[0])
    cold, ttft_cold = ttft(cold_prompt)
    run = fleet_requests(fleet, prompts, new, tag)
    st = rep.engine.stats()
    return {"replacement": new_ids, "replace_s": replace_s,
            "results": run[0], "ttft_promoted_ms": ttft_promoted * 1e3,
            "ttft_cold_ms": ttft_cold * 1e3,
            "first": promoted, "cold": cold,
            "kv": {"host": st.kv_host_hit_blocks, "cas": st.kv_cas_hit_blocks,
                   "miss": st.kv_miss_blocks,
                   "promoted": st.kv_promoted_blocks},
            "incident": fleet.last_incident()}


def rollout_under_load(fleet, prompts, new, params2, tag) -> dict:
    """(e): ``rollout(params2)`` (drain and swap replica by replica,
    canary first) while the traffic runs over and over, from before the
    rollout starts until after it ends."""
    import threading

    box = {}
    stop = threading.Event()
    waves = []

    def traffic():
        while not stop.is_set():
            waves.append(fleet_requests(fleet, prompts, new,
                                        f"{tag}-{len(waves)}")[0])

    t = threading.Thread(target=traffic, daemon=True)
    c0 = fleet.stats().tokens_generated
    t.start()
    while fleet.stats().tokens_generated == c0:
        time.sleep(0.001)
    t0 = time.monotonic()
    try:
        box["report"] = fleet.rollout(params2, drain_timeout=900)
    except Exception as exc:  # noqa: BLE001 — checked by the caller
        box["error"] = repr(exc)
    box["s"] = time.monotonic() - t0
    n = len(waves)
    while len(waves) <= n and t.is_alive():  # one wave wholly after it
        time.sleep(0.01)
    stop.set()
    t.join(1800)
    return {"results": [r for w in waves for r in w], **box}


def reference_tokens(params, cfg, prompts, new, params2=None):
    """One engine's greedy tokens for every prompt (and, with
    ``params2``, after hot_swap to them): the fleet's references."""
    from determined_clone_tpu_torch.serving import InferenceEngine

    scfg = serving_config(prefix_cache=True, chunk_prefill_len=SERVE["chunk"])
    out = []
    with InferenceEngine.from_serving_config(params, cfg, scfg,
                                             device="cuda") as eng:
        eng.warmup()
        for version in ([params] if params2 is None else [params, params2]):
            if version is not params:
                eng.hot_swap(version)
            hs = [eng.submit(p, new) for p in prompts]
            out.append([h.result(timeout=900).tokens for h in hs])
    return out


def phase_fleet(params, cfg) -> dict:
    """Phase 10: the fleet at ``cfg``'s width, each check failing the
    run; the flash kernel's launch count set to 0 before and read after
    (the paged forward attends through ``mha``)."""
    import tempfile

    import torch

    from determined_clone_tpu_torch.models import gpt
    from determined_clone_tpu_torch.ops.flash_attention import flash_attention
    from determined_clone_tpu_torch.serving.chaos import run_scenarios

    new = FLEET["new"]
    params2 = gpt.init(torch.Generator(device="cuda").manual_seed(1), cfg,
                       device="cuda")
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    scaled, scaled2 = branch_scaled(params), branch_scaled(params2)
    smi = card_line()
    lines: list = []
    checks = {}
    out = {}
    flash_attention.launches = 0
    t_phase = time.monotonic()
    parts_s = {}
    last = [t_phase]

    def mark(name):
        now = time.monotonic()
        parts_s[name] = round(now - last[0], 2)
        last[0] = now

    with tempfile.TemporaryDirectory(prefix="fleet-") as tmp, \
            torch.no_grad():
        # (a) bf16, fresh weights: 1 and 3 replicas on the same traffic
        lanes = {}
        for n in (1, FLEET["replicas"]):
            fleet, run = fleet_lane(params, cfg, n, lines,
                                    os.path.join(tmp, f"bf16-{n}"),
                                    f"bf16 x{n}")
            pins = [check_greedy(params, cfg,
                                 [p for p, g in zip(run["prompts"],
                                                    run["groups"]) if g == s],
                                 [r for r, g in zip(run["results"],
                                                    run["groups"]) if g == s],
                                 **pin_rule(cfg))
                    for s in range(FLEET["systems"])]
            run["pins"] = pins
            lanes[n] = run
            checks[f"fleet (a) bf16 x{n}: every request follows the greedy "
                   f"loop (phase-4 rule, per system prompt)"] = all(
                pinned(pin, [r for r, g in zip(run["results"], run["groups"])
                             if g == s]) for s, pin in enumerate(pins))
            if n == 1:
                fleet.close()
                mark("bf16 x1")
                continue
            per, share = affinity_of(run["groups"], run["replicas"])
            run["affinity"], run["affinity_share"] = per, share
            run["prefix_hits"] = {
                rep.replica_id: rep.engine.stats().prefix_hit_blocks
                for rep in fleet.replicas()}
            checks["fleet (a) bf16: each system prompt served mostly by "
                   "one replica"] = all(v > 0.5 for v in share.values())
            rt = tier_round_trip(fleet, run["prompts"][0])
            out["round_trip_bf16"] = rt
            checks["fleet (b) bf16: a spilled block promoted into another "
                   "replica's pool is equal bit for bit"] = (
                rt["src"] != rt["dst"] and rt["bit_equal"]
                and rt["moved"] == rt["blocks"] == rt["promoted"]
                == rt["host_hits"] > 0)
            http = fleet_http(fleet, params, cfg, run["prompts"][1],
                              os.path.join(tmp, "http"))
            hpin = check_greedy(params, cfg, [run["prompts"][1]] * 2, [
                _Tok(http["generate"]), _Tok(http["after_rollout"])],
                **pin_rule(cfg))
            out["http"] = http
            checks["fleet (g) http: /v1/generate (phase-4 rule, before and "
                   "after /v1/rollout), /v1/fleet, /v1/scale, /v1/rollout"] = (
                pinned(hpin, [_Tok(http["generate"]),
                              _Tok(http["after_rollout"])])
                and http["fleet_ok"] and http["scale_ok"]
                and http["rollout_ok"])
            checks["fleet (g) http: the KV counters in /metrics equal "
                   "kv_stats()"] = http["metrics_ok"]
            fleet.close()
            mark(f"bf16 x{n}")
        out["bf16"] = {n: {k: v for k, v in r.items()
                           if k not in ("results", "prompts", "groups")}
                       for n, r in lanes.items()}

        # fp32 on branch_scaled weights: tokens depend on the context
        prompts, groups = fleet_traffic(cfg.vocab_size, FLEET["seed"])
        ref, ref2 = reference_tokens(scaled, cfg32, prompts, new, scaled2)
        checks["fleet: the two versions' references differ"] = all(
            a != b for a, b in zip(ref, ref2))
        mark("fp32 references")
        mem = []
        fleet = make_fleet(scaled, cfg32, FLEET["replicas"],
                           tier_store(os.path.join(tmp, "fp32")), mem)
        run = fleet_run(fleet, prompts, new, "fp32-a")
        per, share = affinity_of(groups, run["replicas"])
        out["fp32_a"] = {"tokens_per_s": run["tokens_per_s"],
                         "p50_ms": run["p50_ms"], "p99_ms": run["p99_ms"],
                         "affinity": per, "memory": mem}
        checks["fleet (a) fp32 scaled: every request's tokens equal one "
               "engine's"] = [r.tokens for r in run["results"]] == ref
        rt = tier_round_trip(fleet, prompts[0])
        out["round_trip_fp32"] = rt
        checks["fleet (b) fp32: a spilled block promoted into another "
               "replica's pool is equal bit for bit"] = (
            rt["src"] != rt["dst"] and rt["bit_equal"]
            and rt["moved"] == rt["blocks"] == rt["promoted"] > 0)
        mark("fp32 (a), (b)")
        d = drain_mid_burst(fleet, prompts, new, "fp32-d")
        out["drain"] = {"removed": d["removed"], "drain_s": d["drain_s"]}
        checks["fleet (d) drain: scale_down mid-burst drops nothing, every "
               "token right"] = (
            [r.tokens for r in d["results"]] == ref
            and len(d["removed"]) == 1
            and len(fleet.replica_ids()) == FLEET["replicas"] - 1)
        mark("(d)")
        f = capture_beside_traffic(fleet, prompts, new, "fp32-f")
        waves = f["waves"]
        out["capture"] = {"windows": f["windows"],
                          "scale_up_s": f["scale_up_s"],
                          "waves": len(waves), "unbroken": f["unbroken"],
                          "warmup_alone_s": f["warmup_alone_s"],
                          "memory": device_memory()}
        checks["fleet (f) capture: scale_up's warmup captured every graph "
               "while the other replicas served traffic that never "
               "paused"] = (
            len(f["added"]) == 1 and len(f["windows"]) == 1
            and f["windows"][0]["programs"] == f["windows"][0]["budget"]
            and f["windows"][0]["calls_beside"] > 0 and f["unbroken"])
        checks["fleet (f) capture: the traffic's tokens are unchanged"] = (
            all(not isinstance(w, BaseException)
                and [r.tokens for r in w] == ref for w in waves))
        checks["fleet (f) capture: the new replica's graphs serve every "
               "request's tokens alone"] = (
            [r.tokens for r in f["solo"]] == ref)
        mark("(f)")
        cold = prompts_of([len(prompts[0])], cfg.vocab_size, 777)[0]
        c = warm_replacement(fleet, prompts, groups, new, "fp32-c", cold)
        shared = FLEET["systems"] * (FLEET["system"] // fleet.cache.block_size)
        out["replace_host"] = {k: c[k] for k in (
            "replacement", "replace_s", "ttft_promoted_ms", "ttft_cold_ms",
            "kv")}
        checks["fleet (c) replacement: equal tokens, kv_host_hit >= the "
               "shared blocks"] = (
            [r.tokens for r in c["results"]] == ref
            and c["first"].tokens == ref[0] and c["kv"]["host"] >= shared)
        mark("(c) host")
        fleet.scale_up(FLEET["replicas"] - 1)
        e = rollout_under_load(fleet, prompts, new, scaled2, "fp32-e")
        toks = [r.tokens for r in e["results"]]
        refs = (ref * len(toks))[:len(toks)], (ref2 * len(toks))[:len(toks)]
        one = [(t == a) != (t == b) for t, a, b in zip(toks, *refs)]
        out["rollout"] = {"s": e.get("s"), "error": e.get("error"),
                          "requests": len(toks),
                          "old": sum(t == a for t, a in zip(toks, refs[0])),
                          "new": sum(t == b for t, b in zip(toks, refs[1]))}
        checks["fleet (e) rollout under load: each request is exactly one "
               "version's (both seen), none failed, the canary passed"] = (
            all(one) and out["rollout"]["old"] > 0
            and out["rollout"]["new"] > 0 and "report" in e
            and "error" not in e)
        fleet.close()
        mark("(e)")

        # (c) again with a host budget below one block: hits from CAS
        fleet = make_fleet(scaled, cfg32, 1, tier_store(
            os.path.join(tmp, "cas"), host_budget=rt["block_bytes"] // 2))
        fleet_run(fleet, prompts, new, "cas-a")
        c2 = warm_replacement(fleet, prompts, groups, new, "cas-c", cold)
        out["replace_cas"] = {k: c2[k] for k in (
            "replacement", "replace_s", "ttft_promoted_ms", "ttft_cold_ms",
            "kv")}
        checks["fleet (c) replacement, host budget below one block: equal "
               "tokens, the hits from CAS"] = (
            [r.tokens for r in c2["results"]] == ref
            and c2["kv"]["cas"] >= shared and c2["kv"]["host"] == 0)
        fleet.close()
        mark("(c) cas")

    # (h) chaos at its own configuration
    t0 = time.monotonic()
    chaos = run_scenarios(CHAOS_SCENARIOS, device="cuda")
    out["chaos"] = {r.scenario: {"passed": r.passed,
                                 "s": round(r.duration_s, 3),
                                 "mttr_max_s": round(r.mttr_max_s, 3),
                                 "failed": [c.name for c in r.checks
                                            if not c.ok]}
                    for r in chaos}
    out["chaos_s"] = time.monotonic() - t0
    mark("(h) chaos")
    for r in chaos:
        checks[f"fleet (h) chaos: {r.scenario}"] = r.passed
    launches = flash_attention.launches
    checks["fleet (i) no flash launch in phase 10"] = launches == 0
    wall = time.monotonic() - t_phase
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_profile.txt"), "a") as fh:
        fh.write("\n" + "\n".join(str(x) for x in lines))

    for n, r in out["bf16"].items():
        busy = (f"{r['busy_share']:.3f}" if r["busy_share"] is not None
                else "not measured")
        log(f"[fleet] (a) bf16 x{n}: {r['tokens_per_s']:.1f} tokens/s, p50 "
            f"{r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms, busy share "
            f"{busy}; memory after each scale_up {r['memory']}; {smi}")
    r3 = out["bf16"][FLEET["replicas"]]
    log(f"[fleet] (a) bf16 affinity (system -> replica: requests) "
        f"{r3['affinity']}; prefix hit blocks per replica "
        f"{r3['prefix_hits']}")
    log(f"[fleet] (a) fp32 scaled x{FLEET['replicas']}: "
        f"{out['fp32_a']['tokens_per_s']:.1f} tokens/s, p50 "
        f"{out['fp32_a']['p50_ms']:.1f} ms, p99 {out['fp32_a']['p99_ms']:.1f}"
        f" ms; affinity {out['fp32_a']['affinity']}; {smi}")
    for lane in ("round_trip_bf16", "round_trip_fp32"):
        rt = out[lane]
        log(f"[fleet] (b) {lane}: {rt['src']} spilled {rt['spilled']} blocks "
            f"({rt['spilled'] * rt['block_bytes']} bytes), {rt['dst']} "
            f"promoted {rt['promoted']} ({rt['promoted'] * rt['block_bytes']}"
            f" bytes), block pairs {rt['pairs'][:3]}..., bit-equal "
            f"{rt['bit_equal']}")
    for lane in ("replace_host", "replace_cas"):
        c = out[lane]
        log(f"[fleet] (c) {lane}: replace {c['replace_s']:.2f} s; time to "
            f"first token, promoted prefix {c['ttft_promoted_ms']:.1f} ms "
            f"vs cold {c['ttft_cold_ms']:.1f} ms; kv {c['kv']}; {smi}")
    log(f"[fleet] (d) drain {out['drain']['drain_s']:.2f} s of "
        f"{out['drain']['removed']}; (e) rollout {out['rollout']}; {smi}")
    cap = out["capture"]
    log(f"[fleet] (f) warmup beside unbroken traffic {cap['windows']} "
        f"(scale_up {cap['scale_up_s']:.2f} s, {cap['waves']} waves of the "
        f"traffic); the first replica's warmup alone "
        f"{cap['warmup_alone_s']:.2f} s; memory {cap['memory']}; {smi}")
    log(f"[fleet] (f) open: a scale_up under unbroken traffic takes "
        f"{cap['scale_up_s']:.2f} s against a warmup of "
        f"{cap['warmup_alone_s']:.2f} s alone; not bounded by this script "
        f"(where the capture thread waits is not measured)")
    log(f"[fleet] (g) http /metrics kv sums {out['http']['sums']}; "
        f"kv_stats {out['http']['kv']}; rollout over http "
        f"{out['http']['rollout_s']:.2f} s")
    log(f"[fleet] (h) chaos {out['chaos']} in {out['chaos_s']:.1f} s")
    for name, ok in checks.items():
        log(f"[fleet] check {'ok' if ok else 'FAILED'}: {name}")
    log(f"[fleet] phase 10 wall {wall:.1f} s ({parts_s}); flash launches "
        f"{launches}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 10 checks failed: {failed}")
    return {**out, "flash_launches": launches, "wall_s": wall,
            "parts_s": parts_s, "checks": checks}


# ---------------------------------------------------------------------------
# Phase 11: the parallelism slice — the MoE FFN, the MoE GPT trained on a
# one-rank NCCL mesh, BASELINE #5 through the launcher's world, the MoE GPT
# served
# ---------------------------------------------------------------------------

# Switch-Base-8's widths on the GPT-2-small stack: GPTConfig(moe_experts=8)
MOE = {"tokens": 8192, "experts": 8, "k": 2, "cf": 1.25, "steps": 16}


def moe_case(params, x, dtype) -> dict:
    """(a) ``moe_ffn`` (index dispatch) against ``moe_ffn_dense`` (the JAX
    package's one-hot einsum form) on the same inputs: equal dropped
    sets, outputs within 1e-5 of the largest (fp32) or ``TOL`` (bf16);
    each form's device ms."""
    import torch

    from determined_clone_tpu_torch.ops.moe import moe_ffn, moe_ffn_dense
    from determined_clone_tpu_torch.timing import device_ms

    kw = dict(k=MOE["k"], capacity_factor=MOE["cf"], compute_dtype=dtype)
    si, sd = {}, {}
    with torch.no_grad():
        yi, ai = moe_ffn(params, x, stats=si, **kw)
        yd, ad = moe_ffn_dense(params, x, stats=sd, **kw)
        err = (yi.float() - yd.float()).abs().max().item()
        scale = yd.float().abs().max().item()
        tol = 1e-5 * scale if dtype == torch.float32 else TOL[str(dtype)]
        same_drops = torch.equal(si["keep"], sd["keep"])
        ms = device_ms(lambda: moe_ffn(params, x, **kw), iters=10, replays=3)
        dense_ms = device_ms(lambda: moe_ffn_dense(params, x, **kw), iters=3,
                             replays=2)
    dropped = 1.0 - si["keep"].float().mean().item()
    name = str(dtype).split(".")[-1]
    if not same_drops:
        raise AssertionError(f"moe {name}: the index and einsum forms drop "
                             f"different choices")
    if not err <= tol:
        raise AssertionError(f"moe {name}: index vs einsum form {err} > "
                             f"{tol}")
    if not abs(ai.item() - ad.item()) <= 1e-5:
        raise AssertionError(f"moe {name}: aux {ai.item()} vs {ad.item()}")
    log(f"[parallel] (a) moe_ffn {name} N={x.shape[0] * x.shape[1]} E="
        f"{MOE['experts']} k={MOE['k']} cf={MOE['cf']} (C={si['capacity']})"
        f": index form {ms:.3f} ms, einsum form {dense_ms:.3f} ms (device), "
        f"max |diff| {err:.3g} (tolerance {tol:.3g}), dropped choices "
        f"{dropped:.4f}, aux {ai.item():.5f}")
    return {"index_ms": ms, "einsum_ms": dense_ms, "max_abs_err": err,
            "tol": tol, "dropped_share": dropped, "aux": ai.item(),
            "capacity": si["capacity"]}


def moe_ffn_cases() -> dict:
    import torch

    from determined_clone_tpu_torch.ops.moe import moe_init

    gen = torch.Generator(device="cuda").manual_seed(11)
    params = moe_init(gen, MOE["experts"], 768, 3072, device="cuda")
    x = torch.randn((8, MOE["tokens"] // 8, 768), generator=gen,
                    device="cuda")
    return {str(dt).split(".")[-1]: moe_case(params, x, dt)
            for dt in (torch.float32, torch.bfloat16)}


def moe_dropped_share(state, cfg, tokens) -> dict:
    """The dropped share of the top-k choices, per layer, and the aux loss
    of one no-grad forward of the trained state."""
    import torch

    from determined_clone_tpu_torch.models import gpt

    shares, orig = [], gpt.moe_ffn

    def spy(*args, **kw):
        stats = {}
        out = orig(*args, stats=stats, **kw)
        shares.append(1.0 - stats["keep"].float().mean().item())
        return out

    gpt.moe_ffn = spy
    try:
        with torch.no_grad():
            _, aux = gpt._forward(state.params, cfg, tokens[:, :-1])
    finally:
        gpt.moe_ffn = orig
    return {"dropped_share_per_layer": shares,
            "dropped_share": sum(shares) / len(shares),
            "aux_per_layer": aux.item() / cfg.n_layers}


def moe_train(mesh) -> dict:
    """(b) ``GPTConfig(moe_experts=8)`` at B=8, T=1024, bf16, remat,
    ``bench.py``'s AdamW, 16 steps on one batch, the state and batch
    DTensors placed by ``GPT_SHARDING_RULES`` on the one-rank mesh."""
    import math
    import statistics

    import torch

    from determined_clone_tpu_torch.models import gpt
    from determined_clone_tpu_torch.ops.flash_attention import flash_attention
    from determined_clone_tpu_torch.parallel.sharding import (
        NamedSharding,
        batch_spec,
        to_dtensor,
    )
    from determined_clone_tpu_torch.telemetry import flops
    from determined_clone_tpu_torch.training.train_step import (
        shard_state,
        state_shardings,
    )

    cfg = gpt.GPTConfig(moe_experts=MOE["experts"])
    B, T = 8, 1024
    params = gpt.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    n_params = gpt.param_count(params)
    tokens = torch.randint(0, cfg.vocab_size, (B, T + 1), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(3))
    state, step = train_setup(cfg, params)
    state = shard_state(state, state_shardings(state, mesh,
                                               gpt.GPT_SHARDING_RULES))
    batch = to_dtensor(tokens, NamedSharding(mesh, batch_spec(1)))
    del params
    losses, windows = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # the state, and earlier phases'
    flash_attention.launches = 0
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(m["loss"])
    float(m["loss"])
    for _ in range(2):
        t0 = time.monotonic()
        for _ in range(7):
            state, m = step(state, batch)
            losses.append(m["loss"])
        float(m["loss"])
        windows.append((time.monotonic() - t0) / 7)
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).tolist()
    n = len(losses)
    per_step = 2 * cfg.n_layers
    step_s = statistics.median(windows)
    index_flops = flops.gpt_train_step_flops(cfg, B, T, moe_dispatch="index")
    einsum_flops = flops.gpt_train_step_flops(cfg, B, T)
    mfu = flops.mfu(index_flops.flops_per_sec(step_s))
    routing = moe_dropped_share(state, cfg, tokens)
    box = [state]

    def one_step():
        box[0], _ = step(box[0], batch)

    lines = []
    prof = profile_window(one_step, "MoE GPT train step B=8 T=1024", lines)
    prof["busy_share"] = prof["device_ms"] / 1e3 / step_s
    with open(os.path.join(OUT_DIR, "chip_profile.txt"), "a") as f:
        f.write("\n" + "\n".join(lines))
    del state, box
    top = ", ".join(f"{t['name'][:40]} {t['ms']:.2f} ms x{t['calls']}"
                    for t in prof["top"][:5])
    log(f"[parallel] (b) MoE GPT ({n_params} params, E={MOE['experts']} "
        f"k={cfg.moe_k} cf={cfg.moe_capacity_factor}) B={B} T={T} bf16 "
        f"remat on a one-rank NCCL mesh: {step_s * 1e3:.2f} ms/step (windows"
        f" {', '.join(f'{w * 1e3:.2f}' for w in windows)}), "
        f"{B * T / step_s:.0f} tokens/s, MFU {mfu:.4f} of 989 TFLOP/s by the "
        f"index-form count ({index_flops.total / 1e12:.3f} TFLOP/step; the "
        f"einsum form's count {einsum_flops.total / 1e12:.3f}), peak memory "
        f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} held before the first "
        f"step), flash launches {launches} "
        f"({launches // n} per step)")
    log(f"[parallel] (b) loss first {losses[0]:.4f} last {losses[-1]:.4f} "
        f"after {n} steps; dropped share {routing['dropped_share']:.4f} "
        f"(per layer {', '.join(f'{s:.3f}' for s in routing['dropped_share_per_layer'])}); "
        f"aux per layer {routing['aux_per_layer']:.5f}")
    log(f"[parallel] (b) profiled step: device {prof['device_ms']:.2f} ms, "
        f"busy share {prof['busy_share']:.3f}; {top}")
    if launches != n * per_step:
        raise AssertionError(f"MoE step: flash launched {launches} times in "
                             f"{n} steps, expected {per_step} per step")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"MoE step: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"MoE step: the loss did not fall: {losses}")
    return {"params": n_params, "batch": B, "seq": T, "steps": n,
            "step_ms": step_s * 1e3, "window_ms": [w * 1e3 for w in windows],
            "tokens_per_s": B * T / step_s, "mfu": mfu,
            "tflop_per_step_index": index_flops.total / 1e12,
            "tflop_per_step_einsum": einsum_flops.total / 1e12,
            "peak_memory_bytes": peak, "held_before_bytes": held,
            "launches": launches, "launches_per_step": launches // n,
            "losses": losses, "routing": routing, "profile": prof}


def baseline5_trial(dist, unmeshed) -> dict:
    """(c) ``examples/gpt_fsdp/fsdp.yaml`` cut as phase 7 cuts it (one
    slot, ``mesh.fsdp`` 1) through ``core.init`` → ``Trainer.fit`` on the
    one-rank NCCL world: 10 batches, the reports equal to phase 7's
    unmeshed leg at 10 bit for bit; the checkpoint's manifest in the JAX
    block layout; restored into the DTensor state equal bit for bit."""
    import json
    import shutil
    import tempfile

    import torch

    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.config import ExperimentConfig
    from determined_clone_tpu_torch.examples.gpt_fsdp import GPTTrial
    from determined_clone_tpu_torch.parallel.spmd import local_tensor
    from determined_clone_tpu_torch.training import Trainer, TrialContext
    from determined_clone_tpu_torch.training.optim import leaves

    raw = _read_yaml("examples/gpt_fsdp/fsdp.yaml")
    hp = {k: v for k, v in raw["hyperparameters"].items()}
    hp["mesh"] = {"fsdp": 1}
    storage = tempfile.mkdtemp(prefix="chip-smoke-mesh-")
    try:
        cfg = ExperimentConfig.from_dict({
            "searcher": {"name": "single", "metric": "loss",
                         "max_length": {"batches": 10}},
            "scheduling_unit": 10,
            "min_validation_period": {"batches": 10},
            "min_checkpoint_period": {"batches": 10},
            "checkpoint_storage": {"type": "shared_fs",
                                   "host_path": storage},
            "hyperparameters": hp, "resources": {"slots_per_trial": 1}})
        with core.init(config=cfg, distributed=dist, trial_id=1) as ctx:
            trial = GPTTrial(TrialContext(config=cfg, hparams=hp, core=ctx))
            mesh = trial.context.mesh
            trainer = Trainer(trial)
            t0 = time.monotonic()
            trainer.fit()
            wall = time.monotonic() - t0
            records = list(ctx.train._backend.records)
            state = trainer._final_state
            sid = ctx.checkpoint.committed_checkpoints()[0]
            with ctx.checkpoint.restore_path(sid) as path:
                with open(os.path.join(path, "state", "manifest-0.json")) as f:
                    manifest = json.load(f)
                files = sorted(os.listdir(os.path.join(path, "state")))
                loaded = core.load_pytree(os.path.join(path, "state"), state)
        # one rank: each local tensor is the whole tensor
        bitwise = all(torch.equal(local_tensor(a), local_tensor(b))
                      for a, b in zip(leaves(state.params),
                                      leaves(loaded.params)))
        table = manifest["leaves"]["0.embed.table"]
        del state, loaded, trainer, trial
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    got = {(r["group"], r["steps_completed"]): r["metrics"]["loss"]
           for r in records}
    want = {("training", 10): unmeshed["training"][0][1]["loss"],
            ("validation", 10): unmeshed["validation"][0][1]["loss"]}
    checks = {
        "(c) the mesh is the one-rank NCCL mesh of AXES": (
            mesh is not None and mesh.size() == 1
            and tuple(mesh.mesh_dim_names) == (
                "dp", "fsdp", "pp", "ep", "sp", "tp")),
        "(c) training and validation loss at 10 equal phase 7's unmeshed "
        "leg bit for bit": all(got.get(k) == v for k, v in want.items()),
        "(c) the checkpoint's manifest has the JAX block layout": (
            files == ["manifest-0.json", "shard-0.npz"]
            and manifest["format"] == 2
            and table["blocks"] == [{"key": "0.embed.table#0",
                                     "index": [[0, 50304], [0, 768]]}]),
        "(c) the checkpoint restores into the DTensor state bit for bit":
            bitwise,
    }
    log(f"[parallel] (c) fsdp.yaml on the one-rank mesh: loss at 10 "
        f"{got.get(('training', 10))!r} (phase 7 {want[('training', 10)]!r})"
        f", validation {got.get(('validation', 10))!r} (phase 7 "
        f"{want[('validation', 10)]!r}); fit {wall:.2f} s")
    return {"losses": {f"{g}@{s}": v for (g, s), v in got.items()},
            "phase7": {f"{g}@{s}": v for (g, s), v in want.items()},
            "wall_s": wall, "checks": checks}


def moe_serving() -> dict:
    """(d) the MoE GPT (fp32) behind phase 9's ServingConfig: the 8-request
    burst on a cold engine (eager) and on one warmed by CUDA-graph
    capture (replays only), token for token."""
    import dataclasses as dc

    import torch

    from determined_clone_tpu_torch.models import gpt

    cfg = dc.replace(gpt.GPTConfig(moe_experts=MOE["experts"]),
                     compute_dtype=torch.float32)
    params = gpt.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    prompts = prompts_of(SERVE["burst"], cfg.vocab_size, 0)
    # prompts up to 200 tokens: 128-token chunks, as phase 9's burst
    scfg = serving_config(chunk_prefill_len=SERVE["chunk"])
    with serving_engine(params, cfg, scfg) as eng:
        eng.generate([1, 2, 3], 2)
        cold_res, cold_wall, _, _ = burst(eng, prompts, SERVE["new"])
    with serving_engine(params, cfg, scfg) as eng:
        programs = eng.warmup()
        calls0 = eng.program_calls()
        warm_res, warm_wall, _, _ = burst(eng, prompts, SERVE["new"])
        calls1 = eng.program_calls()
        eng.wait_idle()
        eng.assert_kv_balanced(0)
    del params
    calls = {k: calls1[k] - calls0[k] for k in calls0}
    n_tok = sum(len(r.tokens) for r in cold_res)
    checks = {
        "(d) the warm burst ran graph replays only": (
            calls["eager"] == 0 and calls["replays"] > 0),
        "(d) the MoE GPT's warm tokens equal its cold tokens": [
            r.tokens for r in warm_res] == [r.tokens for r in cold_res],
    }
    log(f"[parallel] (d) MoE GPT fp32 served, 8 requests x {SERVE['new']} "
        f"tokens: cold {n_tok / cold_wall:.1f} tokens/s, warm "
        f"{n_tok / warm_wall:.1f} tokens/s ({programs} graphs, calls "
        f"{calls}); echo share {echo_share(prompts, cold_res):.3f}")
    return {"cold_tokens_per_s": n_tok / cold_wall,
            "warm_tokens_per_s": n_tok / warm_wall, "programs": programs,
            "warm_calls": calls, "checks": checks}


def phase_parallel(unmeshed) -> dict:
    """Phase 11: (a)-(d) of the module docstring, in a one-rank NCCL world
    joined through ``exec/launch.py``; the flash kernel's launches over
    (b)-(d) are ``parallel_launches``."""
    from determined_clone_tpu_torch.exec import launch
    from determined_clone_tpu_torch.ops.flash_attention import flash_attention
    from determined_clone_tpu_torch.parallel import MeshSpec, make_mesh

    t0 = time.monotonic()
    dist = launch.init_rank(0, 1, device="cuda")
    try:
        mesh = make_mesh(MeshSpec())
        out = {"moe_ffn": moe_ffn_cases()}
        flash_attention.launches = 0
        out["train"] = moe_train(mesh)
        trial_launches0 = flash_attention.launches
        out["trial"] = baseline5_trial(dist, unmeshed)
        out["trial_launches"] = flash_attention.launches - trial_launches0
        out["serving"] = moe_serving()
        out["launches"] = flash_attention.launches
    finally:
        launch.shutdown()
    checks = {**out["trial"]["checks"], **out["serving"]["checks"]}
    for name, ok in checks.items():
        log(f"[parallel] check {'ok' if ok else 'FAILED'}: {name}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 11 checks failed: {failed}")
    out["wall_s"] = time.monotonic() - t0
    log(f"[parallel] phase 11 wall {out['wall_s']:.1f} s; flash launches "
        f"{out['launches']} (train {out['train']['launches']}, trial "
        f"{out['trial_launches']})")
    return out


# phase 12: the second half of the parallelism slice, on one rank
SP_ATTENTION = (4, 1024, 12, 64)   # B, T, H, D: the GPT's attention
PIPELINE_STEPS, PIPELINE_M = 4, 4
RESNET_MESH_BATCHES = 10


def sp_attention_cases(mesh) -> list:
    """(a) ``ring_attention`` and ``ulysses_attention`` at sp 1 against
    ``mha`` and the flash kernel on the same inputs, within phase 2's
    bounds (``TOL``)."""
    import torch

    from determined_clone_tpu_torch.ops.attention import (
        mha,
        ring_attention,
        ulysses_attention,
    )
    from determined_clone_tpu_torch.ops.flash_attention import (
        flash_attention_kernel,
    )

    B, T, H, D = SP_ATTENTION
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((B, T, H, D), generator=gen, device="cuda",
                               dtype=dtype) for _ in range(3))
        with torch.no_grad():
            ref = mha(q, k, v, causal=True).float()
            flash = flash_attention_kernel(q, k, v, causal=True,
                                           block_k=128).float()
            for fn in (ring_attention, ulysses_attention):
                out = fn(q, k, v, axis_name="sp", mesh=mesh)
                rows.append({
                    "fn": fn.__name__, "dtype": str(dtype),
                    "shape": [B, T, H, D], "tol": TOL[str(dtype)],
                    "vs_mha": (out.float() - ref).abs().max().item(),
                    "vs_flash": (out.float() - flash).abs().max().item()})
    for r in rows:
        log(f"[second half] (a) {r['fn']} {r['dtype']} sp 1 "
            f"B,T,H,D={r['shape']}: max |diff| vs mha {r['vs_mha']:.3g}, "
            f"vs flash {r['vs_flash']:.3g} (tolerance {r['tol']})")
    return rows


def pipelined_steps(mesh, want) -> dict:
    """(b) ``GPTConfig()`` with ``pipeline_microbatches=4``, state and
    batch placed by ``GPT_PP_SHARDING_RULES`` on the one-rank mesh
    (``pp`` 1: the stages' shortcut), phase 6's weights, batch and
    AdamW: the first losses equal phase 6's bit for bit."""
    import dataclasses as dc

    import torch

    from determined_clone_tpu_torch.models import gpt
    from determined_clone_tpu_torch.ops.flash_attention import flash_attention
    from determined_clone_tpu_torch.parallel.sharding import (
        NamedSharding,
        batch_spec,
        to_dtensor,
    )
    from determined_clone_tpu_torch.training.train_step import (
        shard_state,
        state_shardings,
    )

    cfg = dc.replace(gpt.GPTConfig(), pipeline_microbatches=PIPELINE_M)
    params = gpt.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1025), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(3))
    state, step = train_setup(cfg, params)
    state = shard_state(state, state_shardings(state, mesh,
                                               gpt.GPT_PP_SHARDING_RULES))
    batch = to_dtensor(tokens, NamedSharding(mesh, batch_spec(1)))
    del params
    losses = []
    flash_attention.launches = 0
    t0 = time.monotonic()
    for _ in range(PIPELINE_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist()
    wall = time.monotonic() - t0
    launches = flash_attention.launches
    del state
    # launches per rank per step: (L / P) layers x the ticks that run the
    # stage (M over pp > 1; one call at pp 1) x 2 (remat)
    per_step = cfg.n_layers * 2
    log(f"[second half] (b) GPTConfig() M={PIPELINE_M} under "
        f"GPT_PP_SHARDING_RULES on the one-rank mesh: losses "
        f"{', '.join(repr(x) for x in losses)} (phase 6 "
        f"{', '.join(repr(x) for x in want[:PIPELINE_STEPS])}); flash "
        f"launches {launches} ({per_step} expected per step); "
        f"{wall * 1e3 / PIPELINE_STEPS:.1f} ms/step")
    return {"losses": losses, "phase6": want[:PIPELINE_STEPS],
            "launches": launches, "launches_per_step": launches
            // PIPELINE_STEPS, "expected_per_step": per_step,
            "wall_s": wall}


def _reports_of(run) -> list:
    return [(g, s, m.get("loss"), m.get("accuracy")) for g in
            ("training", "validation") for s, m in run[g]]


def meshed_families(dist) -> dict:
    """(c) BASELINE #2 and #3's ``distributed.yaml`` cut 8 → 1 rank (the
    global batch to one chip's share) through ``Trainer.fit`` on the
    one-rank mesh, against the same trial with no mesh."""
    import shutil
    import tempfile

    from determined_clone_tpu_torch.config import ExperimentConfig
    from determined_clone_tpu_torch.examples.mnist import MnistTrial
    from determined_clone_tpu_torch.examples.resnet50 import ResNetTrial

    import torch

    out = {}
    # cuDNN's default weight-gradient algorithms sum with atomics: two runs
    # of one program differ in the last bits (mnist: 7e-5 of the loss
    # after 100 steps), so the bit-for-bit comparison runs deterministic
    # algorithms
    cudnn = torch.backends.cudnn
    was = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    for name, cls, rel, batch, batches in (
            ("mnist", MnistTrial, "examples/mnist/distributed.yaml", 64,
             None),
            ("resnet50", ResNetTrial, "examples/resnet50/distributed.yaml",
             32, RESNET_MESH_BATCHES)):
        raw = _read_yaml(rel)
        hp = dict(raw["hyperparameters"], global_batch_size=batch)
        hp["mesh"] = {a: 1 for a in hp["mesh"]}
        if batches:   # ResNet: 200 -> 10 batches, 320 synthetic images
            hp["n_train"] = 320
            raw.update(searcher={**raw["searcher"], "max_length": {
                "batches": batches}}, scheduling_unit=5,
                min_validation_period={"batches": batches})
        raw.update(hyperparameters=hp, resources={"slots_per_trial": 1})
        cfg = ExperimentConfig.from_dict(raw)
        storage = tempfile.mkdtemp(prefix="chip-smoke-mesh-families-")
        try:
            meshed = fit_family(cls, cfg, hp, os.path.join(storage, "a"),
                                distributed=dist)
            plain = fit_family(cls, cfg, {k: v for k, v in hp.items()
                                          if k != "mesh"},
                               os.path.join(storage, "b"), mesh=None)
        finally:
            shutil.rmtree(storage, ignore_errors=True)
        mesh = meshed["trial"].context.mesh
        out[name] = {"reports": _reports_of(meshed),
                     "plain": _reports_of(plain), "batch": batch,
                     "mesh_size": None if mesh is None else mesh.size(),
                     "wall_s": meshed["wall_s"],
                     "plain_wall_s": plain["wall_s"]}
        log(f"[second half] (c) {name} {rel} cut 8 -> 1 rank, batch "
            f"{batch}: {len(out[name]['reports'])} reports on the one-rank "
            f"mesh, last {out[name]['reports'][-1]} (no mesh: "
            f"{out[name]['plain'][-1]}); fit {meshed['wall_s']:.2f} s "
            f"against {plain['wall_s']:.2f} s")
    cudnn.deterministic, cudnn.benchmark = was
    return out


def bert_on_mesh(mesh) -> dict:
    """(d) BERT-base ``classify`` (phase 8's widths, bf16) under
    ``BERT_SHARDING_RULES`` on the one-rank mesh against the unmeshed
    forward on the same weights and tokens."""
    import torch

    from determined_clone_tpu_torch.models import bert
    from determined_clone_tpu_torch.parallel.sharding import (
        NamedSharding,
        batch_spec,
        shard_put,
        to_dtensor,
    )

    cfg = bert.BertConfig(max_seq_len=BERT_BASE["seq_len"])
    params = bert.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (BERT_BASE["global_batch_size"],
                                               BERT_BASE["seq_len"]),
                           device="cuda", generator=torch.Generator(
                               device="cuda").manual_seed(4))
    with torch.no_grad():
        plain = bert.classify(params, cfg, tokens)
        placed = shard_put(params, bert.BERT_SHARDING_RULES.shardings_for(
            params, mesh))
        meshed = bert.classify(placed, cfg, to_dtensor(
            tokens, NamedSharding(mesh, batch_spec(1)))).to_local()
    equal = bool(torch.equal(plain, meshed))
    log(f"[second half] (d) BERT-base classify, batch "
        f"{BERT_BASE['global_batch_size']} seq {BERT_BASE['seq_len']} bf16 "
        f"under BERT_SHARDING_RULES on the one-rank mesh: equal to the "
        f"unmeshed forward bit for bit: {equal} (max |logit| "
        f"{plain.abs().max().item():.4f})")
    return {"equal": equal}


def phase_second_half(train) -> dict:
    """Phase 12: (a)-(d) of the module docstring in a one-rank NCCL world
    (``init_rank``); the flash kernel's launches over (b) are
    ``pipeline_launches``."""
    from determined_clone_tpu_torch.exec import launch
    from determined_clone_tpu_torch.parallel import MeshSpec, make_mesh

    t0 = time.monotonic()
    dist = launch.init_rank(0, 1, device="cuda")
    try:
        mesh = make_mesh(MeshSpec())
        out = {"attention": sp_attention_cases(mesh),
               "pipeline": pipelined_steps(mesh, train["losses"]),
               "families": meshed_families(dist),
               "bert": bert_on_mesh(mesh)}
    finally:
        launch.shutdown()
    pipe, fam = out["pipeline"], out["families"]
    checks = {
        f"(a) {r['fn']} {r['dtype']}: within {r['tol']} of mha and of the "
        f"flash kernel": r["vs_mha"] <= r["tol"] and r["vs_flash"] <= r["tol"]
        for r in out["attention"]}
    checks.update({
        "(b) the pipelined GPT's losses equal phase 6's bit for bit":
            pipe["losses"] == pipe["phase6"],
        "(b) the flash kernel ran 2 x n_layers times per step":
            pipe["launches"] == PIPELINE_STEPS * pipe["expected_per_step"],
        **{f"(c) {n}: trained on the one-rank mesh, its reports equal the "
           f"unmeshed trial's bit for bit": (
               f["mesh_size"] == 1 and bool(f["reports"])
               and f["reports"] == f["plain"]) for n, f in fam.items()},
        "(d) BERT-base under BERT_SHARDING_RULES equals the unmeshed "
        "forward bit for bit": out["bert"]["equal"],
    })
    for name, ok in checks.items():
        log(f"[second half] check {'ok' if ok else 'FAILED'}: {name}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 12 checks failed: {failed}")
    out["checks"] = checks
    out["launches"] = pipe["launches"]
    out["wall_s"] = time.monotonic() - t0
    log(f"[second half] phase 12 wall {out['wall_s']:.1f} s; flash launches "
        f"{out['launches']} in (b)")
    return out


# phase 13: the telemetry slice
def _span_counts(tel) -> dict:
    counts = {}
    for e in tel.tracer.events():
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


def _compiled_dispatches(tel) -> int:
    return sum(1 for e in tel.tracer.events()
               if e["name"] == "train_dispatch"
               and (e.get("args") or {}).get("compiled"))


def _gauge_samples(tel, family) -> list:
    from determined_clone_tpu_torch.telemetry import parse_prometheus_text

    return [(labels, value) for name, labels, value in
            parse_prometheus_text(tel.registry.dump())["samples"]
            if name == family]


def scaling_bench_one_rank() -> dict:
    """(h) ``parallel/scaling_bench.py`` at one rank on this card, in
    this process (a one-rank NCCL world, as phases 11 and 12 join it):
    the one-rank baseline, then the one-rank run over dp, fsdp and tp
    (each axis of size 1). Its command line spawns the same two runs as
    rank processes; four cards run that (``PERF.md``)."""
    from determined_clone_tpu_torch.exec import launch
    from determined_clone_tpu_torch.parallel import scaling_bench

    t0 = time.monotonic()
    dist = launch.init_rank(0, 1, device="cuda")
    try:
        baseline = scaling_bench.measure_baseline(device="cuda", dist=dist)
        artifact = scaling_bench.run_scaling_bench(
            1, baseline=baseline, device="cuda", dist=dist)
    finally:
        launch.shutdown()
    return {"artifact": artifact, "wall_s": time.monotonic() - t0}


def phase_telemetry(trial) -> dict:
    """Phase 13: phase 7's trial with ``observability`` on, its first leg
    (20 batches) and a restore leg to 40, with checks (a)-(h) of the
    module docstring; the flash launches over the two legs are
    ``telemetry_launches``."""
    import math
    import shutil
    import tempfile

    import torch

    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.ops.flash_attention import flash_attention
    from determined_clone_tpu_torch.telemetry import (
        check_conservation,
        merge_goodput,
        validate_chrome_trace,
    )

    t0 = time.monotonic()
    hparams = GPT_FSDP_HPARAMS
    storage = tempfile.mkdtemp(prefix="chip-smoke-telemetry-")
    goodput_dir = os.path.join(storage, "goodput")

    def extra(leg):
        # checkpoints at 20 and 40 only (policy "all": no "best" saves at
        # each validation): the reports do not depend on the checkpoint
        # schedule, and each 1.48 GB save costs seconds
        return {"min_validation_period": {"batches": 10},
                "min_checkpoint_period": {"batches": 20},
                "checkpoint_policy": "all",
                "observability": {
                    "enabled": True, "goodput_dir": goodput_dir,
                    "flight_dir": os.path.join(storage, f"flight-{leg}"),
                    "trace_path": os.path.join(storage,
                                               f"trace-{leg}.json")}}

    try:
        flash_attention.launches = 0
        legs = {"leg1": fit_trial(storage, 20, extra=extra("leg1"))}
        ckpts = core.LocalCheckpointRegistry(
            os.path.join(storage, "checkpoints.jsonl")).list()
        legs["leg2"] = fit_trial(storage, 40, extra=extra("leg2"),
                                 latest=ckpts[-1]["storage_id"])
        launches = flash_attention.launches
        traces = {}
        for leg in legs:
            with open(os.path.join(storage, f"trace-{leg}.json")) as f:
                traces[leg] = validate_chrome_trace(json.load(f))
        merged = merge_goodput(goodput_dir)
        for leg in legs.values():
            leg["state"] = None
        bench = scaling_bench_one_rank()
    finally:
        shutil.rmtree(storage, ignore_errors=True)

    from determined_clone_tpu_torch.telemetry.mesh import validate_multichip

    _, mem_total = torch.cuda.mem_get_info()
    checks, lines = {}, []
    for name, leg in legs.items():
        tel, rows = leg["telemetry"], leg["timings"]
        spans = _span_counts(tel)
        want = {f"{g}@{s}": m for g, key in (("training", "training"),
                                             ("validation", "validation"))
                for s, m in trial[name][key]}
        got = {f"{g}@{s}": m for g, key in (("training", "training"),
                                            ("validation", "validation"))
               for s, m in leg[key]}
        same = set(got) == set(want) and all(
            got[k]["loss"] == want[k]["loss"]
            and got[k].get("grad_norm") == want[k].get("grad_norm")
            for k in want)
        checks[f"(a) {name}: reports equal phase 7's bit for bit"] = same
        dispatches = leg["result"]["batches_trained"] - (
            0 if name == "leg1" else 20)
        chunks = len(leg["training"])
        checks[f"(b) {name}: {dispatches} train_dispatch spans, one "
               f"compiled"] = (spans.get("train_dispatch") == dispatches
                               and _compiled_dispatches(tel) == 1)
        checks[f"(b) {name}: {chunks} host_sync spans"] = (
            spans.get("host_sync") == chunks)
        need = ["validate", "checkpoint_save"] + (
            ["checkpoint_restore", "restore_replay"] if name == "leg2"
            else [])
        checks[f"(b) {name}: {', '.join(need)} spans present"] = all(
            spans.get(n, 0) > 0 for n in need)
        checks[f"(b) {name}: Chrome trace valid"] = traces[name] == []
        snap = leg["goodput"]
        cats = snap["categories"]
        checks[f"(c) {name}: goodput conserved, productive > 0, compile "
               f"booked"] = (check_conservation(snap)["ok"]
                             and cats["productive"] > 0
                             and cats["compile"] > 0)
        reg = tel.registry
        fps = reg.gauge("flops_per_sec").value
        peak = reg.gauge("mfu_peak_flops").value
        mfu = reg.gauge("mfu").value
        (info,) = _gauge_samples(tel, "mfu_peak_info")
        checks[f"(d) {name}: mfu = flops_per_sec / mfu_peak_flops, the "
               f"peak labelled gpu:h100"] = (
            math.isclose(mfu, fps / peak, rel_tol=1e-12)
            and info[0]["assumed"] == "gpu:h100")
        in_use = _gauge_samples(tel, "device_memory_bytes_in_use")
        limit = _gauge_samples(tel, "device_memory_bytes_limit")
        last_row = rows[-1]
        checks[f"(e) {name}: memory gauges of gpu:0 from torch.cuda, "
               f"limit = mem_get_info's total, peak within "
               f"[allocated, max allocated]"] = (
            [lb["device"] for lb, _ in in_use] == ["gpu:0"]
            and [lb["source"] for lb, _ in in_use] == ["memory_stats"]
            and [v for _, v in limit] == [float(mem_total)]
            and last_row["memory_allocated"]
            <= last_row["device_memory_peak_bytes"]
            <= last_row["max_memory_allocated"])
        sps = [m["samples_per_second"] for _, m in leg["training"]]
        base = [m["samples_per_second"] for _, m in trial[name]["training"]]
        divergence = reg.counter("mfu_divergence_total").value
        lines.append(
            f"[telemetry] {name}: samples/s per chunk "
            f"{', '.join(f'{v:.3f}' for v in sps)} (phase 7: "
            f"{', '.join(f'{v:.3f}' for v in base)}); mfu {mfu:.4g} "
            f"(analytic, {info[0]['flops_source']}), mfu_measured "
            f"{reg.gauge('mfu_measured').value:.4f}, divergence chunks "
            f"{divergence:.0f}; peak {peak:.4g} ({info[0]['assumed']}); "
            f"goodput " + ", ".join(f"{k} {v:.3f}" for k, v in cats.items()
                                    if v) + f" of {snap['wall_s']:.3f} s; "
            f"compiles {tel.compile_count()}; memory peak "
            f"{last_row['device_memory_peak_bytes']:.0f} B (allocated "
            f"{last_row['memory_allocated']} B, max "
            f"{last_row['max_memory_allocated']} B, limit {mem_total} B); "
            f"spans {spans}")
    acct = merged.get(1, {})
    checks["(c) merged journal of both legs conserved"] = bool(
        acct.get("conservation_ok")) and acct.get("legs") == 2 and (
        abs(sum(acct["categories"].values()) - acct["wall_s"])
        <= 0.01 * acct["wall_s"])
    n_eval = sum(len(leg["validation"]) for leg in legs.values())
    per_step = 2 * hparams["n_layers"]
    want_launches = per_step * 40 + hparams["n_layers"] * n_eval
    checks[f"(f) flash launches {want_launches} ({per_step} x 40 steps + "
           f"{hparams['n_layers']} x {n_eval} eval batches)"] = (
        launches == want_launches)
    art = bench["artifact"]
    checks["(h) the scaling bench's one-rank artifact passes "
           "validate_multichip"] = (validate_multichip(art) == []
                                    and art["platform"] == "gpu")
    for line in lines:
        log(line)
    log(f"[telemetry] merged goodput over both legs: "
        f"{json.dumps(acct, default=str)}")
    for axis, run in sorted(art["meshes"].items()):
        log(f"[telemetry] (h) scaling bench {axis}: "
            f"{run['throughput_samples_per_sec']:.2f} samples/s, efficiency "
            f"{run['scaling_efficiency']:.4f}, mfu measured "
            f"{run['mfu_measured']}, collectives "
            f"{run['collectives']['total_ops']}, compile "
            f"{run['compile_seconds']:.3f} s; bench wall "
            f"{bench['wall_s']:.1f} s")
    for name, ok in checks.items():
        log(f"[telemetry] check {'ok' if ok else 'FAILED'}: {name}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 13 checks failed: {failed}")
    out = {"launches": launches, "checks": checks, "scaling_bench": art,
           "merged_goodput": acct, "wall_s": time.monotonic() - t0,
           "legs": {name: {"goodput": leg["goodput"],
                           "spans": _span_counts(leg["telemetry"]),
                           "training": leg["training"],
                           "timings": leg["timings"],
                           "registry": leg["telemetry"].registry.snapshot()}
                    for name, leg in legs.items()}}
    log(f"[telemetry] phase 13 wall {out['wall_s']:.1f} s; flash launches "
        f"{launches}")
    return out


# phase 14: the control-plane slice — an ASHA search of GPT-124M trials,
# two of them: the depth is cut so that the whole script,
# phase 15 included, keeps its margin to the run's time limit
SEARCH = {"name": "asha", "max_trials": 2, "num_rungs": 2, "divisor": 2,
          "max_length": {"batches": 20}, "max_concurrent_trials": 2}
SEARCH_LR = {"type": "log", "base": 10, "minval": -4.5, "maxval": -3.0}


def _search_trial_class():
    """The port's GPT trial whose first leg past rung 0 raises once, in
    ``training_data`` (before any step or restore), as
    ``tests/test_observability_plane.py``'s trial does. The runner runs its
    queue in order, so the first ``SEARCH["max_trials"]`` legs are the
    rung-0 legs and the next is the first promoted trial's rung-1 leg."""
    from determined_clone_tpu_torch.examples.gpt_fsdp import GPTTrial

    class FlakyGPTTrial(GPTTrial):
        legs = 0
        failed = []

        def __init__(self, context):
            super().__init__(context)
            FlakyGPTTrial.legs += 1
            self.leg = FlakyGPTTrial.legs

        def training_data(self):
            if (self.leg == SEARCH["max_trials"] + 1
                    and not FlakyGPTTrial.failed):
                FlakyGPTTrial.failed.append(self.context.hparams)
                raise RuntimeError("injected failure before the first step")
            return super().training_data()

    return FlakyGPTTrial


def _recording_searcher(method):
    """A ``Searcher`` that records every event it is given and the
    operations it answers, as (event, args, operations JSON)."""
    from determined_clone_tpu_torch.searcher import Searcher
    from determined_clone_tpu_torch.searcher.custom import ops_to_json

    class Recording(Searcher):
        def __init__(self, method):
            super().__init__(method)
            self.events = []

        def _rec(self, event, args, ops):
            self.events.append((event, args, ops_to_json(ops)))
            return ops

        def initial_operations(self):
            return self._rec("initial", (), super().initial_operations())

        def trial_created(self, request_id):
            return self._rec("trial_created", (request_id,),
                             super().trial_created(request_id))

        def validation_completed(self, request_id, metric, units):
            return self._rec("validation_completed",
                             (request_id, metric, units),
                             super().validation_completed(request_id,
                                                          metric, units))

        def trial_closed(self, request_id):
            return self._rec("trial_closed", (request_id,),
                             super().trial_closed(request_id))

        def trial_exited_early(self, request_id, reason):
            return self._rec("trial_exited_early", (request_id, reason),
                             super().trial_exited_early(request_id, reason))

    return Recording(method)


def _metrics_records(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_search() -> dict:
    """Phase 14: an ASHA search of GPT-124M trials through
    ``ExperimentConfig.from_dict`` → ``LocalExperimentRunner(...,
    master=InProcessMaster(), device="cuda").run()``, with checks (a)-(f)
    of the module docstring; the flash launches of the search are
    ``search_launches``."""
    import math
    import shutil
    import tempfile
    import urllib.request

    import torch

    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.api import InProcessMaster, serve_http
    from determined_clone_tpu_torch.config import ExperimentConfig
    from determined_clone_tpu_torch.experiment import LocalExperimentRunner
    from determined_clone_tpu_torch.ops.flash_attention import flash_attention
    from determined_clone_tpu_torch.searcher import Searcher, build_method
    from determined_clone_tpu_torch.searcher.custom import ops_to_json
    from determined_clone_tpu_torch.training.optim import leaves
    from determined_clone_tpu_torch.utils.retry import RetryPolicy

    t_phase = time.monotonic()
    metric = TRIAL_METRIC
    storage = tempfile.mkdtemp(prefix="chip-smoke-search-")
    hparams = dict(GPT_FSDP_HPARAMS, lr=SEARCH_LR)
    raw = {"searcher": {**SEARCH, "metric": metric},
           "scheduling_unit": 10, "max_restarts": 1,
           "checkpoint_storage": {"type": "shared_fs", "host_path": storage},
           "hyperparameters": hparams,
           "resources": {"slots_per_trial": 1},
           "observability": {"enabled": True, "ship_spans": True,
                             "ship_metrics": True}}
    trial_cls = _search_trial_class()
    try:
        cfg = ExperimentConfig.from_dict(raw)
        master = InProcessMaster()
        runner = LocalExperimentRunner(
            cfg, trial_cls, storage_path=storage, master=master,
            device="cuda",
            restart_backoff=RetryPolicy(name="search_restart",
                                        max_attempts=1, base_delay_s=0.0,
                                        max_delay_s=0.0, jitter="none"))
        runner.engine = _recording_searcher(runner.engine.method)
        flash_attention.launches = 0
        t0 = time.monotonic()
        result = runner.run()
        wall = time.monotonic() - t0
        launches = flash_attention.launches

        trials = result.trials
        records = {rid: _metrics_records(t.metrics_path)
                   for rid, t in trials.items()}
        registry = core.LocalCheckpointRegistry(
            os.path.join(storage, "checkpoints.jsonl")).list()
        promoted = [t for t in trials.values() if t.units_done == 20]
        best = min(promoted, key=lambda t: t.best_metric)
        restarted = [t for t in trials.values() if t.restarts]

        # (b) the unbroken witness of the best promoted trial's hparams
        witness = fit_trial(storage + "-witness", 20, hparams=best.hparams,
                            extra={"checkpoint_policy": "none"})
        with core.init(config=None, storage_path=storage) as ctx:
            with ctx.checkpoint.restore_path(best.latest_checkpoint) as path:
                loaded = core.load_pytree(os.path.join(path, "state"),
                                          witness["state"])
        w_state = witness["state"]
        adam_w, adam_l = w_state.opt_state[1][0], loaded.opt_state[1][0]
        pairs = list(zip(leaves(w_state.params), leaves(loaded.params)))
        pairs += list(zip(leaves(adam_w.mu), leaves(adam_l.mu)))
        pairs += list(zip(leaves(adam_w.nu), leaves(adam_l.nu)))
        bitwise = all(torch.equal(a.detach(), b) for a, b in pairs)
        loaded_step = (loaded.step, adam_l.count)
        witness_metric = witness["result"]["last_validation"][metric]
        del loaded, pairs, w_state, adam_w, adam_l
        witness["state"] = None

        # (d) the recorded events replayed into a fresh searcher
        fresh = Searcher(build_method(cfg.searcher, cfg.hyperparameters,
                                      seed=cfg.experiment_seed))
        replay = []
        for event, args, _ops in runner.engine.events:
            fn = {"initial": fresh.initial_operations,
                  "trial_created": fresh.trial_created,
                  "validation_completed": fresh.validation_completed,
                  "trial_closed": fresh.trial_closed,
                  "trial_exited_early": fresh.trial_exited_early}[event]
            replay.append((event, args, ops_to_json(fn(*args))))

        # (e) the master over HTTP
        server = serve_http(master)
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/metrics",
                    timeout=30) as r:
                metrics_text = r.read().decode()
        finally:
            server.stop()
        spans = master.spans(experiment_id=runner.experiment_id)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
        shutil.rmtree(storage + "-witness", ignore_errors=True)

    ops = [o for _e, _a, out in runner.engine.events for o in out]
    n_trials = SEARCH["max_trials"]
    creates = [o for o in ops if o["type"] == "create"]
    train_batches = sum(t.units_done for t in trials.values())
    eval_batches = sum(1 for recs in records.values() for r in recs
                       if r["group"] == "validation")
    per_step = 2 * hparams["n_layers"]
    want_launches = per_step * train_batches + hparams["n_layers"] * \
        eval_batches
    trial_ids = {f'trial_id="{rid}"' for rid in trials}
    leg_spans = [sp for sp in spans if sp.get("name") == "trial_leg"]
    lanes = [sp for sp in spans if sp.get("name") in ("experiment",
                                                      "trial_leg")]

    def durations(name):
        return [sp["dur_us"] / 1e6 for sp in spans
                if sp.get("name") == name and "trial_id" in sp]

    saves, restores = durations("checkpoint_save"), durations(
        "checkpoint_restore")
    steps_s = sum(durations("train_dispatch"))
    checks = {
        f"(a) {n_trials} trials created, the searcher shut down": (
            len(creates) == n_trials and result.n_trials == n_trials
            and result.shutdown
            and ops[-1]["type"] == "shutdown"),
        "(a) every trial completed": all(
            t.state == "completed" for t in trials.values()),
        "(a) a trial promoted from rung 0 (10) to rung 1 (20)": bool(
            promoted) and all(t.units_done in (10, 20)
                              for t in trials.values()),
        "(a) each promoted leg resumed its own checkpoint: registry "
        "trial_id = request_id, reports at 10 then 20": all(
            [r["steps_completed"] for r in records[t.request_id]
             if r["group"] == "training"] == [10, 20]
            and [r["steps_completed"] for r in records[t.request_id]
                 if r["group"] == "validation"] == [10, 20]
            and [r.get("trial_id") for r in registry
                 if r["storage_id"] == t.latest_checkpoint]
            == [t.request_id]
            for t in promoted),
        "(b) the best promoted trial's metric and state equal an unbroken "
        "20-batch run bit for bit": (
            best.last_metric == witness_metric and bitwise
            and loaded_step == (20, 20)),
        "(c) the first promoted leg restarted once from its checkpoint": (
            len(restarted) == 1 and restarted[0].restarts == 1
            and restarted[0].units_done == 20
            and restarted[0].hparams == trial_cls.failed[0]
            and runner.registry.counter("trial_restarts_total").value == 1),
        "(d) the recorded events replayed into a fresh searcher give the "
        "same operations": replay == runner.engine.events,
        f"(e) /metrics has the {n_trials} trials' rollups and the restart "
        "counter": (
            all(tid in metrics_text for tid in trial_ids)
            and 'trial_restarts_total{component="runner"} 1' in metrics_text
            and "dct_cluster_trial_restarts_total 1" in metrics_text),
        "(e) the master's spans hold the experiment and trial_leg lanes "
        "under one trace id": (
            {sp["name"] for sp in lanes} == {"experiment", "trial_leg"}
            and len({sp.get("trace_id") for sp in lanes}) == 1
            and len(leg_spans) == n_trials + len(promoted) + 1),
        f"(f) flash launches {want_launches} ({per_step} x {train_batches} "
        f"train batches + {hparams['n_layers']} x {eval_batches} eval "
        f"batches)": launches == want_launches,
        "every reported loss finite": all(
            math.isfinite(r["metrics"]["loss"]) for recs in records.values()
            for r in recs),
    }
    for rid, t in sorted(trials.items()):
        log(f"[search] trial {rid}: hparams lr {t.hparams['lr']:.6g} (the "
            f"rest GPT_FSDP_HPARAMS), rung "
            f"{0 if t.units_done == 10 else 1} ({t.units_done} batches), "
            f"legs {sum(1 for sp in leg_spans if sp['args'].get('trial_id') == rid)}"
            f", restarts {t.restarts}, {metric} "
            + ", ".join(f"{r['metrics']['loss']:.4f}@{r['steps_completed']}"
                        for r in records[rid] if r["group"] == "validation")
            + f", state {t.state}")
    log(f"[search] wall {wall:.1f} s; saves {len(saves)} "
        f"({', '.join(f'{v:.2f}' for v in saves)} s); restores "
        f"{len(restores)} ({', '.join(f'{v:.2f}' for v in restores)} s); "
        f"training steps {steps_s:.1f} s = {steps_s / wall:.3f} of the wall;"
        f" flash launches {launches}; best trial {best.request_id} "
        f"({metric} {best.last_metric:.6f}, witness {witness_metric:.6f}, "
        f"witness fit {witness['wall_s']:.1f} s)")
    for name, ok in checks.items():
        log(f"[search] check {'ok' if ok else 'FAILED'}: {name}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 14 checks failed: {failed}")
    phase_s = time.monotonic() - t_phase
    log(f"[search] phase 14 wall {phase_s:.1f} s; flash launches {launches}")
    return {"launches": launches, "wall_s": wall, "phase_s": phase_s,
            "checks": checks,
            "train_batches": train_batches, "eval_batches": eval_batches,
            "saves_s": saves, "restores_s": restores, "steps_s": steps_s,
            "witness_wall_s": witness["wall_s"],
            "trials": {rid: {"hparams": t.hparams, "units": t.units_done,
                             "restarts": t.restarts, "state": t.state,
                             "metrics": [(r["steps_completed"],
                                          r["metrics"]["loss"])
                                         for r in records[rid]
                                         if r["group"] == "validation"]}
                       for rid, t in trials.items()}}


# phase 15: the managed-cluster slice — the C++ master, the port's agent on
# the card, a GPT-124M trial submitted through the port's CLI
MANAGED_BATCHES, UNMANAGED_BATCHES = 20, 8
MANAGED_MODEL_DEF = """\
import atexit

from determined_clone_tpu_torch.examples.gpt_fsdp import GPTTrial
from determined_clone_tpu_torch.ops.flash_attention import flash_attention


def _report_launches():
    print(f"[model_def] flash launches {flash_attention.launches}",
          flush=True)


class ManagedGPTTrial(GPTTrial):
    \"\"\"The port's GPT trial; prints the flash kernel's launch count when
    its leg's process ends.\"\"\"

    def __init__(self, context):
        super().__init__(context)
        atexit.register(_report_launches)
"""


class _MasterBuild:
    """``deploy.local.ensure_master`` in a thread from the script's start,
    so the C++ master's ``make`` (one g++ process) overlaps the card's
    phases; phase 15 joins it and prints its seconds. Not a daemon: if an
    earlier phase fails, the interpreter waits for the build at exit
    rather than leave a compiler running."""

    def __init__(self) -> None:
        import threading

        self.seconds, self.error = None, None
        self.thread = threading.Thread(target=self._run, name="master-build")
        self.thread.start()

    def _run(self) -> None:
        from determined_clone_tpu_torch.deploy import local

        try:
            self.seconds = local.ensure_master()
        except Exception as e:  # noqa: BLE001 - re-raised by join()
            self.error = e

    def join(self) -> float:
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.seconds


def managed_config(storage, batches, **extra) -> dict:
    """Phase 7's cut of ``examples/gpt_fsdp/fsdp.yaml`` as an experiment
    config: a single searcher, a validation and a checkpoint every 10
    batches, ``shared_fs`` storage, and a report per batch. The storage
    keeps the trial's latest checkpoint and not its best, so the master's
    GC at the experiment's end always has the first one to delete (the
    trainer completes its searcher operation before its final save, so
    the final checkpoint lands after the end)."""
    return {"name": "gpt-124m-managed", "entrypoint":
            "model_def:ManagedGPTTrial",
            "searcher": {"name": "single", "metric": TRIAL_METRIC,
                         "max_length": {"batches": batches}},
            "scheduling_unit": 1,
            "min_validation_period": {"batches": 10},
            "min_checkpoint_period": {"batches": 10},
            "checkpoint_storage": {"type": "shared_fs", "host_path": storage,
                                   "save_trial_best": 0},
            "hyperparameters": GPT_FSDP_HPARAMS,
            "resources": {"slots_per_trial": 1}, "max_restarts": 0,
            **extra}


def _wait(predicate, timeout, what, interval=0.2):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = predicate()
        if got:
            return got
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout} s waiting for {what}")


def _leg_logs(session, trial_id, legs) -> list:
    return [[r.get("log", "") for r in
             session.task_logs(f"trial-{trial_id}.{i}", limit=5000)]
            for i in range(legs)]


def _log_value(lines, prefix, pattern):
    import re

    for line in lines:
        if line.startswith(prefix):
            m = re.search(pattern, line)
            if m:
                return m.group(1)
    return None


def phase_managed(master_build, search, cluster=None) -> dict:
    """Phase 15: (a) the C++ master built with ``make`` and
    ``deploy.local.cluster_up`` with one of the port's agents, which
    detects the card; (b) phase 7's GPT-124M trial submitted through the
    port's CLI (``experiment create <cfg> <model_dir> -f`` in a
    subprocess), paused once its first checkpoint is registered and
    activated, held against an unbroken in-process ``fit_trial`` of the
    same config; (c) ``core.init_unmanaged`` around 8 steps of the same
    trial in this process; (d) the phase's timings. With a ``cluster``
    dict the cluster stays up for phase 16, which reads it from there,
    and ``close_cluster(cluster)`` takes it down; without one it goes
    down at the phase's end."""
    import math
    import re
    import tempfile

    import torch
    import yaml

    from determined_clone_tpu_torch import core
    from determined_clone_tpu_torch.api.client import MasterSession
    from determined_clone_tpu_torch.config import ExperimentConfig
    from determined_clone_tpu_torch.deploy import local
    from determined_clone_tpu_torch.ops.flash_attention import flash_attention
    from determined_clone_tpu_torch.training import Trainer, TrialContext

    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    base = tempfile.mkdtemp(prefix="chip-smoke-managed-")
    storage = os.path.join(base, "checkpoints")
    state_path = os.path.join(base, "cluster.json")
    model_dir = os.path.join(base, "model_def")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "model_def.py"), "w") as f:
        f.write(MANAGED_MODEL_DEF)
    cfg_path = os.path.join(base, "experiment.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(managed_config(storage, MANAGED_BATCHES), f)
    handoff = cluster is not None
    cluster = {} if cluster is None else cluster
    cluster.update(base=base, state_path=state_path, storage=storage)
    cli = None
    try:
        # (a) the master's build (started with the script) and cluster-up
        build_s = master_build.join()
        t0 = time.monotonic()
        state = local.cluster_up(n_agents=1, base_dir=base,
                                 state_path=state_path, wait_sec=120)
        up_s = time.monotonic() - t0
        port = state["port"]
        session = MasterSession("127.0.0.1", port, timeout=30, retries=5)
        (agent,) = session.list_agents()
        log(f"[managed] master build {build_s:.1f} s (make, one g++; "
            f"started with the script); cluster-up {up_s:.2f} s; agent "
            f"{agent['id']}: slots {agent['slots']}, topology "
            f"{agent['topology']!r}")

        # (b) submit through the CLI, pause at the first checkpoint,
        # activate, follow to the end
        env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
               + os.environ.get("PYTHONPATH", "")}
        t_submit = time.time()
        cli = subprocess.Popen(
            [sys.executable, "-m", "determined_clone_tpu_torch.cli", "-m",
             f"127.0.0.1:{port}", "experiment", "create", cfg_path,
             model_dir, "-f", "--timeout", "600"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=base)
        first = cli.stdout.readline()
        m = re.match(r"Created experiment (\d+)", first)
        if not m:
            raise AssertionError(f"phase 15: experiment create said "
                                 f"{first!r}{cli.stdout.read()}")
        exp_id = int(m.group(1))
        cluster.update(port=port, exp_id=exp_id)

        def checkpoints():
            return session.get(
                f"/api/v1/experiments/{exp_id}/checkpoints")["checkpoints"]

        _wait(checkpoints, 300, "the first checkpoint")
        t_pause = time.time()
        session.pause_experiment(exp_id)
        _wait(lambda: session.get_experiment(exp_id)["trials"][0]["state"]
              == "PAUSED", 300, "the trial to pause")
        preempt_ckpt = [c for c in checkpoints()
                        if c["metadata"].get("reason") == "preemption"]
        session.activate_experiment(exp_id)
        out, _ = cli.communicate(timeout=600)
        cli_rc = cli.returncode
        cli = None
        exp = session.get_experiment(exp_id)
        trial = exp["trials"][0]
        trial_id, legs = trial["id"], trial["legs"]
        records = session.trial_metrics(trial_id, limit=10000)
        ckpts = checkpoints()
        # the agent ships a leg's log once it has reaped the process, which
        # ends after the master has closed the trial
        logs = _wait(lambda: (lambda ls: ls if all(
            _log_value(leg, "[model_def] flash launches", "(launches)")
            for leg in ls) else None)(_leg_logs(session, trial_id, legs)),
            120, "every leg's shipped log")
        trace = session.get(f"/api/v1/experiments/{exp_id}/trace")["samples"]
        gc = _wait(lambda: [t for t in session.list_tasks()
                            if t.get("name") == f"checkpoint-gc-exp-{exp_id}"
                            and t["state"] in ("COMPLETED", "ERRORED",
                                               "CANCELED")],
                   120, "the checkpoint GC task")
        slot_free = _wait(
            lambda: not [j for j in session.job_queue()
                         if j.get("id", "").startswith(f"trial-{trial_id}.")],
            60, "the trial's slot to free")
        # shared_fs: each listed checkpoint is a directory under storage
        valid = [core.validate_checkpoint_dir(os.path.join(storage,
                                                           c["uuid"]),
                                              c["uuid"]) for c in ckpts]

        # the unbroken witness: the same config in this process
        witness = fit_trial(os.path.join(base, "witness"), MANAGED_BATCHES,
                            extra={"scheduling_unit": 1,
                                   "min_validation_period": {"batches": 10},
                                   "min_checkpoint_period": {"batches": 10},
                                   "checkpoint_policy": "none"})
        witness["state"] = None

        # (c) the unmanaged run: 8 steps in this process, reporting in
        ucfg = managed_config(os.path.join(base, "unmanaged"),
                              UNMANAGED_BATCHES, name="gpt-124m-unmanaged")
        ucfg.pop("entrypoint")
        flash_attention.launches = 0
        t0 = time.monotonic()
        with core.init_unmanaged(master_port=port, config=ucfg,
                                 heartbeat_interval=1.0) as uctx:
            trial_obj = _trial_classes()[0](TrialContext(
                config=ExperimentConfig.from_dict(ucfg),
                hparams=GPT_FSDP_HPARAMS, core=uctx))
            uresult = Trainer(trial_obj).fit()
            u_exp, u_trial = uctx.experiment_id, uctx.trial_id
        unmanaged_s = time.monotonic() - t0
        unmanaged_launches = flash_attention.launches
        u_detail = session.get_experiment(u_exp)
        u_records = session.trial_metrics(u_trial, limit=10000)
    finally:
        if cli is not None:
            cli.kill()
            cli.wait()
        if not handoff:
            close_cluster(cluster)

    def losses(recs, group):
        return [(r["steps_completed"], r["metrics"]["loss"]) for r in recs
                if r["group"] == group]

    train = losses(records, "training")
    val = losses(records, "validation")
    w_train = [(s, m["loss"]) for s, m in witness["training"]]
    w_val = [(s, m["loss"]) for s, m in witness["validation"]]
    u_train = losses(u_records, "training")
    launches_by_leg = [int(_log_value(leg, "[model_def] flash launches",
                                      r"launches (\d+)") or -1)
                       for leg in logs]
    launches = sum(launches_by_leg)
    hp = GPT_FSDP_HPARAMS
    per_step = 2 * hp["n_layers"]
    want_launches = per_step * MANAGED_BATCHES + hp["n_layers"] * len(val)
    visible = [_log_value(leg, "[trial] process spawned",
                          r"CUDA_VISIBLE_DEVICES=([^)]*)\)") for leg in logs]
    spawned = [float(_log_value(leg, "[trial] process spawned",
                                r"spawned at ([0-9.]+)") or "nan")
               for leg in logs]
    ready = [float(_log_value(leg, "[trial] harness ready",
                              r"ready at ([0-9.]+)") or "nan")
             for leg in logs]
    exits = [_log_value(leg, "[trial] leg finished", r"(leg finished)")
             for leg in logs]
    resumed_at = (preempt_ckpt[0]["metadata"]["steps_completed"]
                  if preempt_ckpt else None)
    # per leg: the master's queue (submitted → running) and the start-up
    # (process spawn → the leg's first step reported)
    queue_s = {}
    for sp in trace:
        if sp.get("process") != "master" or sp.get("name") not in (
                "submit", "schedule"):
            continue
        aid = sp["args"]["allocation_id"]
        queue_s[aid] = queue_s.get(aid, 0.0) + sp["dur_us"] / 1e6
    leg_queue = [queue_s.get(f"trial-{trial_id}.{i}") for i in range(legs)]
    first_steps = [min((r["time"] for r in records
                        if r["group"] == "training"
                        and r["steps_completed"] == s), default=float("nan"))
                   for s in (1, (resumed_at or 0) + 1)]
    startup = [f - sp for f, sp in zip(first_steps, spawned)]
    harness_s = [r - sp for r, sp in zip(ready, spawned)]
    pause_to_ckpt = (preempt_ckpt[0]["reported_at"] - t_pause
                     if preempt_ckpt else float("nan"))
    wall = (trial["ended_at"] or time.time()) - t_submit
    steps_s = sum(1.0 / r["metrics"]["batches_per_second"] for r in records
                  if r["group"] == "training")
    gc_task = gc[0]
    checks = {
        "(a) the agent detected the card: slots 1, topology <gen>-1": (
            agent["slots"] == 1
            and re.fullmatch(r"[a-z0-9]+-1", agent["topology"] or "")
            is not None),
        "(b) experiment create -f exited 0 and the trial COMPLETED in "
        "exactly 2 legs": (
            cli_rc == 0 and exp["experiment"]["state"] == "COMPLETED"
            and trial["state"] == "COMPLETED" and legs == 2
            and trial["restarts"] == 0 and all(exits)),
        "(b) leg 2 resumed from the pause's checkpoint (DCT_LATEST_"
        "CHECKPOINT)": (
            resumed_at is not None and 10 <= resumed_at < MANAGED_BATCHES
            and [s for s, _ in train] == list(range(1, MANAGED_BATCHES + 1))),
        "(b) the master's training losses equal the unbroken in-process "
        "fit's, batch for batch, bit for bit": train == w_train,
        "(b) its validation losses at 10 and 20 equal the witness's": (
            dict(val) == dict(w_val) and {s for s, _ in val} == {10, 20}),
        "(b) every checkpoint the master lists passes "
        "validate_checkpoint_dir": bool(valid) and all(valid),
        f"(b) flash launches from the legs' logs {want_launches} "
        f"({per_step} x {MANAGED_BATCHES} + {hp['n_layers']} x {len(val)} "
        f"validations)": launches == want_launches,
        "(b) each leg had its own CUDA_VISIBLE_DEVICES": (
            len(visible) == 2 and all(v not in (None, "", "(unset)")
                                      for v in visible)),
        "(b) the agent's slot is free again": bool(slot_free),
        "(b) the master's GC task for the experiment exited 0": (
            gc_task["state"] == "COMPLETED" and gc_task["exit_code"] == 0),
        "(c) the unmanaged experiment COMPLETED": (
            u_detail["experiment"]["state"] == "COMPLETED"
            and uresult["batches_trained"] == UNMANAGED_BATCHES),
        "(c) its 8 losses equal (b)'s first 8 bit for bit": (
            u_train == train[:UNMANAGED_BATCHES]),
        "every reported loss finite": all(
            math.isfinite(x) for _, x in train + val + u_train),
    }
    share14 = (search["steps_s"] / search["wall_s"]) if search else None
    log(f"[managed] legs {legs}: CUDA_VISIBLE_DEVICES {visible}; leg 2 "
        f"resumed at batch {resumed_at}; submit->running "
        + ", ".join(f"{q:.3f}" for q in leg_queue if q is not None)
        + " s (the master's queue); start-up (spawn -> first step) "
        + ", ".join(f"{x:.2f}" for x in startup)
        + " s, of which spawn -> harness ready (imports, CUDA device "
        "check, rendezvous) " + ", ".join(f"{x:.2f}" for x in harness_s)
        + f" s; pause->checkpointed {pause_to_ckpt:.2f} s")
    log(f"[managed] experiment wall {wall:.1f} s, training steps "
        f"{steps_s:.1f} s = {steps_s / wall:.3f} of it (phase 14's "
        f"in-process search: "
        + (f"{share14:.3f}" if share14 is not None else "not run")
        + f"); flash launches per leg {launches_by_leg}; checkpoints "
        f"{len(ckpts)} listed, GC task {gc_task['id']} exit "
        f"{gc_task['exit_code']}; unmanaged 8 steps {unmanaged_s:.1f} s, "
        f"{unmanaged_launches} flash launches")
    log(f"[managed] training loss " + ", ".join(
        f"{x:.4f}@{s}" for s, x in train) + "; validation " + ", ".join(
        f"{x:.4f}@{s}" for s, x in val))
    for name, ok in checks.items():
        log(f"[managed] check {'ok' if ok else 'FAILED'}: {name}")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        for i, leg in enumerate(logs):
            log(f"[managed] leg {i} log tail: " + " | ".join(leg[-12:]))
        log(f"[managed] cli output: {out[-2000:]}")
        raise AssertionError(f"phase 15 checks failed: {failed}")
    phase_s = time.monotonic() - t_phase
    log(f"[managed] phase 15 wall {phase_s:.1f} s")
    return {"launches": launches, "launches_by_leg": launches_by_leg,
            "unmanaged_launches": unmanaged_launches,
            "master_build_s": build_s, "cluster_up_s": up_s,
            "agent": agent, "leg_queue_s": leg_queue, "startup_s": startup,
            "harness_ready_s": harness_s,
            "pause_to_checkpoint_s": pause_to_ckpt, "resumed_at": resumed_at,
            "wall_s": wall, "steps_s": steps_s, "unmanaged_s": unmanaged_s,
            "training": train, "validation": val,
            "cuda_visible_devices": visible, "phase_s": phase_s,
            "checks": checks}


# phase 16: the rest of the control plane, on phase 15's cluster
REST = {"lengths": (16, 40, 64, 90, 120, 24, 48, 100), "new": 32,
        "seed": 16, "pool": "fleet-phase16", "replicas": 2,
        "stale_s": 3.0, "for_s": 2.0, "tick_s": 1.0}


def close_cluster(cluster) -> None:
    """Phase 15's cluster down and its directory removed; what never came
    up is skipped."""
    import shutil

    from determined_clone_tpu_torch.deploy import local

    if cluster.get("state_path"):
        local.cluster_down(state_path=cluster["state_path"])
    if cluster.get("base"):
        shutil.rmtree(cluster["base"], ignore_errors=True)


def _run_cli(port, *argv):
    """The port's CLI in this process against the master on ``port``:
    (exit code, stdout, stderr)."""
    import contextlib
    import io

    from determined_clone_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["-m", f"127.0.0.1:{port}", *argv])
    return rc, out.getvalue(), err.getvalue()


def rest_sdk(cluster) -> dict:
    """(a) The SDK at full width: phase 15's experiment through
    ``sdk.Determined``, its top checkpoint registered as a model version,
    downloaded, validated and loaded into the port's ``GPTTrial``, whose
    evaluation on the card must give the master's validation loss at
    that checkpoint's batch bit for bit."""
    import tempfile

    import torch

    from determined_clone_tpu_torch import core, sdk
    from determined_clone_tpu_torch.config import ExperimentConfig
    from determined_clone_tpu_torch.core._serialization import load_pytree
    from determined_clone_tpu_torch.examples.gpt_fsdp import GPTTrial
    from determined_clone_tpu_torch.ops.flash_attention import flash_attention
    from determined_clone_tpu_torch.ops.layers import fold_seed
    from determined_clone_tpu_torch.training import TrialContext
    from determined_clone_tpu_torch.training.metrics import MetricAccumulator
    from determined_clone_tpu_torch.training.train_step import (
        create_train_state,
        make_eval_step,
    )
    from determined_clone_tpu_torch.utils.data import batch_to_device

    d = sdk.Determined("127.0.0.1", cluster["port"])
    exp = d.get_experiment(cluster["exp_id"])
    state = exp.state
    trials = exp.trials()
    top = exp.top_checkpoint()
    steps = int(top.record["metadata"]["steps_completed"])
    model = d.create_model("gpt-124m-managed")
    version = model.register_version(top.uuid)
    versions = model.versions()
    out_dir = tempfile.mkdtemp(prefix="sdk-download-", dir=cluster["base"])
    t0 = time.monotonic()
    top.download(out_dir)
    download_s = time.monotonic() - t0
    nbytes = sum(os.path.getsize(os.path.join(root, f))
                 for root, _, files in os.walk(out_dir) for f in files)
    valid = core.validate_checkpoint_dir(out_dir, top.uuid)

    # the trial as the harness builds it, its state restored from the
    # download, and the trainer's evaluation (make_eval_step over the
    # trial's validation data, the metrics' mean as MetricAccumulator
    # takes it)
    cfg = ExperimentConfig.from_dict(
        managed_config(cluster["storage"], MANAGED_BATCHES))
    seed = cfg.experiment_seed
    trial = GPTTrial(TrialContext(config=cfg, hparams=GPT_FSDP_HPARAMS,
                                  core=None, mesh=None))
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(fold_seed(seed, 0))
    like = create_train_state(trial.initial_params(gen), trial.optimizer(),
                              fold_seed(seed, 1))
    train_state = load_pytree(os.path.join(out_dir, "state"), like)
    load_s = time.monotonic() - t0
    eval_step = make_eval_step(trial.eval_metrics, seed=fold_seed(seed, 2))
    flash_attention.launches = 0
    t0 = time.monotonic()
    acc = MetricAccumulator()
    batches = 0
    for vb in trial.validation_data():
        acc.add(eval_step(train_state, batch_to_device(vb, "cuda")))
        batches += 1
    loss = acc.result()["loss"]
    eval_s = time.monotonic() - t0
    launches = flash_attention.launches
    del train_state, like
    torch.cuda.empty_cache()
    master_val = [r["metrics"]["loss"] for r in
                  d.session.trial_metrics(trials[0].id, limit=10000)
                  if r["group"] == "validation"
                  and r["steps_completed"] == steps]
    n_layers = GPT_FSDP_HPARAMS["n_layers"]
    checks = {
        "(a) get_experiment: COMPLETED with one trial": (
            state == "COMPLETED" and len(trials) == 1),
        "(a) the top checkpoint registered as version 1": (
            version["version"] == 1 and len(versions) == 1),
        "(a) the download passes validate_checkpoint_dir": bool(valid),
        f"(a) its validation loss at batch {steps} equals the master's "
        f"bit for bit": bool(master_val) and loss == master_val[-1],
        f"(a) {n_layers} flash launches per eval batch ({batches} "
        f"batch(es))": launches == n_layers * batches and batches > 0,
    }
    log(f"[rest] (a) sdk: experiment {exp.id} {state}, {len(trials)} "
        f"trial(s); checkpoint {top.uuid} at batch {steps}: "
        f"download {download_s:.2f} s, {nbytes} bytes "
        f"({nbytes / max(download_s, 1e-9) / 2 ** 30:.2f} GiB/s, warm page "
        f"cache); load {load_s:.2f} s; eval {eval_s:.2f} s, loss "
        f"{loss!r} vs the master's {master_val[-1] if master_val else None!r}"
        f"; sdk_launches {launches}")
    return {"checks": checks, "launches": launches, "loss": loss,
            "master_loss": master_val[-1] if master_val else None,
            "steps": steps, "download_s": download_s, "bytes": nbytes,
            "load_s": load_s, "eval_s": eval_s, "eval_batches": batches,
            "trial_id": trials[0].id}


def _fleet_record(port, name):
    import urllib.request

    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/v1/serving/fleets",
            timeout=30) as resp:
        fleets = json.loads(resp.read().decode())["fleets"]
    return next((f for f in fleets if f["name"] == name), None)


def _metrics_text(port) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as resp:
        return resp.read().decode()


def rest_fleet(cluster) -> dict:
    """(b) A fleet as the master's serving gang: two ``GPTConfig()``
    replicas through ``MasterLink`` in a pool of their own (so no replica
    lands on phase 15's card agent), fp32 on ``branch_scaled`` weights;
    8 requests held token for token against one engine; a master-driven
    scale 2 → 1 with 8 requests in flight; the kill. (c) While it
    serves, an in-process master ingests the fleet's metrics and ticks
    its time series and rules once a second: one absence rule per
    replica and the stock SLO rules; the killed replica's rule must fire
    and the CLI's ``query`` and ``alerts`` read the store."""
    import math
    import threading

    import torch

    from determined_clone_tpu_torch.api.inprocess import (
        InProcessMaster,
        MasterHTTPServer,
    )
    from determined_clone_tpu_torch.models import gpt
    from determined_clone_tpu_torch.ops.flash_attention import flash_attention
    from determined_clone_tpu_torch.serving import (
        BucketSpec,
        InferenceEngine,
        KVCacheConfig,
        MasterLink,
        ServingFleet,
    )

    port, name = cluster["port"], "phase16"
    cfg = gpt.GPTConfig()
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    scaled = branch_scaled(gpt.init(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda"))
    scfg = serving_config()
    buckets = BucketSpec.build(scfg.max_batch, min(scfg.max_prefill_len,
                                                   cfg.max_seq_len))
    blocks = scfg.kv_blocks or scfg.max_batch * max(
        1, math.ceil(cfg.max_seq_len / scfg.kv_block_size))
    prompts = prompts_of(REST["lengths"], cfg.vocab_size, REST["seed"])
    new = REST["new"]
    flash_attention.launches = 0
    t0 = time.monotonic()
    with InferenceEngine.from_serving_config(scaled, cfg32, scfg,
                                             device="cuda") as eng, \
            torch.no_grad():
        eng.warmup()
        ref = [h.result(timeout=600).tokens
               for h in [eng.submit(p, new) for p in prompts]]
    ref_s = time.monotonic() - t0

    master = InProcessMaster()
    fleet = ServingFleet(scaled, cfg32, name=name, buckets=buckets,
                         cache=KVCacheConfig(num_blocks=blocks,
                                             block_size=scfg.kv_block_size),
                         max_queue_depth=scfg.max_queue_depth,
                         aggregator=master.aggregator, device="cuda")
    link = sampler = None
    stop = threading.Event()
    ticks: list = []
    out: dict = {}
    try:
        t0 = time.monotonic()
        link = MasterLink(fleet, port, replicas=REST["replicas"],
                          resource_pool=REST["pool"])
        link.wait_replicas(REST["replicas"], timeout=600)
        rec = _wait(lambda: (lambda f: f if f and f["running"] == 2
                             else None)(_fleet_record(port, name)),
                    120, "both replicas RUNNING on the master")
        out["running_s"] = time.monotonic() - t0
        out["record"] = rec
        out["sched_families"] = [
            fam for fam in ("dct_master_sched_serving_submitted_total",
                            "dct_master_sched_serving_running_total",
                            "dct_master_sched_serving_completed_total")
            if fam in _metrics_text(port)]
        ids = fleet.replica_ids()
        out["agent_pool"] = {a["id"]: a["resource_pool"]
                             for a in cluster["session"].list_agents()}

        # (c) the time series while the fleet serves
        master.enable_timeseries({"stock_slo_rules": True, "rules": [
            {"name": f"gone-{rid}", "kind": "absence",
             "series": "serving_queue_depth",
             "labels": {"component": f"serving_replica_{rid}"},
             "stale_s": REST["stale_s"], "for_s": REST["for_s"],
             "severity": "page"} for rid in ids]})

        def sample():
            while not stop.is_set():
                fleet.sample_telemetry()
                # the fleet's SLO gauges (dct_slo_*) for the stock rules,
                # as the master's own (its registry renders NaN, which a
                # component's snapshot in the aggregator cannot)
                fleet.slo.publish(master.aggregator.registry)
                tick = master.scrape_tick()
                ticks.append((time.monotonic(), set(fleet.replica_ids()),
                              {r["name"]: r["state"]
                               for r in tick["rules"]}))
                stop.wait(REST["tick_s"])

        sampler = threading.Thread(target=sample, name="phase16-scrape")
        sampler.start()

        hs = [fleet.submit(p, new, timeout=600) for p in prompts]
        out["tokens"] = [h.result(600).tokens for h in hs]

        # a master-driven scale 2 -> 1 with 8 requests in flight
        done = {}
        out["inflight_tokens"] = [None] * len(prompts)
        inflight = [fleet.submit(p, new, timeout=600) for p in prompts]

        def wait_one(i, h):
            out["inflight_tokens"][i] = h.result(600).tokens
            done[i] = time.time()   # the master's ended_at is wall time

        waiters = [threading.Thread(target=wait_one, args=(i, h),
                                    name=f"phase16-request-{i}")
                   for i, h in enumerate(inflight)]
        for w in waiters:
            w.start()
        # the master cancels the allocation at once and stamps its
        # ended_at when the fleet's agent reports it exited (the slot's
        # reclaim): that stamp must follow the replica's last request
        t_scale, t_scale_wall = time.monotonic(), time.time()
        link.scale(1)
        _wait(lambda: len(fleet.replica_ids()) == 1, 300, "the drain")
        out["drain_s"] = time.monotonic() - t_scale
        for w in waiters:
            w.join(600)
        exited = _wait(lambda: [r for r in _fleet_record(port, name)[
            "replicas"] if r["state"] == "CANCELED" and r["ended_at"]],
            120, "the drained replica's exit on the master")[0]
        gone = (set(ids) - set(fleet.replica_ids())).pop()
        keep = fleet.replica_ids()[0]
        on_gone = [i for i, h in enumerate(inflight)
                   if h.replica_id == gone]
        out.update(gone=gone, keep=keep, on_gone=len(on_gone),
                   rejected=fleet.stats().rejected,
                   exit_after_last=(bool(on_gone) and exited["ended_at"]
                                    >= max(done[i] for i in on_gone)),
                   exit_seen_s=exited["ended_at"] - t_scale_wall)

        # the killed replica's absence rule: pending, then firing
        rule = f"gone-{gone}"
        _wait(lambda: any(st.get(rule) == "firing" for _, _, st in ticks),
              REST["stale_s"] + REST["for_s"] + 30, f"{rule} to fire")
        last_seen = max(t for t, live, _ in ticks if gone in live)
        fired = min(t for t, _, st in ticks if st.get(rule) == "firing")
        out["rule_states"] = [st.get(rule) for _, _, st in ticks]
        out["fired_after_s"] = fired - last_seen
        out["keep_states"] = {st.get(f"gone-{keep}") for _, _, st in ticks}
        with MasterHTTPServer(master, 0) as srv:
            out["cli"] = {" ".join(a): _run_cli(srv.port, *a) for a in (
                ("query",),
                ("query", "dct_fleet_requests_completed", "--reduce",
                 "rate", "--window", "60"),
                ("alerts",))}
        out["alert_gauge"] = [
            ln for ln in master.aggregator.registry.dump().splitlines()
            if ln.startswith("dct_alert_firing{") and rule in ln]
        stop.set()
        sampler.join(30)
        sampler = None

        link.close(kill_fleet=True)
        link = None
        out["after_kill"] = _fleet_record(port, name)
    finally:
        stop.set()
        if sampler is not None:
            sampler.join(30)
        if link is not None:
            link.close(kill_fleet=True)
        fleet.close()
        master.stop_scraper()
    launches = flash_attention.launches
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith(("fleet-link", "fleet-drain",
                                    "phase16-"))]
    q_list, q_rate, alerts = (out["cli"][k] for k in (
        "query", "query dct_fleet_requests_completed --reduce rate "
        "--window 60", "alerts"))
    states = [s for s in out["rule_states"] if s]
    checks = {
        "(b) /api/v1/serving/fleets: running 2, queued 0, in the fleet's "
        "own pool": (out["record"]["queued"] == 0
                     and out["record"]["resource_pool"] == REST["pool"]
                     and out["agent_pool"].get(f"fleet-{name}")
                     == REST["pool"]),
        "(b) the master's /metrics carries the dct_master_sched_serving_* "
        "families": len(out["sched_families"]) == 3,
        "(b) 8 requests answered with one engine's tokens (fp32, "
        "branch_scaled), token for token": out["tokens"] == ref,
        "(b) scale 2 -> 1: every request in flight answered with the same "
        "tokens, none rejected": (out.get("inflight_tokens") == ref
                                  and out["rejected"] == 0),
        "(b) the drained replica reported `exited` only after its last "
        "request": bool(out["exit_after_last"]),
        "(b) close(kill_fleet=True) reclaimed every slot": (
            out["after_kill"] is not None
            and out["after_kill"]["running"] == 0),
        "(b) no fleet-link or fleet-drain thread survives": not leaked,
        "(c) the killed replica's absence rule went pending -> firing "
        "within stale_s + for_s (+ one tick)": (
            "pending" in states
            and states.index("pending") < states.index("firing")
            and out["fired_after_s"] <= REST["stale_s"] + REST["for_s"]
            + 2 * REST["tick_s"]),
        "(c) the surviving replica's rule stayed inactive": (
            out["keep_states"] <= {"inactive", None}),
        "(c) CLI query lists the series and reads a rate over a counter": (
            q_list[0] == 0 and "serving_queue_depth" in q_list[1]
            and "dct_fleet_requests_completed" in q_list[1]
            and q_rate[0] == 0 and "rate over 60s:" in q_rate[1]
            and "n/a" not in q_rate[1]),
        "(c) CLI alerts prints the rule as firing, dct_alert_firing 1": (
            alerts[0] == 0 and f"!! {rule} [page] firing" in alerts[1]
            and len(out["alert_gauge"]) == 1
            and out["alert_gauge"][0].endswith(" 1")),
        "(b) no flash launch (the paged forward attends with mha)": (
            launches == 0),
    }
    log(f"[rest] (b) fleet: reference engine {ref_s:.1f} s; replicas "
        f"submit -> RUNNING {out['running_s']:.2f} s; drain of {gone} "
        f"({out['on_gone']} requests in flight on it) {out['drain_s']:.2f}"
        f" s, its exit stamped by the master {out['exit_seen_s']:.3f} s "
        f"after the scale; fleet_master_launches {launches}")
    log(f"[rest] (c) time series: {len(ticks)} ticks; {rule}: "
        f"{' '.join(states)}; fired {out['fired_after_s']:.2f} s after "
        f"its last sample; query rate: {q_rate[1].strip()}")
    return {"checks": checks, "launches": launches,
            "running_s": out["running_s"], "drain_s": out["drain_s"],
            "exit_seen_s": out["exit_seen_s"], "ref_s": ref_s,
            "fired_after_s": out["fired_after_s"], "ticks": len(ticks),
            "on_gone": out["on_gone"], "leaked": leaked,
            "cli": out["cli"]}


def rest_ntsc(cluster, trial_id) -> dict:
    """(d) NTSC on the port's agent, through the port's CLI: a shell (its
    ``/exec`` sees no card), a command (exit 0, its log on the master)
    and a TensorBoard task over phase 15's experiment (``/data`` through
    the master's proxy holds the 20 training losses the master has);
    ``task kill`` ends them."""
    session, port = cluster["session"], cluster["port"]

    def started(kind, *argv):
        t0 = time.monotonic()
        rc, out, err = _run_cli(port, *argv)
        if rc != 0 or f"Started {kind} " not in out:
            raise AssertionError(f"phase 16: {argv} -> {rc}: {out}{err}")
        return out.split(f"Started {kind} ")[1].strip(), t0

    def serving(task_id, t0, what):
        _wait(lambda: (lambda t: t["state"] == "RUNNING"
                       and t["proxy_address"])(session.get_task(task_id)),
              120, what)
        return time.monotonic() - t0

    shell, t0 = started("shell", "shell", "start", "--name", "phase16-shell")
    seconds = {"shell": serving(shell, t0, "the shell to serve")}
    probe = _run_cli(port, "shell", "exec", shell, "--", sys.executable,
                     "-c", "import os; print(repr(os.environ.get("
                     "'CUDA_VISIBLE_DEVICES')))")
    command, t0 = started("command", "cmd", "run", "--name", "phase16-cmd",
                          "--", sys.executable, "-c",
                          "print('phase 16 command ran')")
    cmd_task = _wait(lambda: (lambda t: t if t["state"] in (
        "COMPLETED", "ERRORED", "CANCELED") else None)(
        session.get_task(command)), 120, "the command to end")
    seconds["command"] = time.monotonic() - t0
    cmd_log = _wait(lambda: [r for r in session.task_logs(command)
                             if "phase 16 command ran" in str(r.get("log"))],
                    60, "the command's log on the master")
    tb, t0 = started("tensorboard", "tensorboard", "start",
                     str(cluster["exp_id"]), "--name", "phase16-tb")
    seconds["tensorboard"] = serving(tb, t0, "the TensorBoard task to serve")
    data = session.proxy(tb, "/data")
    tb_records = data["experiments"][str(cluster["exp_id"])]["trials"][
        str(trial_id)]
    master_records = session.trial_metrics(trial_id, limit=10000)

    def train_losses(records):
        return [(r["steps_completed"], r["metrics"]["loss"])
                for r in records if r["group"] == "training"]

    kills = [_run_cli(port, "task", "kill", t)[0] for t in (shell, tb)]
    ends = {t: _wait(lambda t=t: (lambda x: x["state"] if x["state"] in (
        "COMPLETED", "CANCELED", "ERRORED") else None)(session.get_task(t)),
        60, f"{t} to end") for t in (shell, command, tb)}
    checks = {
        "(d) shell exec: a task with no slot sees CUDA_VISIBLE_DEVICES ''": (
            probe[0] == 0 and probe[1].strip() == "''"),
        "(d) cmd run exited 0 and its log reached the master": (
            cmd_task["state"] == "COMPLETED" and cmd_task["exit_code"] == 0
            and bool(cmd_log)),
        "(d) TensorBoard /data through the master's proxy holds the "
        f"{MANAGED_BATCHES} training losses the master has": (
            len(train_losses(tb_records)) == MANAGED_BATCHES
            and train_losses(tb_records) == train_losses(master_records)),
        "(d) task kill: every task ended": (
            kills == [0, 0] and ends[shell] == "CANCELED"
            and ends[tb] == "CANCELED" and ends[command] == "COMPLETED"),
    }
    log("[rest] (d) ntsc: submit -> serving " + ", ".join(
        f"{k} {v:.2f} s" for k, v in seconds.items())
        + " (the command: submit -> exited)")
    return {"checks": checks, "seconds": seconds}


def phase_rest(cluster) -> dict:
    """Phase 16: the rest of the control plane on phase 15's cluster —
    (a) the SDK, (b) a fleet as the master's serving gang, (c) the time
    series and alert rules while it serves, (d) NTSC tasks; each check
    failing the run."""
    import torch

    from determined_clone_tpu_torch.api.client import MasterSession

    t_phase = time.monotonic()
    torch.cuda.empty_cache()
    cluster["session"] = MasterSession("127.0.0.1", cluster["port"],
                                       timeout=30, retries=5)
    sdk_part = rest_sdk(cluster)
    fleet_part = rest_fleet(cluster)
    ntsc_part = rest_ntsc(cluster, sdk_part["trial_id"])
    checks = {**sdk_part["checks"], **fleet_part["checks"],
              **ntsc_part["checks"]}
    for name, ok in checks.items():
        log(f"[rest] check {'ok' if ok else 'FAILED'}: {name}")
    phase_s = time.monotonic() - t_phase
    log(f"[rest] phase 16 wall {phase_s:.1f} s")
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 16 checks failed: {failed}")
    return {"sdk": {k: v for k, v in sdk_part.items() if k != "checks"},
            "fleet": {k: v for k, v in fleet_part.items()
                      if k not in ("checks", "cli")},
            "ntsc": ntsc_part["seconds"], "phase_s": phase_s,
            "checks": checks}


class _Tok:
    """A /v1/generate reply as check_greedy reads a result."""

    def __init__(self, out):
        self.tokens, self.request_id = out["tokens"], out["request_id"]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


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
    t_script = time.monotonic()
    master_build = None if quick else _MasterBuild()
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
    cfg = gpt.GPTConfig()
    params = gpt.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    report["serving"] = phase_serving(params, cfg)
    report["fleet"] = phase_fleet(params, cfg)
    del params
    report["parallel"] = phase_parallel(report["trial"]["legs"]["leg1"])
    report["second_half"] = phase_second_half(report["train"])
    report["telemetry"] = phase_telemetry(report["trial"]["legs"])
    report["search"] = phase_search()
    cluster: dict = {}
    try:
        report["managed"] = phase_managed(master_build, report["search"],
                                          cluster)
        report["rest"] = phase_rest(cluster)
    finally:
        close_cluster(cluster)

    smi = card_line()
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
        "serving_launches": report["serving"]["flash_launches"],
        "fleet_launches": report["fleet"]["flash_launches"],
        "parallel_launches": report["parallel"]["launches"],
        "pipeline_launches": report["second_half"]["launches"],
        "telemetry_launches": report["telemetry"]["launches"],
        "search_launches": report["search"]["launches"],
        "managed_launches": report["managed"]["launches"],
        "sdk_launches": report["rest"]["sdk"]["launches"],
        "fleet_master_launches": report["rest"]["fleet"]["launches"],
        **kernel_entry(cases["gpt_width_bf16_causal"]),
        "fp32": kernel_entry(cases["gpt_width_fp32_causal"])}]
    report["card"] = smi
    report["wall_s"] = time.monotonic() - t_script
    log(f"[env] whole script {report['wall_s']:.1f} s")
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
