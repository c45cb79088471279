"""Whole runs of each cell on the CPU at a tiny size, the card's look
skipped: the result line's shape, the checks passing on a sound program,
and failing when the timed path is broken underneath (a state left
unchanged, half of the batch left out, a served token altered) or when
the control (the reference in float8) stands in the program's place."""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import run as brun
from benchmark import spec
from benchmark.drivers import engine_open_loop, trainer_fit
from benchmark.generators.lm_train_stream import LmTrainStream
from benchmark.reference import gpt as ref_gpt
from benchmark.tests.conftest import REPO, _edit

TRAIN, SERVE = "train-gpt2xl-t1024", "serve-gpt2xl-chat"
SEED = 2 ** 31 + 17


def _execute(root, workload, trace=False, seconds=1.5, seed=SEED):
    run = brun.Run(root=root, bench=spec.load_bench(root),
                   workload=workload, seed=seed, seconds=seconds,
                   trace=trace, device=torch.device("cpu"))
    return run, brun.execute(run)


@pytest.mark.parametrize("workload", [TRAIN, SERVE])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_prints_the_contract_line(tiny_root, workload, trace):
    run, line = _execute(tiny_root, workload, trace)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    bench = spec.load_bench(tiny_root)
    want = spec.per_layer(bench, workload) if trace else \
        spec.end_to_end(bench, workload)
    names = {m["name"] for m in want}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(v["value"] > 0 for v in line["metrics"].values())
    dev = line["device"]
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    json.dumps(line, allow_nan=False)
    assert brun.loaded_banned() == []


def _unchanged_update(self, grads, state, params):
    from determined_clone_tpu_torch.training import optim

    p = optim.leaves(params)
    with torch.no_grad():
        _, state = self.transform(list(optim.leaves(grads)), state, p)
    return state


def test_a_step_that_leaves_the_state_unchanged_fails(tiny_root,
                                                      monkeypatch):
    from determined_clone_tpu_torch.training import optim

    monkeypatch.setattr(optim.Optimizer, "update", _unchanged_update)
    _, line = _execute(tiny_root, TRAIN)
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_fails(tiny_root, monkeypatch):
    from determined_clone_tpu_torch.models import gpt

    whole = gpt.loss_fn

    def half(params, cfg, tokens, targets, *a, **kw):
        n = tokens.shape[0] // 2
        return whole(params, cfg, tokens[:n], targets[:n], *a, **kw)

    monkeypatch.setattr(gpt, "loss_fn", half)
    _, line = _execute(tiny_root, TRAIN)
    assert line["correct"] is False, line["checks"]


def test_a_served_token_altered_fails(tiny_root, monkeypatch):
    from determined_clone_tpu_torch.models import gpt

    whole = gpt.forward_paged

    def altered(*args):
        logits, k, v = whole(*args)
        logits = logits.clone()
        top = logits.argmax(-1)
        logits[0, (top[0] + 1) % logits.shape[-1]] = logits[0].max() + 1.0
        return logits, k, v

    monkeypatch.setattr(gpt, "forward_paged", altered)
    _, line = _execute(tiny_root, SERVE)
    assert line["correct"] is False, line["checks"]


def _control_run(root, workload, n_layers):
    """The cell at a size where the float8 dataflow's drift shows: width
    256 (heads of 64), ``n_layers`` deep, sequences of 64."""
    cfg = root / "benchmark" / "configs" / "gpt2-xl.json"
    _edit(cfg, n_layers=n_layers, d_model=256, n_heads=4, head_dim=64,
          d_ff=1024, vocab_size=2048, token_vocab=2000)
    _edit(root / "benchmark" / "traffic" / "lm_b8_t1024.json", seq_len=64)
    return brun.Run(root=root, bench=spec.load_bench(root),
                    workload=workload, seed=SEED, seconds=1.0, trace=False,
                    device=torch.device("cpu"))


def test_the_control_fails_the_training_checks(tiny_root):
    run = _control_run(tiny_root, TRAIN, 12)
    stream = LmTrainStream(run.mix, run.cfg, SEED)
    ref = trainer_fit.reference(run, stream, 3)
    control = trainer_fit.gaps(
        trainer_fit.reference(run, stream, 3, precision="fp8"), ref)
    limits = spec.limits(TRAIN, REPO)
    assert any(control[k] > limits[k] for k in limits), control


def test_the_control_fails_the_serving_checks(tiny_root):
    run = _control_run(tiny_root, SERVE, 24)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 2000, 40).tolist(),
             rng.integers(0, 2000, 16).tolist()) for _ in range(3)]
    control = engine_open_loop.gap_readings(ref_gpt.served_gaps(
        run.cfg, SEED, reqs, run.device, control=True))
    limits = spec.limits(SERVE, REPO)
    assert any(control[k] > limits[k] for k in limits), control


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", TRAIN,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [TRAIN, SERVE])
def test_a_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", str(SEED), "--seconds", "10", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
