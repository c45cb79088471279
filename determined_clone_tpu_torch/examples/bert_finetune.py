"""BERT fine-tune driven directly through the Core API — the port of
``examples/bert_finetune/train_bert.py`` (BASELINE config #4): a function
entrypoint ``main(core_context, info)`` that owns its loop and talks to
the platform through the Core API's searcher operations, metric reports,
checkpoints and preemption polling.

The task is sequence classification with the BERT encoder
(``models/bert.py``, [CLS] pooler and head) on the JAX script's
synthetic "sentiment" data: the label is whether positive-band marker
tokens outnumber negative-band ones.

Where the JAX script computes in bf16 on a TPU and fp32 elsewhere, the
port computes in bf16 on ``cuda`` and fp32 on the CPU. The checkpoint is
the JAX script's: ``state.pkl``, a pickle of the params as a dict of
numpy fp32 arrays (never torch tensors), with ``steps_completed`` in the
metadata and no optimizer state — so either package resumes the other's.
"""
from __future__ import annotations

import json
import os
import pickle
import tempfile

import numpy as np
import torch

from determined_clone_tpu_torch import convert
from determined_clone_tpu_torch.device import DeviceLike, resolve_device
from determined_clone_tpu_torch.models import bert
from determined_clone_tpu_torch.ops.layers import accuracy
from determined_clone_tpu_torch.training import optim
from determined_clone_tpu_torch.training.train_step import (
    create_train_state,
    make_train_step,
)


def _synthetic_reviews(n, vocab_size, seq_len, seed=0):
    """Label = whether tokens from the 'positive' band [10, 20) outnumber
    the 'negative' band [20, 30) in the sequence."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(30, vocab_size, size=(n, seq_len)).astype(np.int32)
    n_markers = rng.randint(1, max(2, seq_len // 4), size=n)
    for i in range(n):
        pos = rng.choice(seq_len, size=n_markers[i], replace=False)
        polarity = rng.randint(0, 2)
        band = 10 if polarity else 20
        tokens[i, pos] = band + rng.randint(0, 10, size=n_markers[i])
    labels = ((tokens >= 10) & (tokens < 20)).sum(1) > (
        (tokens >= 20) & (tokens < 30)).sum(1)
    return tokens, labels.astype(np.int32)


def config_from_hparams(hp, device: DeviceLike = "cuda") -> bert.BertConfig:
    """The script's ``BertConfig``: bf16 compute on ``cuda``, fp32 on the
    CPU."""
    dev = resolve_device(device)
    return bert.BertConfig(
        vocab_size=int(hp.get("vocab_size", 1000)),
        n_layers=int(hp.get("n_layers", 4)),
        d_model=int(hp.get("d_model", 128)),
        n_heads=int(hp.get("n_heads", 4)),
        d_ff=int(hp.get("d_ff", 256)),
        max_seq_len=int(hp.get("seq_len", 64)),
        n_classes=2,
        compute_dtype=(torch.bfloat16 if dev.type == "cuda"
                       else torch.float32),
        remat=bool(hp.get("remat", False)),
    )


def main(core_context, info, device: DeviceLike = "cuda"):
    """Train to each searcher operation's length, reporting the training
    loss every 10 batches and the validation accuracy at each op's end;
    on preemption, save and return ``{"state": "preempted", ...}``."""
    dev = resolve_device(device)
    hp = info.hparams
    cfg = config_from_hparams(hp, dev)
    seq_len = int(hp.get("seq_len", 64))
    batch_size = int(hp.get("global_batch_size", 32))
    lr = float(hp.get("lr", 1e-4))

    tx = optim.adamw(lr, weight_decay=0.01)
    batches_done = 0
    if info.latest_checkpoint:
        # resume a preempted or restarted leg from the latest checkpoint
        with core_context.checkpoint.restore_path(info.latest_checkpoint) as d:
            with open(os.path.join(d, "state.pkl"), "rb") as f:
                params = convert.params_from_numpy(pickle.load(f), dev)
            mpath = os.path.join(d, "metadata.json")
            if os.path.exists(mpath):
                with open(mpath) as f:
                    batches_done = int(json.load(f).get("steps_completed", 0))
    else:
        params = bert.init(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    state = create_train_state(params, tx, seed=1)

    def loss_fn(p, batch, seed):
        tokens, labels = batch
        return bert.classify_loss(p, cfg, tokens, labels), {}

    step = make_train_step(loss_fn, tx)

    train_x, train_y = _synthetic_reviews(4096, cfg.vocab_size, seq_len)
    val_x, val_y = _synthetic_reviews(512, cfg.vocab_size, seq_len, seed=1)
    val_x = torch.from_numpy(val_x).to(dev)
    val_y = torch.from_numpy(val_y).to(dev)

    def eval_acc(p):
        with torch.no_grad():
            return float(accuracy(bert.classify(p, cfg, val_x), val_y))

    last_loss = None
    # the searcher hands out work in max_length units; completing each op
    # with the searcher metric is what drives HP-search schedulers
    for op in core_context.searcher.operations():
        # managed runs hand out config.Length targets; local sources ints
        target = int(getattr(op.length, "value", op.length))
        while batches_done < target:
            i = (batches_done * batch_size) % (len(train_x) - batch_size + 1)
            batch = (torch.from_numpy(train_x[i:i + batch_size]).to(dev),
                     torch.from_numpy(train_y[i:i + batch_size]).to(dev))
            state, metrics = step(state, batch)
            last_loss = float(metrics["loss"])
            batches_done += 1
            if batches_done % 10 == 0:
                core_context.train.report_training_metrics(
                    batches_done, {"loss": last_loss})
                op.report_progress(batches_done)
            if core_context.preempt.should_preempt():
                _save(core_context, state, batches_done)
                return {"state": "preempted", "batches": batches_done}
        acc = eval_acc(state.params)
        val_metrics = {"accuracy": acc}
        if last_loss is not None:  # an op can already be satisfied on resume
            val_metrics["loss"] = last_loss
        core_context.train.report_validation_metrics(batches_done, val_metrics)
        op.complete(acc)
    _save(core_context, state, batches_done)
    return {"state": "completed", "batches": batches_done}


def _save(core_context, state, batches_done):
    params = optim.tree_map(lambda t: t.detach().cpu().numpy(), state.params)
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "state.pkl"), "wb") as f:
            pickle.dump(params, f)
        core_context.checkpoint.upload(
            d, metadata={"steps_completed": batches_done})
